// brick_bwd.cu: the gradient segment of one z-brick for Hopper (sm_90a).
//
// Replaces the gradient form of the brick mode (K7, brick + scatter) of the
// TPU kernel volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688;
// the seeded prefix at :1519-1522), launched by the pl.pallas_call at :1935
// through _launch(grad_inputs=..., scatter=True, brick=...) (:1594) from
// parallel/bricks.py:590. It computes what ops/brick_march.py:replay_pass
// (the plain PyTorch version) defines: the brick's own samples are replayed
// as brick_fwd.cu marched them, the opacity seeded with the entry opacity
// and prefix = sum T (g . s) seeded with the dots of the bricks in front,
// so that
//   d alpha = -(g . out_global - prefix) / (1 - alpha)
// sees the whole ray. The step's adjoint is that of march_bwd.cu, unlit:
// cotangents go to the taps, which are added into the brick's halo-padded
// gradient grids with the trilinear weights of the fetch, and to the
// transfer parameters as per-ray planes that the wrapper sums:
//   plane 0  E = sum T alpha em          -> factor_emission, color
//   plane 1  F = sum d absorption * ab   -> factor_absorption
// Halo rows of the padded grids collect what belongs to the neighbouring
// bricks; parallel/bricks.py folds them back.
//
// What bounds it on this card, and what the design does about it: as
// march_bwd.cu (gathers and 8 or 16 atomic adds a sample, a thread per ray
// in 16x16 blocks, atomicAdd without a return value), plus the walk to the
// brick described in brick_fwd.cu. A ray whose cotangent is zero is
// skipped. Atomic adds land in no fixed order, so the grids differ from
// run to run in the last bits.
//
// Build flags as for march_fwd.cu (-fmad=false, no fast math). Plain C
// interface, loaded with ctypes (ops/cuda_bricks.py).

#include "brick_common.cuh"

// Mirrored field for field by _BrickGradArgs in ops/cuda_bricks.py.
struct BrickGradArgs {
  BrickArgs b;          // m.out, m.steps and w_out are unused
  const float* g;       // (height, width, 3) pixel cotangent
  const float* image;   // (height, width, 3) the GLOBAL image
  const float* up_dot;  // (height, width) g . contribution of the bricks in front
  float* d_em;          // zero-initialised padded gradient grids;
  float* d_ab;          // null when absorption is aliased to emission
  float* planes;        // (2, height, width)
};

namespace {

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// Adjoint of sample_slab(): adds d times the 8 trilinear weights at the 8
// corners, clamped and shifted as the fetch clamps and shifts them.
__device__ __forceinline__ void scatter_slab(float* grid, const Vol& v, ZSlab z, V3 c, float d) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = corner(c.x, v.w, x0, x1);
  const float fy = corner(c.y, v.h, y0, y1);
  const float fz = corner_z(c.z, v, z, z0, z1);
  const size_t sy = (size_t)v.w;
  const size_t sz = (size_t)v.w * (size_t)v.h;
  const float gx0 = 1.0f - fx, gy0 = 1.0f - fy, gz0 = 1.0f - fz;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  atomicAdd(grid + x0 + r00, gx0 * gy0 * gz0 * d);
  atomicAdd(grid + x1 + r00, fx * gy0 * gz0 * d);
  atomicAdd(grid + x0 + r10, gx0 * fy * gz0 * d);
  atomicAdd(grid + x1 + r10, fx * fy * gz0 * d);
  atomicAdd(grid + x0 + r01, gx0 * gy0 * fz * d);
  atomicAdd(grid + x1 + r01, fx * gy0 * fz * d);
  atomicAdd(grid + x0 + r11, gx0 * fy * fz * d);
  atomicAdd(grid + x1 + r11, fx * fy * fz * d);
}

template <bool AB_ALIASED>
__global__ void __launch_bounds__(kBlock * kBlock) brick_bwd_kernel(const BrickGradArgs ga) {
  const BrickArgs& a = ga.b;
  const MarchArgs& m = a.m;
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kBlock + threadIdx.y;
  if (px >= m.width || py >= m.height) return;

  const float* st = m.settings;
  const float fe = __ldg(st + 0), fa = __ldg(st + 1);
  const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
  const float threshold = __ldg(st + 6);
  const float tstep = m.tstep;
  const ZSlab em_slab = {a.em_d_global, a.em_z_off};
  const ZSlab ab_slab = {a.ab_d_global, a.ab_z_off};

  const size_t pix = (size_t)py * m.width + px;
  const V3 g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};
  const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                  __ldg(ga.image + 3 * pix + 2)};
  const float total_dot = dot(g, out);

  float acc_e = 0.0f, acc_f = 0.0f;
  if (!(g.x == 0.0f && g.y == 0.0f && g.z == 0.0f)) {
    float sw = __ldg(a.w_in + pix);
    float prefix = __ldg(ga.up_dot + pix);
    walk_brick(a, px, py, threshold, sw, [&](V3 p, V3 s, float& w) {
      // ---- the sample's forward values, as brick_fwd.cu has them ----
      const float em = sample_slab(m.em, em_slab, s);
      const float ab = AB_ALIASED ? em : sample_slab(m.ab, ab_slab, s);
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float transmit = expf(-absorption * tstep);
      const float alpha = 1.0f - transmit;
      const V3 illum = {emission * tstep * color.x, emission * tstep * color.y,
                        emission * tstep * color.z};
      const float tw = 1.0f - w;
      const V3 d_s = scale(g, tw);
      const V3 d_illum = scale(d_s, alpha);

      // ---- cotangents of (s, alpha) from the under operator ----
      prefix = prefix + tw * (g.x * (illum.x * alpha) + g.y * (illum.y * alpha) +
                              g.z * (illum.z * alpha));
      const float one_m_a = 1.0f - alpha;
      const float d_alpha = one_m_a > 0.0f ? -(total_dot - prefix) / one_m_a : 0.0f;

      // ---- adjoint of the step ----
      const float d_absorption = (d_alpha + dot(d_s, illum)) * (transmit * tstep);
      acc_f = acc_f + d_absorption * ab;
      acc_e = acc_e + tw * alpha * em;
      float d_at_em = dot(d_illum, color) * tstep * fe;
      const float d_ab = d_absorption * fa;
      if (AB_ALIASED) {
        d_at_em = d_at_em + d_ab;
      } else {
        scatter_slab(ga.d_ab, m.ab, ab_slab, s, d_ab);
      }
      scatter_slab(ga.d_em, m.em, em_slab, s, d_at_em);

      w = tw * alpha + w;
    });
  }

  const size_t plane = (size_t)m.width * m.height;
  ga.planes[pix] = acc_e;
  ga.planes[plane + pix] = acc_f;
}

template <bool AB>
cudaError_t launch(const BrickGradArgs& ga, cudaStream_t stream) {
  const MarchArgs& m = ga.b.m;
  const dim3 block(kBlock, kBlock);
  const dim3 grid((m.width + kBlock - 1) / kBlock, (m.height + kBlock - 1) / kBlock);
  brick_bwd_kernel<AB><<<grid, block, 0, stream>>>(ga);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Size of BrickGradArgs, so that the Python side can check its mirror.
size_t vr_brick_grad_args_size() { return sizeof(BrickGradArgs); }

// Launches the gradient segment on ``stream``; returns the launch's
// cudaError_t.
int vr_brick_bwd(const BrickGradArgs* args, int ab_aliased, void* stream) {
  const BrickGradArgs& ga = *args;
  const BrickArgs& a = ga.b;
  if (a.m.width <= 0 || a.m.height <= 0) return (int)cudaSuccess;
  if (a.n_bricks < 1 || a.brick < 0 || a.brick >= a.n_bricks) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ab_aliased ? launch<true>(ga, s) : launch<false>(ga, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
