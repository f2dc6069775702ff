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
// What bounds it on this card: as march_bwd.cu, the gathers and the atomic
// adds into L2 (8 a sample and grid if each sample adds its shares alone).
//
// What the design does about it. A thread per ray, in 16x8 blocks (a warp
// is two rows of 16 neighbouring rays, as in K6; 16x16 blocks ran slower on
// an H100, PERF.md).
// - The ray resumes from the entry record that phase 1 stored
//   (brick_common.cuh) and never walks to its brick.
// - The corners and trilinear weights of a sample are computed once for
//   both grids when absorption has the emission's shape and place (checked
//   on the host below); an absorption of another shape keeps its own cell,
//   fetch and carry.
// - The ray carries the pending sums of its current cell's 8 corners (16
//   with absorption) in registers (CornerCarry of corner_carry.cuh, shared
//   with K3 in march_bwd.cu), the adjoint of the fetch's clamp and brick
//   shift included, and flushes a corner as one atomic add when it leaves
//   it: 2.08 atomic adds a sample for both grids instead of 16 (PERF.md).
//   The grids differ from run to run in the last bits.
// - A ray whose cotangent is zero, that has no record or that enters above
//   the opacity threshold writes zero planes at once.
//
// Build flags as for march_fwd.cu (-fmad=false, no fast math). Plain C
// interface, loaded with ctypes (ops/cuda_bricks.py).

#include "brick_common.cuh"

// Mirrored field for field by _BrickGradArgs in ops/cuda_bricks.py.
struct BrickGradArgs {
  BrickArgs b;          // m.out, m.steps and w_out are unused; the entry record is read
  const float* g;       // (height, width, 3) pixel cotangent
  const float* image;   // (height, width, 3) the GLOBAL image
  const float* up_dot;  // (height, width) g . contribution of the bricks in front
  float* d_em;          // zero-initialised padded gradient grids;
  float* d_ab;          // null when absorption is aliased to emission
  float* planes;        // (2, height, width)
};

namespace {

constexpr int kScatterCols = kBlock, kScatterRows = 8;
constexpr int kScatterThreads = kScatterCols * kScatterRows;

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// AB_OWN_CELL: absorption has another shape or place than emission, so it
// keeps its own cell and carry; otherwise it shares emission's.
template <bool AB_ALIASED, bool AB_OWN_CELL>
__global__ void __launch_bounds__(kScatterThreads) brick_bwd_kernel(const BrickGradArgs ga) {
  constexpr int kCarried = AB_ALIASED || AB_OWN_CELL ? 1 : 2;
  const BrickArgs& a = ga.b;
  const MarchArgs& m = a.m;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= m.width || py >= m.height) return;

  const float* st = m.settings;
  const float threshold = __ldg(st + 6);
  const size_t pix = (size_t)py * m.width + px;
  const V3 g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};
  float sw = __ldg(a.w_in + pix);
  const Entry e = load_entry(a, pix);

  float acc_e = 0.0f, acc_f = 0.0f;
  if (!(g.x == 0.0f && g.y == 0.0f && g.z == 0.0f) && enters(e, sw, threshold)) {
    const float fe = __ldg(st + 0), fa = __ldg(st + 1);
    const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
    const float tstep = m.tstep;
    const ZSlab em_slab = {a.em_d_global, a.em_z_off};
    const ZSlab ab_slab = {a.ab_d_global, a.ab_z_off};
    const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                    __ldg(ga.image + 3 * pix + 2)};
    const float total_dot = dot(g, out);
    float prefix = __ldg(ga.up_dot + pix);
    V3 step;
    float tfar;
    ray_step(m, px, py, step, tfar);
    CornerCarry<kCarried> carry(m.em, em_slab, ga.d_em, ga.d_ab);
    CornerCarry<1> ab_carry(m.ab, ab_slab, ga.d_ab, nullptr);  // with AB_OWN_CELL
    march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, float& w) {
      // ---- the sample's forward values, as brick_fwd.cu has them ----
      const Cell k = cell_of(m.em, em_slab, s);
      const Cell ka = AB_OWN_CELL ? cell_of(m.ab, ab_slab, s) : k;
      const float em = fetch_cell(m.em, em_slab, k);
      const float ab = AB_ALIASED ? em : fetch_cell(m.ab, ab_slab, ka);
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
      if (AB_ALIASED) d_at_em = d_at_em + d_ab;

      // ---- the shares of the cells' corners, carried ----
      float wk[8];
      carry.move_to(k);
      corner_weights(k, wk);
      carry.add(wk, d_at_em, d_ab);
      if (AB_OWN_CELL) {
        ab_carry.move_to(ka);
        corner_weights(ka, wk);
        ab_carry.add(wk, d_ab, 0.0f);
      }

      w = tw * alpha + w;
    });
    carry.flush_all();
    if (AB_OWN_CELL) ab_carry.flush_all();
  }

  const size_t plane = (size_t)m.width * m.height;
  ga.planes[pix] = acc_e;
  ga.planes[plane + pix] = acc_f;
}

template <bool AB, bool OWN>
cudaError_t launch(const BrickGradArgs& ga, cudaStream_t stream) {
  const MarchArgs& m = ga.b.m;
  const dim3 block(kScatterCols, kScatterRows);
  const dim3 grid((m.width + kScatterCols - 1) / kScatterCols,
                  (m.height + kScatterRows - 1) / kScatterRows);
  brick_bwd_kernel<AB, OWN><<<grid, block, 0, stream>>>(ga);
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
  if (a.entry_step == nullptr || a.entry_state == nullptr || a.w_in == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ab_aliased) return (int)launch<true, false>(ga, s);
  // absorption shares emission's corners where it has its shape and place
  const Vol &em = a.m.em, &ab = a.m.ab;
  const bool same = ab.d == em.d && ab.h == em.h && ab.w == em.w &&
                    a.ab_z_off == a.em_z_off && a.ab_d_global == a.em_d_global;
  return (int)(same ? launch<false, false>(ga, s) : launch<false, true>(ga, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
