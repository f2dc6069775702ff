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
// - The step is under half a voxel, so consecutive samples of a ray mostly
//   share their cell, or 4 of its corners after crossing one face. The ray
//   carries the pending sums of its current cell's 8 corners (16 with
//   absorption) in registers (CornerCarry), the adjoint of the fetch's
//   clamp and shift included: a sample in the same cell adds
//   into them, a sample that crosses a face keeps the corners both cells
//   share and flushes the rest, and the ray flushes all when it ends. A
//   flush is one atomicAdd without a return value (red.global.add.f32),
//   skipped for a sum that is still zero. This is the exact adjoint of the
//   same fetches; only the order of the float additions changes, and atomic
//   adds land in no fixed order anyway, so the grids differ from run to run
//   in the last bits.
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

// The 8 trilinear weights of cell k by slot a + 2 b + 4 c (corner
// (x + a, y + b, z + c)): the x weight times the y weight times the z weight.
__device__ __forceinline__ void corner_weights(const Cell& k, float (&w)[8]) {
  const float fx = k.fx, fy = k.fy, fz = k.fz;
  const float gx0 = 1.0f - fx, gy0 = 1.0f - fy, gz0 = 1.0f - fz;
  w[0] = gx0 * gy0 * gz0;
  w[1] = fx * gy0 * gz0;
  w[2] = gx0 * fy * gz0;
  w[3] = fx * fy * gz0;
  w[4] = gx0 * gy0 * fz;
  w[5] = fx * gy0 * fz;
  w[6] = gx0 * fy * fz;
  w[7] = fx * fy * fz;
}

// The pending corner sums of one ray's current cell in N grids of one shape
// and place: s[n][a + 2 b + 4 c] is what the ray's samples in this cell, and
// in earlier cells sharing the corner, added to corner (x + a, y + b, z + c)
// of grid n. Every index into s is a constant after unrolling, so the sums
// stay in registers.
template <int N>
struct CornerCarry {
  float* grid[N];
  Vol v;
  ZSlab zs;
  int x, y, z;  // the cell; far from any real one until the first sample
  float s[N][8];

  // g1: the second grid, with N = 2
  __device__ __forceinline__ CornerCarry(const Vol& vol, ZSlab slab, float* g0, float* g1)
      : v(vol), zs(slab), x(-(1 << 29)), y(-(1 << 29)), z(-(1 << 29)) {
    grid[0] = g0;
    if constexpr (N == 2) grid[1] = g1;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int k = 0; k < 8; ++k) s[n][k] = 0.0f;
    }
  }

  // Adds slot k into the grids, clamped and shifted as the fetch clamps and
  // shifts its corner, and clears it.
  __device__ __forceinline__ void flush(int k) {
    const size_t off = (size_t)clamp_index(x + (k & 1), v.w) +
                       (size_t)clamp_index(y + ((k >> 1) & 1), v.h) * (size_t)v.w +
                       (size_t)slab_row(z + (k >> 2), v, zs) * ((size_t)v.w * (size_t)v.h);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (s[n][k] != 0.0f) atomicAdd(grid[n] + off, s[n][k]);
      s[n][k] = 0.0f;
    }
  }

  __device__ __forceinline__ void flush_all() {
#pragma unroll
    for (int k = 0; k < 8; ++k) flush(k);
  }

  // One step of d (-1, 0 or 1) along the axis of slot bit `bit`: the 4
  // corners left behind are flushed, the 4 kept move to the other side.
  __device__ __forceinline__ void shift(int bit, int d) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k & bit) continue;
      const int lo = k, hi = k | bit;
      if (d > 0) {
        flush(lo);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s[n][lo] = s[n][hi];
          s[n][hi] = 0.0f;
        }
      } else if (d < 0) {
        flush(hi);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s[n][hi] = s[n][lo];
          s[n][lo] = 0.0f;
        }
      }
    }
  }

  // Makes cell c the current one, flushing the corners it does not share.
  __device__ __forceinline__ void move_to(const Cell& c) {
    const int dx = c.x - x, dy = c.y - y, dz = c.z - z;
    if (dx == 0 && dy == 0 && dz == 0) return;
    if (abs(dx) > 1 || abs(dy) > 1 || abs(dz) > 1) {
      flush_all();
    } else {  // axis by axis: each flush addresses the cell as moved so far
      shift(1, dx);
      x = c.x;
      shift(2, dy);
      y = c.y;
      shift(4, dz);
    }
    x = c.x;
    y = c.y;
    z = c.z;
  }

  // d0 into grid 0 and, with N = 2, d1 into grid 1, spread by the weights w
  __device__ __forceinline__ void add(const float (&w)[8], float d0, float d1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[0][k] = s[0][k] + w[k] * d0;
      if constexpr (N == 2) s[1][k] = s[1][k] + w[k] * d1;
    }
  }
};

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
