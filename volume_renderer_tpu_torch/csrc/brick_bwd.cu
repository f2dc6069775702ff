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
// sees the whole ray. The step's adjoint is that of march_bwd.cu:
//   brick_bwd_kernel      unlit (K3's step): cotangents go to the taps,
//                         which are added into the brick's halo-padded
//                         gradient grids with the trilinear weights of the
//                         fetch, and to the transfer parameters as per-ray
//                         planes that the wrapper sums:
//     plane 0  E = sum T alpha em          -> factor_emission, color
//     plane 1  F = sum d absorption * ab   -> factor_absorption
//   brick_lit_bwd_kernel  lit with on-the-fly gradients (K6's step, the one
//                         lit_replay_sample of lit_replay.cuh over the
//                         brick's windows): also the reflection grid, and
//     plane 2      rac = sum d reflection * re   -> factor_reflection
//     plane 3+3l+c P   = the light sums          -> light_colors, color
//   brick_lookup_bwd_kernel  lit with lookup gradient volumes (K6L's step
//                         over the brick's windows; unpacked:
//                         brick_lookup_unpacked_bwd_kernel): also the three
//                         gradient volumes' grids, the same planes
// Halo rows of the padded grids collect what belongs to the neighbouring
// bricks; parallel/bricks.py folds them back, and the slab sweep adds a
// window's rows into the whole grid (ops/cuda_slab.py). The TPU mode has no
// lit form; the JAX package differentiates a lit brick in XLA, and a lit
// lookup scene's gradients anywhere in XLA (pallas_march.py:2066-2068).
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
// - Lit, the sample's replay and scatter are K6's (the shared window of the
//   centre and the six taps, 20 atomic adds for the emission where the taps
//   lie half a voxel out), with every row placed in the brick's window:
//   clamped at the whole volume's faces, then shifted, so the taps, two rows
//   beyond an owned sample at most, read and scatter the rows the halo holds.
//   Its registers are capped as K6's are (kLitMaxRegisters), 16x8 blocks,
//   the light sums in shared memory a column a thread. It scatters
//   absorption and reflection at their own corners, 36 atomic adds a sample
//   with the tap window's 20. Carrying those two grids' corner sums on the
//   centre's cell, as the unlit form carries its grids, cut that to 22.6
//   (chip_smoke.py, lit_corner_flushes) and was measured on an H100 and
//   dropped (PERF.md): with the 16 sums in shared memory, a column a
//   thread, the segment ran 10 % slower; in registers, at the 168 cap or
//   without it, 4 % slower. Its time is the replay's arithmetic, not its
//   atomic adds.
// - Lit with lookup gradient volumes, the sample's replay and scatter are
//   K6L's, on the brick's windows, the gradient volumes' windows placed as
//   emission's: where the four windows have one shape the kernel reads lit
//   phase 2's packed window (ops/cuda_bricks.py, pack_window; PACKED) and
//   adds the four cotangents of a corner as one float4 reduction into an
//   accumulator of the packed window's shape, and, where absorption's and
//   reflection's windows have emission's shape and place (PAIRED), their two
//   as one float2 reduction into a (D_win, H, W, 2) one (scatter_packed),
//   which the wrapper unpacks into the padded grids: 16 reductions a
//   sample where the scalar scatter issued 48, which had made the segment
//   32.4 ms over 4 bricks at 256^3 / 512^2 on an H100, more than the lit
//   segment's 30.9; 18.7-18.9 ms in turns with it (PERF.md). Otherwise
//   each window at its own corners, scalar. Same cap and blocks (the
//   unpacked form a higher cap, kUnpackedMaxRegisters, which it needs not
//   to spill).
//
// Build flags as for march_fwd.cu (-fmad=false, no fast math). Plain C
// interface, loaded with ctypes (ops/cuda_bricks.py).

#include "brick_common.cuh"
#include "lit_replay.cuh"

// Mirrored field for field by _BrickGradArgs in ops/cuda_bricks.py.
struct BrickGradArgs {
  BrickArgs b;          // m.out, m.steps and w_out are unused; the entry record is read
  const float* g;       // (height, width, 3) pixel cotangent
  const float* image;   // (height, width, 3) the GLOBAL image
  const float* up_dot;  // (height, width) g . contribution of the bricks in front
  float* d_em;          // zero-initialised padded gradient grids;
  float* d_ab;          // null when absorption is aliased to emission,
  float* d_re;          // reflection aliased or the scene unlit
  float* d_gx;          // the gradient volumes' padded grids: lookup unpacked
  float* d_gy;          // only, else null
  float* d_gz;
  float4* d_pack;       // lookup from the packed window: the zeroed accumulator of
                        // emission's and the gradient windows' cotangents, the packed
                        // window's shape, 16-byte aligned (d_em, d_gx, d_gy, d_gz null)
  float2* d_pair;       // with d_pack, absorption and reflection windows of emission's
                        // shape and place, neither aliased: the zeroed (D_win, H, W, 2)
                        // accumulator of their cotangents, 8-byte aligned (d_ab, d_re
                        // null); else null
  float* planes;        // (2, height, width); lit (3 + 3 n_lights, height, width)
};

namespace {

constexpr int kScatterCols = kBlock, kScatterRows = 8;
constexpr int kScatterThreads = kScatterCols * kScatterRows;

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
    march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, V3, float& w) {
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

// The lit gradient segment of one ray: the brick's own samples replayed with
// K6's sample replay (lit_replay_sample), or with LOOKUP K6L's (PAIRED as
// K6L's), over its windows.
template <bool LOOKUP, bool PACKED, bool AB_ALIASED, bool RE_ALIASED, bool PAIRED = false>
__device__ __forceinline__ void brick_lit_bwd_ray(const BrickGradArgs& ga) {
  constexpr int kT = kScatterThreads;
  extern __shared__ float light_sums[];  // [3 n_lights][kT], a column per thread
  const BrickArgs& a = ga.b;
  const MarchArgs& m = a.m;
  const int px = blockIdx.x * kScatterCols + threadIdx.x;
  const int py = blockIdx.y * kScatterRows + threadIdx.y;
  if (px >= m.width || py >= m.height) return;
  const int tid = threadIdx.y * kScatterCols + threadIdx.x;
  const int n_lights = m.n_lights;
  float* sums = light_sums + tid;
  for (int k = 0; k < 3 * n_lights; ++k) sums[k * kT] = 0.0f;

  const float threshold = __ldg(m.settings + 6);
  const size_t pix = (size_t)py * m.width + px;
  LitRay r = {};
  r.g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};
  float sw = __ldg(a.w_in + pix);
  const Entry e = load_entry(a, pix);
  if (!(r.g.x == 0.0f && r.g.y == 0.0f && r.g.z == 0.0f) && enters(e, sw, threshold)) {
    const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                    __ldg(ga.image + 3 * pix + 2)};
    r.total_dot = dot(r.g, out);
    r.prefix = __ldg(ga.up_dot + pix);
    V3 step;
    float tfar;
    ray_step(m, px, py, step, tfar, r.origin);
    const LitConsts c = lit_consts(m, true);  // the fast entry points' angle adjoint
    const LitGrids d = {ga.d_em, ga.d_ab, ga.d_re,   ga.d_gx,
                        ga.d_gy, ga.d_gz, ga.d_pack, ga.d_pair};
    const LitPlaces<ZSlab> z = {{a.em_d_global, a.em_z_off}, {a.ab_d_global, a.ab_z_off},
                                {a.re_d_global, a.re_z_off}, {a.gx_d_global, a.gx_z_off},
                                {a.gy_d_global, a.gy_z_off}, {a.gz_d_global, a.gz_z_off}};
    march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, V3 p, float& w) {
      lit_replay_sample<true, LOOKUP, PACKED, AB_ALIASED, RE_ALIASED, PAIRED>(m, c, d, z, p, s,
                                                                              w, r, sums, kT);
    });
  }

  const size_t plane = (size_t)m.width * m.height;
  ga.planes[pix] = r.acc_e;
  ga.planes[plane + pix] = r.acc_f;
  ga.planes[2 * plane + pix] = r.acc_rac;
  for (int k = 0; k < 3 * n_lights; ++k) ga.planes[(3 + k) * plane + pix] = sums[k * kT];
}

// The lit gradient segment (on-the-fly gradients).
template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kLitMaxRegisters) brick_lit_bwd_kernel(const BrickGradArgs ga) {
  brick_lit_bwd_ray<false, false, AB_ALIASED, RE_ALIASED>(ga);
}

// The lit gradient segment with lookup gradient volumes, from lit phase 2's
// packed window; PAIRED as K6L's.
template <bool AB_ALIASED, bool RE_ALIASED, bool PAIRED>
__global__ void __maxnreg__(kLitMaxRegisters) brick_lookup_bwd_kernel(const BrickGradArgs ga) {
  brick_lit_bwd_ray<true, true, AB_ALIASED, RE_ALIASED, PAIRED>(ga);
}

// The same with gradient windows of another shape than emission's, each
// fetched at its own corners: under the cap ptxas spilled 12 bytes in one
// of them, so they get K2L's and K6L's unpacked cap (lit_replay.cuh; two
// 16x8 blocks an SM, where the packed form fits three).

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kUnpackedMaxRegisters)
    brick_lookup_unpacked_bwd_kernel(const BrickGradArgs ga) {
  brick_lit_bwd_ray<true, false, AB_ALIASED, RE_ALIASED>(ga);
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

template <bool LOOKUP, bool PACKED, bool AB, bool RE>
cudaError_t launch_lit(const BrickGradArgs& ga, cudaStream_t stream) {
  const MarchArgs& m = ga.b.m;
  const dim3 block(kScatterCols, kScatterRows);
  const dim3 grid((m.width + kScatterCols - 1) / kScatterCols,
                  (m.height + kScatterRows - 1) / kScatterRows);
  const size_t shared = sizeof(float) * 3 * m.n_lights * kScatterThreads;
  if constexpr (LOOKUP && PACKED && !AB && !RE) {
    if (ga.d_pair != nullptr) {
      brick_lookup_bwd_kernel<false, false, true><<<grid, block, shared, stream>>>(ga);
    } else {
      brick_lookup_bwd_kernel<false, false, false><<<grid, block, shared, stream>>>(ga);
    }
  } else if constexpr (LOOKUP && PACKED) {
    brick_lookup_bwd_kernel<AB, RE, false><<<grid, block, shared, stream>>>(ga);
  } else if constexpr (LOOKUP) {
    brick_lookup_unpacked_bwd_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  } else {
    brick_lit_bwd_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  }
  return cudaGetLastError();
}

template <bool LOOKUP, bool PACKED = false>
cudaError_t launch_lit_aliasing(const BrickGradArgs& ga, bool ab_aliased, bool re_aliased,
                                cudaStream_t stream) {
  if (ab_aliased) {
    return re_aliased ? launch_lit<LOOKUP, PACKED, true, true>(ga, stream)
                      : launch_lit<LOOKUP, PACKED, true, false>(ga, stream);
  }
  return re_aliased ? launch_lit<LOOKUP, PACKED, false, true>(ga, stream)
                    : launch_lit<LOOKUP, PACKED, false, false>(ga, stream);
}

}  // namespace

extern "C" {

// Size of BrickGradArgs, so that the Python side can check its mirror.
size_t vr_brick_grad_args_size() { return sizeof(BrickGradArgs); }

// The most lights the lit gradient segment takes: their per-thread sums must
// fit the 48 KB of shared memory a block gets without opting in to more.
int vr_brick_bwd_max_lights() {
  return (48 * 1024) / (int)(sizeof(float) * 3 * kScatterThreads);
}

// Launches the gradient segment on ``stream``; returns the launch's
// cudaError_t. lit: the lit form (planes 3 + 3 n_lights, d_re unless
// re_aliased), from the emission taps or, with lookup, from the gradient
// windows (d_gx, d_gy, d_gz; from args->b.m.packed where the host packed
// emission and the gradient windows, the packed grid emission's shape by 4,
// and then into d_pack, of the packed grid's shape, instead).
int vr_brick_bwd(const BrickGradArgs* args, int ab_aliased, int lit, int lookup,
                 int re_aliased, void* stream) {
  const BrickGradArgs& ga = *args;
  const BrickArgs& a = ga.b;
  if (a.m.width <= 0 || a.m.height <= 0) return (int)cudaSuccess;
  if (a.n_bricks < 1 || a.brick < 0 || a.brick >= a.n_bricks) return (int)cudaErrorInvalidValue;
  if (a.entry_step == nullptr || a.entry_state == nullptr || a.w_in == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the accumulators are the lookup segment's alone, from the packed window
  if (!(lit && lookup && a.m.packed.data != nullptr) &&
      (ga.d_pack != nullptr || ga.d_pair != nullptr))
    return (int)cudaErrorInvalidValue;
  if (lit) {
    if (a.m.n_lights > vr_brick_bwd_max_lights() || a.m.lut.data == nullptr ||
        (!re_aliased && (a.m.re.data == nullptr || (ga.d_re == nullptr && ga.d_pair == nullptr))))
      return (int)cudaErrorInvalidValue;
    if (!lookup) return (int)launch_lit_aliasing<false>(ga, ab_aliased, re_aliased, s);
    const MarchArgs& m = a.m;
    if (m.gx.data == nullptr || m.gy.data == nullptr || m.gz.data == nullptr)
      return (int)cudaErrorInvalidValue;
    const Vol4& pk = m.packed;
    if (pk.data == nullptr) {
      if (ga.d_em == nullptr || ga.d_gx == nullptr || ga.d_gy == nullptr || ga.d_gz == nullptr)
        return (int)cudaErrorInvalidValue;
      return (int)launch_lit_aliasing<true>(ga, ab_aliased, re_aliased, s);
    }
    // the pair: absorption and reflection separate, of emission's shape and place
    if (ga.d_pair != nullptr &&
        (ab_aliased || re_aliased || reinterpret_cast<size_t>(ga.d_pair) % 8 != 0 ||
         !same_place(m.ab, a.ab_z_off, a.ab_d_global, a) ||
         !same_place(m.re, a.re_z_off, a.re_d_global, a)))
      return (int)cudaErrorInvalidValue;
    if (ga.d_pack == nullptr || reinterpret_cast<size_t>(ga.d_pack) % 16 != 0 ||
        pk.d != m.em.d || pk.h != m.em.h || pk.w != m.em.w ||
        !same_place(m.gx, a.gx_z_off, a.gx_d_global, a) ||
        !same_place(m.gy, a.gy_z_off, a.gy_d_global, a) ||
        !same_place(m.gz, a.gz_z_off, a.gz_d_global, a))
      return (int)cudaErrorInvalidValue;
    return (int)launch_lit_aliasing<true, true>(ga, ab_aliased, re_aliased, s);
  }
  if (ab_aliased) return (int)launch<true, false>(ga, s);
  // absorption shares emission's corners where it has its shape and place
  const bool same = same_place(a.m.ab, a.ab_z_off, a.ab_d_global, a);
  return (int)(same ? launch<false, false>(ga, s) : launch<false, true>(ga, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
