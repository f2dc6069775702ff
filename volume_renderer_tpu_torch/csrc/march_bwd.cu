// march_bwd.cu: the backward ray march for Hopper (sm_90a).
//
// Replaces the gradient modes of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688), launched by
// the pl.pallas_call at :1935 through _replay_grads_tiled (:2020) and
// _voxel_grads_tiled (:2031):
//   K2  grad_mode            march_bwd_params_kernel (unlit),
//                            march_bwd_lit_params_kernel (lit)
//   K3  scatter              march_bwd_scatter_kernel (unlit)
//   K6  scatter + lighting   march_bwd_lit_scatter_kernel
//   K2L grad_mode, lit with lookup gradient volumes
//                            march_bwd_lookup_params_kernel (packed),
//                            march_bwd_lookup_unpacked_params_kernel
//   K6L scatter + lighting, lookup gradient volumes
//                            march_bwd_lookup_scatter_kernel (packed),
//                            march_bwd_lookup_unpacked_scatter_kernel
// The TPU kernel takes no lookup gradients when differentiating: the JAX
// package sends a lit lookup scene's gradients to its XLA replay
// (pallas_march.py:2066-2068, ops/vjp.py); K2L and K6L are the port's
// kernels for that replay.
// A launch replays a band of image rows (MarchArgs.row0, height), as
// march_fwd.cu marches one; under rays-DP the bands of one device scatter
// into one set of grids (parallel/pallas_dp.py).
// It computes what ops/vjp.py:replay_backward (the plain PyTorch version)
// defines: given the pixel cotangent g and the saved image, each ray is
// replayed front to back exactly as march_fwd.cu marched it (the shared
// device functions of march_common.cuh, the same guards, the same stop
// test), carrying the opacity and prefix = sum T (g . s). Per step
//   d s     = g T
//   d alpha = -(g . out - prefix) / (1 - alpha)      (0 where alpha = 1)
// go through the closed-form adjoint of the step: to the taps, which
// SCATTER adds into the gradient grids with the trilinear weights of the
// fetch, and to the transfer parameters, which leave the kernel as per-ray
// planes that the wrapper sums:
//   plane 0      E   = sum T alpha em          -> factor_emission, color
//   plane 1      F   = sum d absorption * ab   -> factor_absorption
//   plane 2      rac = sum d reflection * re   -> factor_reflection
//   plane 3+3l+c P   = sum (d illuminated)_c * contrib_l
//                                              -> light_colors, color
// Lit, the shading chain runs backwards per light: d shade -> d LUT
// coordinates -> d angles -> d normal -> d six emission taps, or with
// lookup gradient volumes (K2L, K6L) d the three gradient volumes; that
// replay of a sample is lit_replay.cuh's, shared with the lit z-brick
// gradient segment (brick_bwd.cu). The angle adjoint floors 1 - r^2 at 1e-6 when
// angle_floor is set (the fast entry points' convention) and is zero
// beyond |r| >= 1 - 1e-6 otherwise (what autograd of the angle gives).
//
// What bounds it on this card. Per sample the replay repeats the forward's
// gathers, and the scatter issues float atomic adds into grids of the
// volume's size, where the rays of neighbouring pixels hit the same voxels:
// 8 a sample and grid unlit (K3) if each sample adds its shares alone; lit
// (K6), with absorption and reflection in volumes of their own, 8 each for
// those and, for the emission centre and its six taps, 56 as seven separate
// scatters before this design and now 20 where the taps lie half a voxel out
// (at most 32). The roofline counts float32 operations against the volumes
// read and the grids written once and calls it operation-bound
// (chip_smoke.py counts the work of a step, not this implementation's
// instructions); what it waits on is the gathers, as the forward does, and
// the atomic units in L2.
//
// What the design does about it. A thread per ray, in blocks 16 rays wide
// (a warp is two rows of 16 neighbouring rays): K3 and K6 in 16x8, so the
// atomics of a warp fall into few cache lines, K2 in 16 x kK2Rows unlit and
// 16 x kK2LitRows lit, K2L in 16 x kK2LRows (see their kernels). atomicAdd
// whose result is unused
// compiles to a reduction (RED) that does not wait for the old value.
// - Unlit K2 (march_bwd_params_kernel) has no scatter: what it waits on is
//   K1's gathers. Where absorption has emission's shape it reads both from
//   one packed (D, H, W, 2) grid, one 8-byte load a corner instead of two
//   4-byte ones: fewer load instructions, and fewer sectors and lines a
//   step (chip_smoke.py, gather_footprint; PERF.md).
// - K3 (march_bwd_scatter_kernel) computes a sample's cell once for both
//   grids where absorption has emission's shape, fetches both at its
//   corners, and carries the ray's pending corner sums in registers
//   (corner_carry.cuh, CornerCarry, as the K7 gradient segment does): a
//   corner goes out as one atomic add when the ray leaves it, about 2 a
//   sample for both grids instead of 16 (chip_smoke.py, march_flushes).
// - Lit with lookup gradient volumes, K2L and K6L replay K5's step: where
//   emission and the three gradient volumes have one shape they read the
//   float4 grid that the wrapper packs once a call (ops/cuda_march.py,
//   pack_lookup; PACKED), one 16-byte load a corner; otherwise each volume
//   is fetched and scattered at its own corners. What bounded K6L was its
//   scatter: 48 scalar atomic adds a sample (32 for the four cotangents of
//   the pack's cell, 16 for absorption and reflection) ran 36.5 ms at
//   256^3 / 512^2 on an H100, 1.34x K6 though it loads fewer voxels, and
//   29 ms more than K2L, which replays the same samples and scatters
//   nothing (PERF.md). From the pack K6L now adds a corner's four
//   cotangents as one vector reduction (scatter_packed: atomicAdd on a
//   float4, REDG.E.ADD.F32x4) into a zeroed (D, H, W, 4) accumulator laid
//   out as the pack, and, where absorption and reflection are volumes of
//   emission's shape (PAIRED), their two as one float2 reduction at
//   emission's cell into a (D, H, W, 2) one; the wrapper unpacks both into
//   the grids (ops/cuda_grads.py). That is 16 reductions a sample instead
//   of 48, each row pair in one or two 32-byte sectors an accumulator
//   (chip_smoke.py counts both from the plain walk, march_scatter_adds).
//   In turns on one card the float4 step took K6L from 36.5 to 21.0-21.7
//   ms and the float2 step to 16.8-17.3; PAIRED also needs fewer registers
//   (145 against 168), since one cell serves the six grids. K6L keeps K6's
//   register cap and 16x8 blocks (three an SM); the unpacked forms of K6L
//   and K2L keep their scalar fetches and scatters and get more registers
//   (kUnpackedMaxRegisters, two blocks an SM), which they need not to spill.
// - K2L scatters nothing: what bounds it is K5's replayed step, its load
//   instructions above all. A one-light sample made 32: 8 of the float4
//   pack, 8 of the LUT, and 16 for absorption and reflection, each sampled
//   at a cell of its own. Where both are volumes of emission's shape
//   (PAIR_IN) it reads them from one (D, H, W, 2) grid that the wrapper
//   packs for the call (ops/cuda_grads.py, pack_lookup_pair) at the pack's
//   cell: 8 eight-byte loads for 16 four-byte ones, one cell for three,
//   4.09 sectors a sample for 6.78 (chip_smoke.py, gather_footprint). Each
//   channel is blended as sample() blends its volume, so the per-ray planes
//   are the unpaired form's to the bit. In turns at 256^3 / 512^2 on an
//   "NVIDIA H100 80GB HBM3" at 700 W the call went from 8.08 and 7.75 ms
//   to 6.32 and 6.38, the pair's pack (0.23 ms) included (PERF.md).
// - Lit, the replay fetches the centre and the six taps through the shared
//   window of march_common.cuh (20 loads instead of 56), and the scatter of
//   their cotangents is the window's adjoint (scatter_em_taps): each window
//   voxel's share of the centre and the taps is summed first and goes out as
//   one atomic add, 36 a sample instead of 72 with absorption and reflection
//   in volumes of their own. The window is rebuilt from the position after
//   the lights instead of being kept in registers through them: K6 took
//   251-255 registers a thread and spilled with seven separate fetches and
//   scatters, and takes at most 168 without spilling now (ptxas -v), three
//   16x8 blocks an SM.
// Nothing of the TPU design is carried over: the one-hot matmul scatter, the
// read-modify-write windows, the overflow ladder and the sweep axis stood in
// for atomics. The per-light sums live in shared memory, one private column
// per thread, so the number of lights is not a compile-time constant. A ray
// whose cotangent is zero is skipped: all it could add is zero.
//
// Atomic adds land in no fixed order, so the grids differ from run to run
// in the last bits. Build flags as for march_fwd.cu (-fmad=false, no fast
// math). Plain C interface, loaded with ctypes (ops/cuda_grads.py).

#include "lit_replay.cuh"

// Mirrored field for field by GradArgs in ops/cuda_grads.py.
struct GradArgs {
  MarchArgs m;         // out and steps are unused
  Vol2 pair;           // by mode, of emission's shape, 8-byte aligned, or null:
                       // unlit K2: emission and absorption (PAIRED);
                       // K2L from the pack: absorption and reflection, neither
                       // aliased (PAIR_IN); every other mode null
  const float* g;      // (height, width, 3) pixel cotangent
  const float* image;  // (height, width, 3) the forward kernel's output
  float* d_em;         // zero-initialised gradient grids, SCATTER only;
  float* d_ab;         // null when the role is aliased to emission
  float* d_re;         // or unlit
  float* d_gx;         // the gradient volumes' grids: K6L unpacked only, else null
  float* d_gy;
  float* d_gz;
  float4* d_pack;      // K6L from the pack: the zeroed (D, H, W, 4) accumulator of
                       // emission's and the gradient volumes' cotangents, 16-byte
                       // aligned, laid out as the pack (d_em, d_gx, d_gy, d_gz null)
  float2* d_pair;      // K6L from the pack with absorption and reflection of
                       // emission's shape, neither aliased: the zeroed (D, H, W, 2)
                       // accumulator of their cotangents, 8-byte aligned (d_ab,
                       // d_re null); else null
  float* planes;       // (3 + 3 n_lights, height, width)
  int angle_floor;
};

namespace {

// at least the threads of a lit block: the lights' sums live in its shared memory
constexpr int kThreads = kBlock * kBlock;

// The lit backward march of one ray (lit K2, and K6 with SCATTER; K2L and
// K6L with LOOKUP, PAIRED K6L's absorption and reflection scattered as one
// float2, PAIR_IN K2L's read as one from ga.pair): the pixel of this thread
// of a COLS x ROWS block, its samples replayed by lit_replay_sample
// (lit_replay.cuh) over the whole volumes.
template <bool SCATTER, bool LOOKUP, bool PACKED, bool AB_ALIASED, bool RE_ALIASED, bool PAIRED,
          bool PAIR_IN, int COLS, int ROWS>
__device__ __forceinline__ void march_bwd_ray(const GradArgs& ga) {
  constexpr int kT = COLS * ROWS;
  extern __shared__ float light_sums[];  // [3 n_lights][kT], a column per thread
  const MarchArgs& a = ga.m;
  const int px = blockIdx.x * COLS + threadIdx.x;
  const int py = blockIdx.y * ROWS + threadIdx.y;
  if (px >= a.width || py >= a.height) return;
  const int tid = threadIdx.y * COLS + threadIdx.x;
  const int n_lights = a.n_lights;
  for (int k = 0; k < 3 * n_lights; ++k) light_sums[k * kT + tid] = 0.0f;

  LitRay r = {};
  V3 dir;
  float tnear, tfar;
  const bool hit = make_ray(a, px, py, r.origin, dir, tnear, tfar);

  const float threshold = __ldg(a.settings + 6);
  const float tstep = a.tstep;
  const size_t pix = (size_t)py * a.width + px;
  r.g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};
  const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                  __ldg(ga.image + 3 * pix + 2)};
  r.total_dot = dot(r.g, out);

  if (hit && !(r.g.x == 0.0f && r.g.y == 0.0f && r.g.z == 0.0f)) {
    const LitConsts c = lit_consts(a, ga.angle_floor != 0);
    const LitGrids d = {ga.d_em, ga.d_ab, ga.d_re,   ga.d_gx,
                        ga.d_gy, ga.d_gz, ga.d_pack, ga.d_pair};
    float sw = 0.0f;
    float t = tnear;
    V3 p = {r.origin.x + dir.x * tnear, r.origin.y + dir.y * tnear, r.origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      lit_replay_sample<SCATTER, LOOKUP, PACKED, AB_ALIASED, RE_ALIASED, PAIRED, PAIR_IN>(
          a, c, d, LitPlaces<WholeZ>{}, p, to_sample(a, p), sw, r, light_sums + tid, kT,
          ga.pair);
      // ---- advance exactly like the forward march ----
      t = t + tstep;
      if (!(sw <= threshold) || !(t <= tfar)) break;
      p = {p.x + step.x, p.y + step.y, p.z + step.z};
    }
  }

  const size_t plane = (size_t)a.width * a.height;
  ga.planes[pix] = r.acc_e;
  ga.planes[plane + pix] = r.acc_f;
  ga.planes[2 * plane + pix] = r.acc_rac;
  for (int k = 0; k < 3 * n_lights; ++k) {
    ga.planes[(3 + k) * plane + pix] = light_sums[k * kT + tid];
  }
}

// Lit K2 in a kernel of its own, in 16 x kK2LitRows blocks: 16x8 ran about
// 11.0 ms against 12.8 in 16x16 at 256^3 / 512^2 on an H100, with the same
// 128 registers a thread (PERF.md).
constexpr int kK2LitRows = 8;

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __launch_bounds__(kBlock * kK2LitRows)
    march_bwd_lit_params_kernel(const GradArgs ga) {
  march_bwd_ray<false, false, false, AB_ALIASED, RE_ALIASED, false, false, kBlock, kK2LitRows>(
      ga);
}

// K2L: lit K2 with lookup gradient volumes, from the packed grid; PAIR_IN
// (absorption and reflection separate and of emission's shape) both read
// from the pair at the pack's cell. In 16 x kK2LRows blocks, its unpacked
// form too: in turns on an H100 (PERF.md) 16x4 ran within the noise of
// 16x8 (the kernel 5.76-5.92 ms against 5.65-6.24), 16x16 slower
// (6.34-6.74 against 5.96-6.17), and one light's sums in registers instead
// of shared memory slower too (6.25-6.91).
constexpr int kK2LRows = 8;

template <bool AB_ALIASED, bool RE_ALIASED, bool PAIR_IN>
__global__ void __launch_bounds__(kBlock * kK2LRows)
    march_bwd_lookup_params_kernel(const GradArgs ga) {
  march_bwd_ray<false, true, true, AB_ALIASED, RE_ALIASED, false, PAIR_IN, kBlock, kK2LRows>(ga);
}

// K6 in a kernel of its own, in 16x8 blocks (a warp is two rows of 16
// neighbouring rays, as in a 16x16 block). It needs up to 174 registers
// without spilling; left to itself, ptxas held one variant (every role
// aliased) at 128 and spilled. Capped at 168 (kLitMaxRegisters,
// lit_replay.cuh) none spills, and an SM holds three of these blocks: 12
// warps, where one 16x16 block gave 8. Capped at 128 (16 warps) every K6
// variant spilled and ran slower in trial builds.
constexpr int kK6Cols = 16, kK6Rows = 8;

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kLitMaxRegisters) march_bwd_lit_scatter_kernel(const GradArgs ga) {
  march_bwd_ray<true, false, false, AB_ALIASED, RE_ALIASED, false, false, kK6Cols, kK6Rows>(ga);
}

// K6L: K6 with lookup gradient volumes, from the packed grid, under K6's
// register cap and in its blocks; PAIRED (absorption and reflection of
// emission's shape, neither aliased) their cotangents as one float2.
template <bool AB_ALIASED, bool RE_ALIASED, bool PAIRED>
__global__ void __maxnreg__(kLitMaxRegisters) march_bwd_lookup_scatter_kernel(const GradArgs ga) {
  march_bwd_ray<true, true, true, AB_ALIASED, RE_ALIASED, PAIRED, false, kK6Cols, kK6Rows>(ga);
}

// K2L and K6L with gradient volumes of another shape than emission's (no
// pack): each volume fetched at its own corners, under the higher cap
// kUnpackedMaxRegisters (lit_replay.cuh), which they need not to spill: two
// 16x8 blocks an SM, where K6L's packed form fits three.

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kUnpackedMaxRegisters)
    march_bwd_lookup_unpacked_params_kernel(const GradArgs ga) {
  march_bwd_ray<false, true, false, AB_ALIASED, RE_ALIASED, false, false, kBlock, kK2LRows>(ga);
}

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kUnpackedMaxRegisters)
    march_bwd_lookup_unpacked_scatter_kernel(const GradArgs ga) {
  march_bwd_ray<true, true, false, AB_ALIASED, RE_ALIASED, false, false, kK6Cols, kK6Rows>(ga);
}

// K3 in a kernel of its own: the unlit replay with the carried scatter.
// Each sample computes its cell once (corner_carry.cuh); emission and, of
// its shape, absorption are fetched at its corners with sample()'s blend, so
// the forward values, the stop test and the samples are the forward's.
// Their cotangents go into CornerCarry, one carry of both grids where
// absorption has emission's shape (AB_OWN_CELL false), its own cell and
// carry where it has another; aliased absorption adds into emission's.
// 16x8 blocks ran 0.85 ms faster than 16x16 on an H100 (PERF.md, PR 6).
constexpr int kK3Cols = 16, kK3Rows = 8;

template <bool AB_ALIASED, bool AB_OWN_CELL>
__global__ void __launch_bounds__(kK3Cols * kK3Rows) march_bwd_scatter_kernel(const GradArgs ga) {
  constexpr int kCarried = AB_ALIASED || AB_OWN_CELL ? 1 : 2;
  const MarchArgs& a = ga.m;
  const int px = blockIdx.x * kK3Cols + threadIdx.x;
  const int py = blockIdx.y * kK3Rows + threadIdx.y;
  if (px >= a.width || py >= a.height) return;

  V3 origin, dir;
  float tnear, tfar;
  const bool hit = make_ray(a, px, py, origin, dir, tnear, tfar);

  const float* st = a.settings;
  const size_t pix = (size_t)py * a.width + px;
  const V3 g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};

  float acc_e = 0.0f, acc_f = 0.0f;
  if (hit && !(g.x == 0.0f && g.y == 0.0f && g.z == 0.0f)) {
    const float fe = __ldg(st + 0), fa = __ldg(st + 1);
    const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
    const float threshold = __ldg(st + 6);
    const float tstep = a.tstep;
    const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                    __ldg(ga.image + 3 * pix + 2)};
    const float total_dot = dot(g, out);
    const ZSlab em_z = whole(a.em), ab_z = whole(a.ab);
    CornerCarry<kCarried> carry(a.em, em_z, ga.d_em, ga.d_ab);
    CornerCarry<1> ab_carry(a.ab, ab_z, ga.d_ab, nullptr);  // with AB_OWN_CELL
    float sw = 0.0f, prefix = 0.0f;
    float t = tnear;
    V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      // ---- the step's forward values, as march_fwd.cu has them ----
      const V3 s = to_sample(a, p);
      const Cell k = cell_of(a.em, em_z, s);
      const Cell ka = AB_OWN_CELL ? cell_of(a.ab, ab_z, s) : k;
      float em, ab;
      if (AB_ALIASED || AB_OWN_CELL) {
        em = fetch_cell(a.em, em_z, k);
        ab = AB_ALIASED ? em : fetch_cell(a.ab, ab_z, ka);
      } else {
        fetch_cell_pair(a.em, a.ab, em_z, k, em, ab);
      }
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float transmit = expf(-absorption * tstep);
      const float alpha = 1.0f - transmit;
      const V3 illum = {emission * tstep * color.x, emission * tstep * color.y,
                        emission * tstep * color.z};
      const float tw = 1.0f - sw;
      const V3 d_s = scale(g, tw);
      const V3 d_illum = scale(d_s, alpha);

      // ---- cotangents of (s, alpha) from the under operator ----
      prefix = prefix + tw * (g.x * (illum.x * alpha) + g.y * (illum.y * alpha) +
                              g.z * (illum.z * alpha));
      const float one_m_a = 1.0f - alpha;
      const float d_alpha = one_m_a > 0.0f ? -(total_dot - prefix) / one_m_a : 0.0f;

      // ---- adjoint of the step, its shares carried ----
      const float d_absorption = (d_alpha + dot(d_s, illum)) * (transmit * tstep);
      acc_f = acc_f + d_absorption * ab;
      acc_e = acc_e + tw * alpha * em;
      float d_at_em = dot(d_illum, color) * tstep * fe;
      const float d_ab = d_absorption * fa;
      if (AB_ALIASED) d_at_em = d_at_em + d_ab;
      float wk[8];
      carry.move_to(k);
      corner_weights(k, wk);
      carry.add(wk, d_at_em, d_ab);
      if (AB_OWN_CELL) {
        ab_carry.move_to(ka);
        corner_weights(ka, wk);
        ab_carry.add(wk, d_ab, 0.0f);
      }

      // ---- advance exactly like the forward march ----
      sw = tw * alpha + sw;
      t = t + tstep;
      if (!(sw <= threshold) || !(t <= tfar)) break;
      p = {p.x + step.x, p.y + step.y, p.z + step.z};
    }
    carry.flush_all();
    if (AB_OWN_CELL) ab_carry.flush_all();
  }

  const size_t plane = (size_t)a.width * a.height;
  ga.planes[pix] = acc_e;
  ga.planes[plane + pix] = acc_f;
  ga.planes[2 * plane + pix] = 0.0f;
}

// Unlit K2 in a kernel of its own: the replay of K1's march that leaves
// only the per-ray planes E and F. Each step computes emission's cell once
// (corner_carry.cuh, cell_of). PAIRED (absorption separate and of
// emission's shape): both volumes come from the (D, H, W, 2) grid that the
// wrapper packs for the call (ops/cuda_grads.py, pack_pair), one 8-byte
// load a corner, 8 load instructions a step instead of 16 (fetch_packed2).
// Otherwise emission is fetched at its cell and absorption, unless
// aliased, at its own. Every channel is blended as sample() blends its
// volume, so em and ab, and the step where the replay stops, are K1's
// float for float. 16 x kK2Rows blocks: the rays of a block end at
// different steps, and a small block gives its SM slot back sooner; at
// 256^3 / 512^2 on an H100, 16x4 ran 2.31 ms, 16x8 2.60, 16x16 2.84, and
// without the pack 4.05 in 16x8 (PERF.md).
constexpr int kK2Rows = 4;

template <bool AB_ALIASED, bool PAIRED>
__global__ void __launch_bounds__(kBlock * kK2Rows) march_bwd_params_kernel(const GradArgs ga) {
  static_assert(!(AB_ALIASED && PAIRED), "an aliased absorption is not packed");
  const MarchArgs& a = ga.m;
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kK2Rows + threadIdx.y;
  if (px >= a.width || py >= a.height) return;

  V3 origin, dir;
  float tnear, tfar;
  const bool hit = make_ray(a, px, py, origin, dir, tnear, tfar);

  const float* st = a.settings;
  const size_t pix = (size_t)py * a.width + px;
  const V3 g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};

  float acc_e = 0.0f, acc_f = 0.0f;
  if (hit && !(g.x == 0.0f && g.y == 0.0f && g.z == 0.0f)) {
    const float fe = __ldg(st + 0), fa = __ldg(st + 1);
    const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
    const float threshold = __ldg(st + 6);
    const float tstep = a.tstep;
    const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                    __ldg(ga.image + 3 * pix + 2)};
    const float total_dot = dot(g, out);
    float sw = 0.0f, prefix = 0.0f;
    float t = tnear;
    V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      // ---- the step's forward values, as march_fwd.cu has them ----
      const V3 s = to_sample(a, p);
      const Cell k = cell_of(a.em, whole(a.em), s);
      float em, ab;
      if (PAIRED) {
        const float2 q = fetch_packed2(ga.pair, k);
        em = q.x;
        ab = q.y;
      } else {
        em = fetch_cell(a.em, whole(a.em), k);
        ab = AB_ALIASED ? em : fetch_cell(a.ab, whole(a.ab), cell_of(a.ab, whole(a.ab), s));
      }
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float transmit = expf(-absorption * tstep);
      const float alpha = 1.0f - transmit;
      const V3 illum = {emission * tstep * color.x, emission * tstep * color.y,
                        emission * tstep * color.z};
      const float tw = 1.0f - sw;
      const V3 d_s = scale(g, tw);

      // ---- cotangents of (s, alpha) from the under operator ----
      prefix = prefix + tw * (g.x * (illum.x * alpha) + g.y * (illum.y * alpha) +
                              g.z * (illum.z * alpha));
      const float one_m_a = 1.0f - alpha;
      const float d_alpha = one_m_a > 0.0f ? -(total_dot - prefix) / one_m_a : 0.0f;

      // ---- adjoint of the step, to the per-ray sums only ----
      const float d_absorption = (d_alpha + dot(d_s, illum)) * (transmit * tstep);
      acc_f = acc_f + d_absorption * ab;
      acc_e = acc_e + tw * alpha * em;

      // ---- advance exactly like the forward march ----
      sw = tw * alpha + sw;
      t = t + tstep;
      if (!(sw <= threshold) || !(t <= tfar)) break;
      p = {p.x + step.x, p.y + step.y, p.z + step.z};
    }
  }

  const size_t plane = (size_t)a.width * a.height;
  ga.planes[pix] = acc_e;
  ga.planes[plane + pix] = acc_f;
  ga.planes[2 * plane + pix] = 0.0f;
}

// K2 unlit: the pair where the host packed it, else each volume at its own
// cell (absorption aliased, or of another shape).
cudaError_t launch_unlit_params(const GradArgs& ga, bool ab_aliased, cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  const dim3 block(kBlock, kK2Rows);
  const dim3 grid((a.width + kBlock - 1) / kBlock, (a.height + kK2Rows - 1) / kK2Rows);
  if (ga.pair.data != nullptr) {
    const Vol2& q = ga.pair;
    if (ab_aliased || q.d != a.em.d || q.h != a.em.h || q.w != a.em.w) return cudaErrorInvalidValue;
    march_bwd_params_kernel<false, true><<<grid, block, 0, stream>>>(ga);
  } else if (ab_aliased) {
    march_bwd_params_kernel<true, false><<<grid, block, 0, stream>>>(ga);
  } else {
    march_bwd_params_kernel<false, false><<<grid, block, 0, stream>>>(ga);
  }
  return cudaGetLastError();
}

// K3: absorption shares emission's cell where it has its shape.
cudaError_t launch_unlit_scatter(const GradArgs& ga, bool ab_aliased, cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  const dim3 block(kK3Cols, kK3Rows);
  const dim3 grid((a.width + kK3Cols - 1) / kK3Cols, (a.height + kK3Rows - 1) / kK3Rows);
  const bool same = a.ab.d == a.em.d && a.ab.h == a.em.h && a.ab.w == a.em.w;
  if (ab_aliased) {
    march_bwd_scatter_kernel<true, false><<<grid, block, 0, stream>>>(ga);
  } else if (same) {
    march_bwd_scatter_kernel<false, false><<<grid, block, 0, stream>>>(ga);
  } else {
    march_bwd_scatter_kernel<false, true><<<grid, block, 0, stream>>>(ga);
  }
  return cudaGetLastError();
}

// Lit K2 (SCATTER false) and K6, with LOOKUP K2L and K6L (from the packed
// grid with PACKED), by which roles are aliased to emission; from the pack
// K6L's PAIRED form where the host gave the float2 accumulator (d_pair), K2L's
// PAIR_IN form where it gave the pair (pair).
template <bool SCATTER, bool LOOKUP, bool PACKED, bool AB, bool RE>
cudaError_t launch_lit(const GradArgs& ga, cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  constexpr int cols = SCATTER ? kK6Cols : kBlock;
  constexpr int rows = SCATTER ? kK6Rows : LOOKUP ? kK2LRows : kK2LitRows;
  const dim3 block(cols, rows);
  const dim3 grid((a.width + cols - 1) / cols, (a.height + rows - 1) / rows);
  const size_t shared = sizeof(float) * 3 * a.n_lights * cols * rows;
  if constexpr (SCATTER && LOOKUP && PACKED && !AB && !RE) {
    if (ga.d_pair != nullptr) {
      march_bwd_lookup_scatter_kernel<false, false, true><<<grid, block, shared, stream>>>(ga);
    } else {
      march_bwd_lookup_scatter_kernel<false, false, false><<<grid, block, shared, stream>>>(ga);
    }
  } else if constexpr (SCATTER && LOOKUP && PACKED) {
    march_bwd_lookup_scatter_kernel<AB, RE, false><<<grid, block, shared, stream>>>(ga);
  } else if constexpr (SCATTER && LOOKUP) {
    march_bwd_lookup_unpacked_scatter_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  } else if constexpr (SCATTER) {
    march_bwd_lit_scatter_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  } else if constexpr (LOOKUP && PACKED && !AB && !RE) {
    if (ga.pair.data != nullptr) {
      march_bwd_lookup_params_kernel<false, false, true><<<grid, block, shared, stream>>>(ga);
    } else {
      march_bwd_lookup_params_kernel<false, false, false><<<grid, block, shared, stream>>>(ga);
    }
  } else if constexpr (LOOKUP && PACKED) {
    march_bwd_lookup_params_kernel<AB, RE, false><<<grid, block, shared, stream>>>(ga);
  } else if constexpr (LOOKUP) {
    march_bwd_lookup_unpacked_params_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  } else {
    march_bwd_lit_params_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  }
  return cudaGetLastError();
}

template <bool SCATTER, bool LOOKUP = false, bool PACKED = false>
cudaError_t launch_lit_aliasing(const GradArgs& ga, bool ab_aliased, bool re_aliased,
                                cudaStream_t stream) {
  if (ab_aliased) {
    return re_aliased ? launch_lit<SCATTER, LOOKUP, PACKED, true, true>(ga, stream)
                      : launch_lit<SCATTER, LOOKUP, PACKED, true, false>(ga, stream);
  }
  return re_aliased ? launch_lit<SCATTER, LOOKUP, PACKED, false, true>(ga, stream)
                    : launch_lit<SCATTER, LOOKUP, PACKED, false, false>(ga, stream);
}

inline bool same_shape(const Vol& a, int d, int h, int w) {
  return a.d == d && a.h == h && a.w == w;
}

// K2L and K6L: from the packed grid where the host packed one (emission and
// the three gradient volumes of one shape), else from the four volumes.
template <bool SCATTER>
cudaError_t launch_lookup(const GradArgs& ga, bool ab_aliased, bool re_aliased,
                          cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  if (a.gx.data == nullptr || a.gy.data == nullptr || a.gz.data == nullptr)
    return cudaErrorInvalidValue;
  const Vol4& pk = a.packed;
  if (pk.data == nullptr) {
    if (ga.d_pair != nullptr || ga.pair.data != nullptr ||
        (SCATTER && (ga.d_em == nullptr || ga.d_gx == nullptr || ga.d_gy == nullptr ||
                     ga.d_gz == nullptr)))
      return cudaErrorInvalidValue;
    return launch_lit_aliasing<SCATTER, true, false>(ga, ab_aliased, re_aliased, stream);
  }
  if (SCATTER && (ga.d_pack == nullptr || reinterpret_cast<size_t>(ga.d_pack) % 16 != 0))
    return cudaErrorInvalidValue;
  // the pairs, K6L's accumulator and K2L's grid: absorption and reflection
  // separate and of emission's shape
  const bool own_pair = !ab_aliased && !re_aliased && same_shape(a.ab, a.em.d, a.em.h, a.em.w) &&
                        same_shape(a.re, a.em.d, a.em.h, a.em.w);
  if (ga.d_pair != nullptr &&
      (!SCATTER || !own_pair || reinterpret_cast<size_t>(ga.d_pair) % 8 != 0))
    return cudaErrorInvalidValue;
  const Vol2& q = ga.pair;
  if (q.data != nullptr &&
      (SCATTER || !own_pair || reinterpret_cast<size_t>(q.data) % 8 != 0 ||
       q.d != a.em.d || q.h != a.em.h || q.w != a.em.w))
    return cudaErrorInvalidValue;
  const int d = a.em.d, h = a.em.h, w = a.em.w;
  if (pk.d != d || pk.h != h || pk.w != w || !same_shape(a.gx, d, h, w) ||
      !same_shape(a.gy, d, h, w) || !same_shape(a.gz, d, h, w))
    return cudaErrorInvalidValue;
  return launch_lit_aliasing<SCATTER, true, true>(ga, ab_aliased, re_aliased, stream);
}

}  // namespace

extern "C" {

// Size of GradArgs, so that the Python side can check its mirror.
size_t vr_grad_args_size() { return sizeof(GradArgs); }

// The most lights a launch takes: their per-thread sums must fit the 48 KB
// of shared memory a block gets without opting in to more.
int vr_march_bwd_max_lights() { return (48 * 1024) / (int)(sizeof(float) * 3 * kThreads); }

// Launches the backward march on ``stream``; returns the launch's
// cudaError_t. lit: lighting, from the emission taps or, with lookup, from
// the gradient volumes (args->m.gx, gy, gz, and args->m.packed where the
// host packed them with emission); scatter: also the voxel grids (K3 unlit,
// K6 lit, K6L lookup; from the pack into args->d_pack and, absorption and
// reflection of emission's shape, args->d_pair), else only the per-ray
// planes (K2, K2L; args->pair the pair the host packed for the call, unlit
// K2's emission and absorption, K2L's absorption and reflection, or null).
int vr_march_bwd(const GradArgs* args, int lit, int scatter, int lookup, int ab_aliased,
                 int re_aliased, void* stream) {
  const GradArgs& ga = *args;
  if (ga.m.width <= 0 || ga.m.height <= 0) return (int)cudaSuccess;
  if (lit && ga.m.n_lights > vr_march_bwd_max_lights()) return (int)cudaErrorInvalidValue;
  // the accumulators are K6L's alone, the pair unlit K2's and K2L's
  if (!(lit && lookup && scatter) && (ga.d_pack != nullptr || ga.d_pair != nullptr))
    return (int)cudaErrorInvalidValue;
  if (ga.pair.data != nullptr && (scatter || (lit && !lookup))) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lit && lookup) {
    return (int)(scatter ? launch_lookup<true>(ga, ab_aliased, re_aliased, s)
                         : launch_lookup<false>(ga, ab_aliased, re_aliased, s));
  }
  if (lit) {
    return (int)(scatter ? launch_lit_aliasing<true>(ga, ab_aliased, re_aliased, s)
                         : launch_lit_aliasing<false>(ga, ab_aliased, re_aliased, s));
  }
  return (int)(scatter ? launch_unlit_scatter(ga, ab_aliased, s)
                       : launch_unlit_params(ga, ab_aliased, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
