// brick_fwd.cu: the forward march of one z-brick for Hopper (sm_90a).
//
// Replaces the forward form of the brick mode (K7) of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688; the brick
// mode at :931-947), launched by the pl.pallas_call at :1935 through
// _launch(brick=...) (:1594) from parallel/bricks.py:427 and :445:
//   phase 1  brick_fwd_kernel<SHADE=false>  the opacity that the brick's own
//            samples build up from zero; fetches absorption alone, lit or not
//   phase 2  brick_fwd_kernel<SHADE=true>   the brick's contribution to the
//            image from its entry opacity, and its exit opacity; unlit
//   lit phase 2  brick_lit_fwd_kernel<LOOKUP, ..., PACKED>  the same for a lit
//            scene, with on-the-fly gradient taps (K4's step) or lookup
//            gradient volumes (K5's, packed where they have one shape), the HG
//            LUT and the lights
// It computes what ops/brick_march.py (transmittance_pass, shaded_pass, the
// plain PyTorch versions) defines, with the same per-ray arithmetic in the
// same order. The TPU mode marches unlit bricks only; the JAX package
// renders a lit brick or slab in XLA, and lit phase 2 is the port's
// counterpart of that code.
//
// What bounds it on this card. As march_fwd.cu: the roofline counts the
// float32 operations of the composited samples against the grids read once
// and calls it operation-bound; it really waits on the gathers.
//
// What the design does about it. A thread per ray, phase 2 in 16x16 blocks as
// the single-device kernels, phase 1 in 16 x kPhase1Rows: rays of very
// different lengths (a walk to the brick, then its own samples) share a
// block, which holds its place on the SM until its longest ray ends, and 16x4
// blocks (36 warps an SM at 56 registers, against 32 in 16x16) ran phase 1
// about a fifth faster than 16x16 and 5 % faster than 16x8 on an H100
// (PERF.md). A corner cache for phase 1, which fetches one volume, was
// measured on an H100 and dropped (PERF.md): it kept a ray's 8 corner values
// in registers and loaded only the corners a move to the next cell brings in,
// 1.04 a sample instead of 8 (chip_smoke.py, corner_loads), and ran 30-60 %
// slower on the flagship scene: its shifts, masks and predicates add
// instructions to every sample, and phase 1's time did not follow its loads.
// Nothing of the TPU mode is carried over: no sweep axis, no dir_ok, no
// window plans, no overflow flag; the ownership bounds own_lo / own_hi in
// local rows became one owner expression in global coordinates. A ray reaches
// its brick by walking from its first step without fetching (about 20
// operations a step): a closed-form skip would round positions differently
// from the single-device march. Phase 1 walks and stores the ray's entry
// record (brick_common.cuh); phase 2 resumes from it, so the walk is paid
// once per brick and render, not twice. A ray without a record, or entering
// above the opacity threshold, writes its zeros at once: a block whose rays
// all do so ends without marching.
//
// Lit phase 2 is K4's or K5's step on the brick's samples, resumed from the
// same entry record: the shared tap fetch (march_common.cuh, fetch_em_taps)
// and shading (shade) with every row placed in the brick's window (ZSlab):
// clamped at the whole volume's faces, then shifted into the window, so a
// sample's taps, two rows beyond it at most, are the whole volume's values
// and the contribution is the plain pass's float for float. What bounds it
// is K4's: the gathers of the taps and the LUT. With lookup gradients, where
// emission and the three gradient windows have one shape (and so one place),
// the wrapper packs them into one (D_win, H, W, 4) grid for each brick and
// render, or window and sweep step (ops/cuda_bricks.py, pack_window), and a
// corner of the four is one 16-byte load placed in the window as slab_row
// places it (corner_carry.cuh: fetch_packed with a ZSlab); one cell serves
// the pack, and absorption and reflection where they have its shape and
// place: K5's PACKED path on windows, 8 load instructions for the four
// instead of 32. Gradient windows of another shape take PACKED=false.
// Its blocks are 16 x kLitRows (16 x kLitLookupRows with lookup): a block
// holds its SM slot until its longest segment in the brick ends
// (chip_smoke.py measures the tails, tail_factor); the rows were chosen by
// timing 16, 8 and 4 in turns (PERF.md). Registers and blocks an SM are
// reported by chip_smoke.py (ptxas -v).
//
// Build flags as for march_fwd.cu (-fmad=false, no fast math). Plain C
// interface, loaded with ctypes (ops/cuda_bricks.py).

#include "brick_common.cuh"

namespace {

// Phase 1's block: 16 x kPhase1Rows pixels (phase 2's is 16 x 16), chosen
// by timing 16, 8 and 4 rows.
constexpr int kPhase1Rows = 4;
// Lit phase 2's blocks: 16 x kLitRows pixels with on-the-fly gradients,
// 16 x kLitLookupRows with lookup gradient volumes, each chosen by timing
// 16, 8 and 4 rows in turns (4 rows spilled in a lookup instantiation).
constexpr int kLitRows = 4;
constexpr int kLitLookupRows = 8;

__host__ __device__ constexpr int lit_rows(bool lookup) {
  return lookup ? kLitLookupRows : kLitRows;
}

__host__ __device__ constexpr int block_rows(bool shade) { return shade ? kBlock : kPhase1Rows; }

template <bool SHADE, bool AB_ALIASED>
__global__ void __launch_bounds__(kBlock * block_rows(SHADE)) brick_fwd_kernel(const BrickArgs a) {
  const MarchArgs& m = a.m;
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * block_rows(SHADE) + threadIdx.y;
  if (px >= m.width || py >= m.height) return;

  const float* st = m.settings;
  const float threshold = __ldg(st + 6);
  const size_t pix = (size_t)py * m.width + px;
  float sw = 0.0f;
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  int count = 0;
  Entry e;
  V3 step = {0.0f, 0.0f, 0.0f};
  float tfar = 0.0f;
  if (SHADE) {
    sw = __ldg(a.w_in + pix);
    e = load_entry(a, pix);
    if (enters(e, sw, threshold)) ray_step(m, px, py, step, tfar);
    else e.i = -1;
  } else {
    e = walk_to_brick(a, px, py, step, tfar);
    store_entry(a, pix, e);
  }
  if (e.i >= 0) {
    const float fe = __ldg(st + 0), fa = __ldg(st + 1);
    const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
    const float tstep = m.tstep;
    const ZSlab em_slab = {a.em_d_global, a.em_z_off};
    const ZSlab ab_slab = {a.ab_d_global, a.ab_z_off};
    count = march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, V3, float& w) {
      float em = 0.0f;
      if (SHADE || AB_ALIASED) em = z_sample(m.em, em_slab, s);
      const float ab = AB_ALIASED ? em : z_sample(m.ab, ab_slab, s);
      const float absorption = fa * ab;
      const float alpha = 1.0f - expf(-absorption * tstep);
      const float tw = 1.0f - w;
      if (SHADE) {
        const float emission = fe * em;
        const float ir = emission * tstep * color.x;
        const float ig = emission * tstep * color.y;
        const float ib = emission * tstep * color.z;
        sr = tw * (ir * alpha) + sr;
        sg = tw * (ig * alpha) + sg;
        sb = tw * (ib * alpha) + sb;
      }
      w = tw * alpha + w;
    });
  }
  if (SHADE) {
    m.out[3 * pix + 0] = sr;
    m.out[3 * pix + 1] = sg;
    m.out[3 * pix + 2] = sb;
  }
  a.w_out[pix] = sw;
  if (m.steps != nullptr) m.steps[pix] = count;
}

// Lit phase 2: the brick's contribution from its entry opacity for a lit
// scene, K4's step (LOOKUP false: the emission taps) or K5's (LOOKUP true:
// the three gradient volumes, each at its own cell, or with PACKED one cell
// of the packed window m.packed) on the brick's windows.
template <bool LOOKUP, bool AB_ALIASED, bool RE_ALIASED, bool PACKED>
__global__ void __launch_bounds__(kBlock * lit_rows(LOOKUP))
    brick_lit_fwd_kernel(const BrickArgs a) {
  const MarchArgs& m = a.m;
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * lit_rows(LOOKUP) + threadIdx.y;
  if (px >= m.width || py >= m.height) return;

  const float* st = m.settings;
  const float threshold = __ldg(st + 6);
  const size_t pix = (size_t)py * m.width + px;
  float sw = __ldg(a.w_in + pix);
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  int count = 0;
  const Entry e = load_entry(a, pix);
  if (enters(e, sw, threshold)) {
    V3 step, origin;
    float tfar;
    ray_step(m, px, py, step, tfar, origin);
    const float fe = __ldg(st + 0), fa = __ldg(st + 1), fr = __ldg(st + 2);
    const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
    const float tstep = m.tstep;
    const ZSlab em_z = {a.em_d_global, a.em_z_off}, ab_z = {a.ab_d_global, a.ab_z_off};
    const ZSlab re_z = {a.re_d_global, a.re_z_off};
    const ZSlab gx_z = {a.gx_d_global, a.gx_z_off}, gy_z = {a.gy_d_global, a.gy_z_off};
    const ZSlab gz_z = {a.gz_d_global, a.gz_z_off};
    // PACKED: absorption and reflection of the pack's shape and place are
    // fetched at its cell (the same corners and weights as their own)
    const bool ab_cell = PACKED && !AB_ALIASED && same_place(m.ab, a.ab_z_off, a.ab_d_global, a);
    const bool re_cell = PACKED && !RE_ALIASED && same_place(m.re, a.re_z_off, a.re_d_global, a);
    count = march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, V3 p, float& w) {
      float em;
      V3 grad;
      Cell k = {0, 0, 0, 0.0f, 0.0f, 0.0f};  // the pack's cell (PACKED)
      if (LOOKUP && PACKED) {
        k = cell_of(m.em, em_z, s);
        const float4 q = fetch_packed(m.packed, k, em_z);
        em = q.x;
        grad = {q.y, q.z, q.w};
      } else if (LOOKUP) {
        em = z_sample(m.em, em_z, s);
        grad = {z_sample(m.gx, gx_z, s), z_sample(m.gy, gy_z, s),
                z_sample(m.gz, gz_z, s)};
      } else {
        const EmTaps t = fetch_em_taps(m, p, tap_geom(m, p, s, em_z), em_z);
        em = t.c;
        grad = {(t.xp - t.xm) * 0.5f, (t.yp - t.ym) * 0.5f, (t.zp - t.zm) * 0.5f};
      }
      const float ab = AB_ALIASED ? em
                       : PACKED   ? fetch_cell(m.ab, ab_z, ab_cell ? k : cell_of(m.ab, ab_z, s))
                                  : z_sample(m.ab, ab_z, s);
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float alpha = 1.0f - expf(-absorption * tstep);
      float ir = emission * tstep * color.x;
      float ig = emission * tstep * color.y;
      float ib = emission * tstep * color.z;
      const float re = RE_ALIASED ? em
                       : PACKED   ? fetch_cell(m.re, re_z, re_cell ? k : cell_of(m.re, re_z, s))
                                  : z_sample(m.re, re_z, s);
      const V3 light = shade(m, p, grad, origin, re, fr, color);
      ir = ir + light.x;
      ig = ig + light.y;
      ib = ib + light.z;
      const float tw = 1.0f - w;
      sr = tw * (ir * alpha) + sr;
      sg = tw * (ig * alpha) + sg;
      sb = tw * (ib * alpha) + sb;
      w = tw * alpha + w;
    });
  }
  m.out[3 * pix + 0] = sr;
  m.out[3 * pix + 1] = sg;
  m.out[3 * pix + 2] = sb;
  a.w_out[pix] = sw;
  if (m.steps != nullptr) m.steps[pix] = count;
}

template <bool SHADE, bool AB>
cudaError_t launch(const BrickArgs& a, cudaStream_t stream) {
  constexpr int rows = block_rows(SHADE);
  const dim3 block(kBlock, rows);
  const dim3 grid((a.m.width + kBlock - 1) / kBlock, (a.m.height + rows - 1) / rows);
  brick_fwd_kernel<SHADE, AB><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool LOOKUP, bool AB, bool RE, bool PACKED>
cudaError_t launch_lit(const BrickArgs& a, cudaStream_t stream) {
  constexpr int rows = lit_rows(LOOKUP);
  const dim3 block(kBlock, rows);
  const dim3 grid((a.m.width + kBlock - 1) / kBlock, (a.m.height + rows - 1) / rows);
  brick_lit_fwd_kernel<LOOKUP, AB, RE, PACKED><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool LOOKUP, bool PACKED = false>
cudaError_t launch_lit_aliasing(const BrickArgs& a, bool ab_aliased, bool re_aliased,
                                cudaStream_t stream) {
  if (ab_aliased) {
    return re_aliased ? launch_lit<LOOKUP, true, true, PACKED>(a, stream)
                      : launch_lit<LOOKUP, true, false, PACKED>(a, stream);
  }
  return re_aliased ? launch_lit<LOOKUP, false, true, PACKED>(a, stream)
                    : launch_lit<LOOKUP, false, false, PACKED>(a, stream);
}

}  // namespace

extern "C" {

// Size of BrickArgs, so that the Python side can check its mirror.
size_t vr_brick_args_size() { return sizeof(BrickArgs); }

// Launches the brick march on ``stream``; returns the launch's cudaError_t.
// shade: 0 phase 1 (opacity only, args->m.out and w_in unused; writes the
// entry record; the same kernel lit or not), 1 phase 2 (reads the entry
// record). lit: phase 2 shades with the lights, from the emission taps or,
// with lookup, from the gradient volumes: from args->m.packed where the host
// packed emission and the gradient windows (they have one shape, the packed
// grid emission's shape by 4), else from the four windows; re_aliased:
// reflection is emission's grid.
int vr_brick_fwd(const BrickArgs* args, int shade, int ab_aliased, int lit, int lookup,
                 int re_aliased, void* stream) {
  const BrickArgs& a = *args;
  if (a.m.width <= 0 || a.m.height <= 0) return (int)cudaSuccess;
  if (a.n_bricks < 1 || a.brick < 0 || a.brick >= a.n_bricks) return (int)cudaErrorInvalidValue;
  if (a.entry_step == nullptr || a.entry_state == nullptr) return (int)cudaErrorInvalidValue;
  if (shade && (a.w_in == nullptr || a.m.out == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shade && lit) {
    if (a.m.lut.data == nullptr || (!re_aliased && a.m.re.data == nullptr) ||
        (lookup && (a.m.gx.data == nullptr || a.m.gy.data == nullptr || a.m.gz.data == nullptr)))
      return (int)cudaErrorInvalidValue;
    const Vol4& pk = a.m.packed;
    if (lookup && pk.data != nullptr) {
      if (pk.d != a.m.em.d || pk.h != a.m.em.h || pk.w != a.m.em.w)
        return (int)cudaErrorInvalidValue;
      return (int)launch_lit_aliasing<true, true>(a, ab_aliased, re_aliased, s);
    }
    return (int)(lookup ? launch_lit_aliasing<true>(a, ab_aliased, re_aliased, s)
                        : launch_lit_aliasing<false>(a, ab_aliased, re_aliased, s));
  }
  if (shade) {
    return (int)(ab_aliased ? launch<true, true>(a, s) : launch<true, false>(a, s));
  }
  return (int)(ab_aliased ? launch<false, true>(a, s) : launch<false, false>(a, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
