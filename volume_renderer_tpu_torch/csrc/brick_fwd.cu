// brick_fwd.cu: the forward march of one z-brick for Hopper (sm_90a).
//
// Replaces the forward form of the brick mode (K7) of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688; the brick
// mode at :931-947), launched by the pl.pallas_call at :1935 through
// _launch(brick=...) (:1594) from parallel/bricks.py:427 and :445:
//   phase 1  brick_fwd_kernel<SHADE=false>  the opacity that the brick's own
//            samples build up from zero; fetches absorption alone
//   phase 2  brick_fwd_kernel<SHADE=true>   the brick's contribution to the
//            image from its entry opacity, and its exit opacity
// It computes what ops/brick_march.py (transmittance_pass, shaded_pass, the
// plain PyTorch versions) defines, with the same per-ray arithmetic in the
// same order. Unlit scenes only, like the TPU mode.
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
// Build flags as for march_fwd.cu (-fmad=false, no fast math). Plain C
// interface, loaded with ctypes (ops/cuda_bricks.py).

#include "brick_common.cuh"

namespace {

// Phase 1's block: 16 x kPhase1Rows pixels (phase 2's is 16 x 16), chosen
// by timing 16, 8 and 4 rows.
constexpr int kPhase1Rows = 4;

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
    count = march_brick(a, e, step, tfar, threshold, sw, [&](V3 s, float& w) {
      float em = 0.0f;
      if (SHADE || AB_ALIASED) em = sample_slab(m.em, em_slab, s);
      const float ab = AB_ALIASED ? em : sample_slab(m.ab, ab_slab, s);
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

template <bool SHADE, bool AB>
cudaError_t launch(const BrickArgs& a, cudaStream_t stream) {
  constexpr int rows = block_rows(SHADE);
  const dim3 block(kBlock, rows);
  const dim3 grid((a.m.width + kBlock - 1) / kBlock, (a.m.height + rows - 1) / rows);
  brick_fwd_kernel<SHADE, AB><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Size of BrickArgs, so that the Python side can check its mirror.
size_t vr_brick_args_size() { return sizeof(BrickArgs); }

// Launches the brick march on ``stream``; returns the launch's cudaError_t.
// shade: 0 phase 1 (opacity only, args->m.out and w_in unused; writes the
// entry record), 1 phase 2 (reads the entry record).
int vr_brick_fwd(const BrickArgs* args, int shade, int ab_aliased, void* stream) {
  const BrickArgs& a = *args;
  if (a.m.width <= 0 || a.m.height <= 0) return (int)cudaSuccess;
  if (a.n_bricks < 1 || a.brick < 0 || a.brick >= a.n_bricks) return (int)cudaErrorInvalidValue;
  if (a.entry_step == nullptr || a.entry_state == nullptr) return (int)cudaErrorInvalidValue;
  if (shade && (a.w_in == nullptr || a.m.out == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shade) {
    return (int)(ab_aliased ? launch<true, true>(a, s) : launch<true, false>(a, s));
  }
  return (int)(ab_aliased ? launch<false, true>(a, s) : launch<false, false>(a, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
