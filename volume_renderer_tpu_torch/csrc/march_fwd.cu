// march_fwd.cu: the forward ray march for Hopper (sm_90a).
//
// Replaces the forward modes of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688), launched by
// the pl.pallas_call at :1935 through _render_tiled (:2010):
//   K1  unlit                     march_kernel<LIT=false>
//   K4  lit, on-the-fly gradients march_kernel<LIT=true, LOOKUP=false>
//   K5  lit, lookup gradients     march_kernel<LIT=true, LOOKUP=true>
// A launch marches a band of image rows (MarchArgs.row0, height; the TPU
// kernel's band=, pallas_march.py:_launch :1576), the whole image or one
// device's share under rays-DP (parallel/pallas_dp.py).
// It computes the image that ops/forward.py:render_rows (the plain
// PyTorch version) defines, with the same per-ray arithmetic in the same
// order: positions and t advance by accumulation (pos += step, t += tstep),
// trilinear fetches blend x, then y, then z with float32 weights, and the
// march stops when sum.w > opacity_threshold, t > tfar or after n_steps.
//
// What bounds it on this card. Every march step fetches trilinearly: the
// emission, the absorption unless aliased, and when lit the reflection,
// the emission gradient (six taps, or three gradient volumes) and one
// illumination-LUT value per light. The roofline counts the float32
// operations of those steps against the volumes read once, so it calls
// the march operation-bound (chip_smoke.py counts the work of a step, not
// this implementation's instructions); what it waits on is its gathers.
// Before the tap fetch was shared, the time per step of K1, K5 and K4 grew
// with the loads a step (16, 56, 80 with absorption and reflection in
// volumes of their own) to within 5 % (PERF.md), and a 256^3 volume is
// 64 MiB, more than the 50 MB L2. Unlit (K1), what the gathers cost is the
// sectors and lines each warp load instruction touches: counted from the
// plain march's positions (chip_smoke.py, gather_footprint), a corner load
// of a warp of 16x2 neighbouring rays touches about 13 sectors and 11
// lines at 256^3 / 512^2, its 32 lanes about a voxel apart.
//
// What the design does about it. One thread per pixel in 16x16 blocks: the
// rays of a warp are neighbours, so their samples are neighbours too and
// share L1 lines. Loads use the read-only path (__ldg). Each thread stops on
// its own. Three changes to K1 were measured on an H100 and dropped
// (PERF.md): warps of 8x4 or 4x8 pixels touch more sectors and lines a load
// than the 16x2 strips of threadIdx order (the image x axis runs mostly
// along the volume's x in the timed scene) and ran 11-42 % slower; a
// 4x4x2-tiled volume layout would touch more sectors, not fewer, so it was
// not built; and one cell for emission and absorption of one shape, both
// fetched at its corners (corner_carry.cuh, fetch_cell_pair, which K3
// keeps), gained nothing beyond the spread between runs, so K1 fetches
// each volume with sample().
//
// Lit with on-the-fly gradients (K4), the centre fetch and the six
// central-difference taps share their corners (march_common.cuh,
// fetch_em_taps): each voxel of their union is loaded once: 20 loads instead
// of 56 where the taps lie half a voxel out (an isotropic axis), at most 32
// where they lie up to a voxel out, so a step loads 44 instead of 80; an
// axis whose taps lie further out (an anisotropic volume) fetches those two
// taps on their own. Every blend is the one sample() would do, so the image
// stays the plain version's to the bit. The window's loads raise K4 from 80
// to 128 registers (2 blocks of 256 threads an SM instead of 3); capped at
// 80 it spilled and ran slower in a trial build. Nothing of the TPU design
// is carried over: the slice-pair sweep, the window DMA, the lane gathers
// and the 8x128 tile layout stood in for texture units and are not needed
// here. The texture units are not used either: their filtering quantizes the
// weights to 8 bits and would break the agreement with the plain version.
//
// Lit with lookup gradients (K5), a step fetched six volumes with sample()
// and the LUT: 56 scalar loads. Emission and the three gradient volumes
// have one shape wherever Volume.gradient_volumes() made them, so the
// wrapper packs them for each call into one (D, H, W, 4) grid
// (ops/cuda_march.py, pack_lookup) and a corner of the four is one 16-byte
// load: 8 load instructions for the four instead of 32, and 32 a step
// instead of 56 with absorption, reflection and the LUT. One cell
// (corner_carry.cuh: cell_of, fetch_packed) serves the pack, and absorption and
// reflection where they have its shape (fetch_cell). Each channel is
// blended as sample() blends its volume, so the image stays the plain
// version's float for float. Gradient volumes of another shape take the
// per-volume path, an instantiation of its own (PACKED=false). The pack is
// a copy of four volumes a render, timed with the kernel (PERF.md).
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17
// -fmad=false -shared -Xcompiler -fPIC, without --use_fast_math (expf,
// acosf and rsqrtf keep their full accuracy). -fmad=false keeps every
// a*b + c rounded twice, as in the plain version: the normal of a nearly
// flat region rests on the last bits of the taps, and contraction alone
// moved lit pixels visibly. Plain C interface, loaded with ctypes
// (ops/_build.py, ops/cuda_march.py).

#include "corner_carry.cuh"

namespace {

__device__ __forceinline__ bool same_shape(const Vol& a, const Vol& b) {
  return a.d == b.d && a.h == b.h && a.w == b.w;
}

template <bool LIT, bool LOOKUP, bool AB_ALIASED, bool RE_ALIASED, bool PACKED>
__global__ void __launch_bounds__(kBlock * kBlock) march_kernel(const MarchArgs a) {
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kBlock + threadIdx.y;
  if (px >= a.width || py >= a.height) return;

  V3 origin, dir;
  float tnear, tfar;
  const bool hit = make_ray(a, px, py, origin, dir, tnear, tfar);

  const float* st = a.settings;
  const float fe = __ldg(st + 0), fa = __ldg(st + 1), fr = __ldg(st + 2);
  const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
  const float threshold = __ldg(st + 6);
  const float tstep = a.tstep;

  // K5 packed: absorption and reflection of the pack's shape are fetched
  // at its cell (the same corners and weights as their own), others at
  // their own
  const bool ab_cell = PACKED && !AB_ALIASED && same_shape(a.ab, a.em);
  const bool re_cell = PACKED && !RE_ALIASED && same_shape(a.re, a.em);

  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sw = 0.0f;
  int count = 0;
  if (hit) {
    float t = tnear;
    V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      const V3 s = to_sample(a, p);
      float em;
      V3 grad = {0.0f, 0.0f, 0.0f};
      Cell k = {0, 0, 0, 0.0f, 0.0f, 0.0f};  // the pack's cell (PACKED)
      if (LIT && !LOOKUP) {
        const EmTaps e = fetch_em_taps(a, p, tap_geom(a, p, s));
        em = e.c;
        grad = {(e.xp - e.xm) * 0.5f, (e.yp - e.ym) * 0.5f, (e.zp - e.zm) * 0.5f};
      } else if (PACKED) {
        k = cell_of(a.em, whole(a.em), s);
        const float4 q = fetch_packed(a.packed, k);
        em = q.x;
        grad = {q.y, q.z, q.w};
      } else {
        em = sample(a.em, s);
        if (LIT) grad = {sample(a.gx, s), sample(a.gy, s), sample(a.gz, s)};
      }
      const float ab = AB_ALIASED ? em
                       : PACKED   ? fetch_cell(a.ab, whole(a.ab),
                                               ab_cell ? k : cell_of(a.ab, whole(a.ab), s))
                                  : sample(a.ab, s);
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float alpha = 1.0f - expf(-absorption * tstep);
      float ir = emission * tstep * color.x;
      float ig = emission * tstep * color.y;
      float ib = emission * tstep * color.z;
      if (LIT) {
        const float re = RE_ALIASED ? em
                         : PACKED   ? fetch_cell(a.re, whole(a.re),
                                                 re_cell ? k : cell_of(a.re, whole(a.re), s))
                                    : sample(a.re, s);
        const V3 light = shade(a, p, grad, origin, re, fr, color);
        ir = ir + light.x;
        ig = ig + light.y;
        ib = ib + light.z;
      }
      const float tw = 1.0f - sw;
      sr = tw * (ir * alpha) + sr;
      sg = tw * (ig * alpha) + sg;
      sb = tw * (ib * alpha) + sb;
      sw = tw * alpha + sw;
      ++count;
      t = t + tstep;
      if (!(sw <= threshold) || !(t <= tfar)) break;
      p = {p.x + step.x, p.y + step.y, p.z + step.z};
    }
  }
  const size_t pix = (size_t)py * a.width + px;
  a.out[3 * pix + 0] = sr;
  a.out[3 * pix + 1] = sg;
  a.out[3 * pix + 2] = sb;
  if (a.steps != nullptr) a.steps[pix] = count;
}

template <bool LIT, bool LOOKUP, bool AB, bool RE, bool PACKED = false>
cudaError_t launch(const MarchArgs& a, cudaStream_t stream) {
  const dim3 block(kBlock, kBlock);
  const dim3 grid((a.width + kBlock - 1) / kBlock, (a.height + kBlock - 1) / kBlock);
  march_kernel<LIT, LOOKUP, AB, RE, PACKED><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool LIT, bool LOOKUP, bool PACKED = false>
cudaError_t launch_aliasing(const MarchArgs& a, bool ab_aliased, bool re_aliased,
                            cudaStream_t stream) {
  if (ab_aliased) {
    return re_aliased ? launch<LIT, LOOKUP, true, true, PACKED>(a, stream)
                      : launch<LIT, LOOKUP, true, false, PACKED>(a, stream);
  }
  return re_aliased ? launch<LIT, LOOKUP, false, true, PACKED>(a, stream)
                    : launch<LIT, LOOKUP, false, false, PACKED>(a, stream);
}

}  // namespace

extern "C" {

// Size of MarchArgs, so that the Python side can check its mirror.
size_t vr_march_args_size() { return sizeof(MarchArgs); }

// Launches the march on ``stream``; returns the launch's cudaError_t.
// mode: 0 unlit (K1), 1 lit with on-the-fly gradients (K4), 2 lit with
// lookup gradients (K5): from args->packed where the host packed emission
// and the gradient volumes (they have one shape), else from the four volumes.
int vr_march_fwd(const MarchArgs* args, int mode, int ab_aliased, int re_aliased,
                 void* stream) {
  const MarchArgs& a = *args;
  if (a.width <= 0 || a.height <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return (int)(ab_aliased ? launch<false, false, true, true>(a, s)
                              : launch<false, false, false, true>(a, s));
    case 1:
      return (int)launch_aliasing<true, false>(a, ab_aliased, re_aliased, s);
    case 2:
      return (int)(a.packed.data != nullptr
                       ? launch_aliasing<true, true, true>(a, ab_aliased, re_aliased, s)
                       : launch_aliasing<true, true, false>(a, ab_aliased, re_aliased, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
