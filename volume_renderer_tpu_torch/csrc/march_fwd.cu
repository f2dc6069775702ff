// march_fwd.cu: the forward ray march for Hopper (sm_90a).
//
// Replaces the forward modes of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688), launched by
// the pl.pallas_call at :1935 through _render_tiled (:2010):
//   K1  unlit                     march_kernel<LIT=false>
//   K4  lit, on-the-fly gradients march_kernel<LIT=true, LOOKUP=false>
//   K5  lit, lookup gradients     march_kernel<LIT=true, LOOKUP=true>
// It computes the image that ops/forward.py:render_forward (the plain
// PyTorch version) defines, with the same per-ray arithmetic in the same
// order: positions and t advance by accumulation (pos += step, t += tstep),
// trilinear fetches blend x, then y, then z with float32 weights, and the
// march stops when sum.w > opacity_threshold, t > tfar or after n_steps.
//
// What bounds it on this card. Every march step does one trilinear fetch
// (8 dependent loads) per role: emission, absorption unless aliased, and
// when lit the reflection, six emission taps (or three gradient volumes)
// and one illumination-LUT fetch per light. The roofline counts the
// float32 operations of those steps against the volumes read once, so it
// calls the march operation-bound; what it really waits on is the latency
// of the gathers through L1 and L2 (a 256^3 volume is 64 MiB, more than
// the 50 MB L2) and the spread of trip counts between the rays of a warp.
//
// What the design does about it. One thread per pixel in 16x16 blocks:
// the rays of a warp are neighbours, so their samples are neighbours too
// and share L1 lines. Loads use the read-only path (__ldg). Each thread
// stops on its own. Nothing of the TPU design is carried over: the
// slice-pair sweep, the window DMA, the lane gathers and the 8x128 tile
// layout stood in for texture units and are not needed here. The texture
// units are not used either: their filtering quantizes the weights to 8
// bits and would break the agreement with the plain version.
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17
// -fmad=false -shared -Xcompiler -fPIC, without --use_fast_math (expf,
// acosf and rsqrtf keep their full accuracy). -fmad=false keeps every
// a*b + c rounded twice, as in the plain version: the normal of a nearly
// flat region rests on the last bits of the taps, and contraction alone
// moved lit pixels visibly. Plain C interface, loaded with ctypes
// (ops/_build.py, ops/cuda_march.py).

#include "march_common.cuh"

namespace {

// Illumination summed over the lights (ops/raymarch_core.py:shade_from_taps).
template <bool LOOKUP>
__device__ __forceinline__ V3 shade(const MarchArgs& a, V3 p, V3 s, V3 origin, float re,
                                    float fr, V3 color) {
  V3 g;
  if (LOOKUP) {
    g = {sample(a.gx, s), sample(a.gy, s), sample(a.gz, s)};
  } else {
    const float gs0 = a.gstep[0], gs1 = a.gstep[1], gs2 = a.gstep[2];
    const float xp = sample(a.em, to_sample(a, {p.x + gs0, p.y, p.z}));
    const float xm = sample(a.em, to_sample(a, {p.x - gs0, p.y, p.z}));
    const float yp = sample(a.em, to_sample(a, {p.x, p.y + gs1, p.z}));
    const float ym = sample(a.em, to_sample(a, {p.x, p.y - gs1, p.z}));
    const float zp = sample(a.em, to_sample(a, {p.x, p.y, p.z + gs2}));
    const float zm = sample(a.em, to_sample(a, {p.x, p.y, p.z - gs2}));
    g = {(xp - xm) * 0.5f, (yp - ym) * 0.5f, (zp - zm) * 0.5f};
  }
  const float g2 = dot(g, g);
  const float inv = g2 > kGradEps2 ? rsqrtf(g2) : 0.0f;
  const V3 n = {g.x * -inv, g.y * -inv, g.z * -inv};

  const float reflection = fr * re;
  V3 result = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < a.n_lights; ++l) {
    const V3 lp = {__ldg(a.light_pos + 3 * l), __ldg(a.light_pos + 3 * l + 1),
                   __ldg(a.light_pos + 3 * l + 2)};
    const V3 light_out = sub(lp, p);
    const V3 light_in = sub(origin, p);
    const float al = angle(n, light_in) / kPi;
    const float be = angle(n, light_out) / kPi;
    const float d_out = dot(light_out, n), d_in = dot(light_in, n);
    const V3 out_proj = {light_out.x - n.x * d_out, light_out.y - n.y * d_out,
                         light_out.z - n.z * d_out};
    const V3 in_proj = {light_in.x - n.x * d_in, light_in.y - n.y * d_in,
                        light_in.z - n.z * d_in};
    const float ga = angle(in_proj, out_proj) / kPi;
    const float contrib = reflection * sample(a.lut, al, be, ga);
    result.x = result.x + contrib * __ldg(a.light_col + 3 * l) * color.x;
    result.y = result.y + contrib * __ldg(a.light_col + 3 * l + 1) * color.y;
    result.z = result.z + contrib * __ldg(a.light_col + 3 * l + 2) * color.z;
  }
  return result;
}

template <bool LIT, bool LOOKUP, bool AB_ALIASED, bool RE_ALIASED>
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

  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sw = 0.0f;
  int count = 0;
  if (hit) {
    float t = tnear;
    V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      const V3 s = to_sample(a, p);
      const float em = sample(a.em, s);
      const float ab = AB_ALIASED ? em : sample(a.ab, s);
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float alpha = 1.0f - expf(-absorption * tstep);
      float ir = emission * tstep * color.x;
      float ig = emission * tstep * color.y;
      float ib = emission * tstep * color.z;
      if (LIT) {
        const float re = RE_ALIASED ? em : sample(a.re, s);
        const V3 light = shade<LOOKUP>(a, p, s, origin, re, fr, color);
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

template <bool LIT, bool LOOKUP, bool AB, bool RE>
cudaError_t launch(const MarchArgs& a, cudaStream_t stream) {
  const dim3 block(kBlock, kBlock);
  const dim3 grid((a.width + kBlock - 1) / kBlock, (a.height + kBlock - 1) / kBlock);
  march_kernel<LIT, LOOKUP, AB, RE><<<grid, block, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool LIT, bool LOOKUP>
cudaError_t launch_aliasing(const MarchArgs& a, bool ab_aliased, bool re_aliased,
                            cudaStream_t stream) {
  if (ab_aliased) {
    return re_aliased ? launch<LIT, LOOKUP, true, true>(a, stream)
                      : launch<LIT, LOOKUP, true, false>(a, stream);
  }
  return re_aliased ? launch<LIT, LOOKUP, false, true>(a, stream)
                    : launch<LIT, LOOKUP, false, false>(a, stream);
}

}  // namespace

extern "C" {

// Size of MarchArgs, so that the Python side can check its mirror.
size_t vr_march_args_size() { return sizeof(MarchArgs); }

// Launches the march on ``stream``; returns the launch's cudaError_t.
// mode: 0 unlit (K1), 1 lit with on-the-fly gradients (K4), 2 lit with
// lookup gradients (K5).
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
      return (int)launch_aliasing<true, true>(a, ab_aliased, re_aliased, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
