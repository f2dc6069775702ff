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

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 16;
constexpr float kPi = 3.14159265358979323846f;
// the normal of a gradient with |g|^2 <= kGradEps2 is the zero vector
constexpr float kGradEps2 = 1e-12f;
// angle() takes pi/2 when |a|^2 |b|^2 <= kAngleDenomEps^2
constexpr float kAngleDenomEps = 1e-12f;

}  // namespace

// One float32 (D, H, W) volume, x fastest.
struct Vol {
  const float* data;
  int d, h, w;
};

// Mirrored field for field by MarchArgs in ops/cuda_march.py.
struct MarchArgs {
  Vol em, ab, re, gx, gy, gz, lut;
  const float* rotation;   // (3, 3) row-major; its columns are xVec, yVec, zVec
  const float* settings;   // factor_emission, factor_absorption,
                           // factor_reflection, color rgb, opacity_threshold
  const float* light_pos;  // (n_lights, 3)
  const float* light_col;  // (n_lights, 3)
  float* out;              // (height, width, 3)
  int* steps;              // (height, width) composited samples, or null
  int width, height, n_lights, n_steps;
  float ratio, cam_off, focal, dist, tstep;
  float boxmin[3], boxmax[3], boxscale[3], gstep[3];
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Corner indices and weight along one axis: u = c * n - 0.5, floor, and
// clamp to [0, n - 1]. The float corner is clamped to [-1, n] before the
// cast, so no out-of-range float reaches the conversion.
__device__ __forceinline__ float corner(float c, int n, int& i0, int& i1) {
  const float u = c * (float)n - 0.5f;
  const float f0 = floorf(u);
  const int i = (int)fminf(fmaxf(f0, -1.0f), (float)n);
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
  return u - f0;
}

// Trilinear fetch at normalized coordinates (x, y, z), CUDA-texture
// semantics with float32 weights; blends x, then y, then z.
__device__ __forceinline__ float sample(const Vol& v, float cx, float cy, float cz) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = corner(cx, v.w, x0, x1);
  const float fy = corner(cy, v.h, y0, y1);
  const float fz = corner(cz, v.d, z0, z1);
  const size_t sy = (size_t)v.w;
  const size_t sz = (size_t)v.w * (size_t)v.h;
  const float* p = v.data;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  const float c000 = __ldg(p + x0 + r00), c100 = __ldg(p + x1 + r00);
  const float c010 = __ldg(p + x0 + r10), c110 = __ldg(p + x1 + r10);
  const float c001 = __ldg(p + x0 + r01), c101 = __ldg(p + x1 + r01);
  const float c011 = __ldg(p + x0 + r11), c111 = __ldg(p + x1 + r11);
  const float c00 = c000 + fx * (c100 - c000);
  const float c10 = c010 + fx * (c110 - c010);
  const float c01 = c001 + fx * (c101 - c001);
  const float c11 = c011 + fx * (c111 - c011);
  const float c0 = c00 + fy * (c10 - c00);
  const float c1 = c01 + fy * (c11 - c01);
  return c0 + fz * (c1 - c0);
}

__device__ __forceinline__ float sample(const Vol& v, V3 c) { return sample(v, c.x, c.y, c.z); }

__device__ __forceinline__ V3 to_sample(const MarchArgs& a, V3 p) {
  return {(p.x - a.boxmin[0]) * a.boxscale[0], (p.y - a.boxmin[1]) * a.boxscale[1],
          (p.z - a.boxmin[2]) * a.boxscale[2]};
}

// acos of the normalized dot product, pi/2 for near-zero-length inputs,
// the ratio clamped to [-1, 1].
__device__ __forceinline__ float angle(V3 a, V3 b) {
  const float d2 = dot(a, a) * dot(b, b);
  float ratio = 0.0f;
  if (d2 > kAngleDenomEps * kAngleDenomEps) ratio = dot(a, b) * rsqrtf(d2);
  return acosf(fminf(fmaxf(ratio, -1.0f), 1.0f));
}

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

  // ray (ops/geometry.py:generate_rays): only xVec is renormalized
  const float* R = a.rotation;
  const V3 xv = {__ldg(R + 0), __ldg(R + 3), __ldg(R + 6)};
  const V3 yv = {__ldg(R + 1), __ldg(R + 4), __ldg(R + 7)};
  const V3 zv = {__ldg(R + 2), __ldg(R + 5), __ldg(R + 8)};
  const float u = (float)px / (float)a.width * 2.0f - 1.0f;
  const float v = (float)py / (float)a.height * 2.0f * a.ratio - a.ratio;
  const float nd = -a.dist;
  const V3 origin = {xv.x * a.cam_off + zv.x * nd, xv.y * a.cam_off + zv.y * nd,
                     xv.z * a.cam_off + zv.z * nd};
  const float xd = dot(xv, xv);
  const float xinv = xd > 0.0f ? rsqrtf(xd) : 0.0f;
  const V3 xn = {xv.x * xinv, xv.y * xinv, xv.z * xinv};
  V3 dir = {u * xn.x + v * yv.x + zv.x * a.focal, u * xn.y + v * yv.y + zv.y * a.focal,
            u * xn.z + v * yv.z + zv.z * a.focal};
  const float dd = dot(dir, dir);
  const float dinv = dd > 0.0f ? rsqrtf(dd) : 0.0f;
  dir = {dir.x * dinv, dir.y * dinv, dir.z * dinv};

  // box clip (ops/geometry.py:intersect_box), the reference's cascade
  const float ix = 1.0f / dir.x, iy = 1.0f / dir.y, iz = 1.0f / dir.z;
  float tmin = ((ix < 0.0f ? a.boxmax[0] : a.boxmin[0]) - origin.x) * ix;
  float tmax = ((ix < 0.0f ? a.boxmin[0] : a.boxmax[0]) - origin.x) * ix;
  const float tymin = ((iy < 0.0f ? a.boxmax[1] : a.boxmin[1]) - origin.y) * iy;
  const float tymax = ((iy < 0.0f ? a.boxmin[1] : a.boxmax[1]) - origin.y) * iy;
  const bool fail1 = (tmin > tymax) || (tymin > tmax);
  if (tymin > tmin) tmin = tymin;
  if (tymax < tmax) tmax = tymax;
  const float tzmin = ((iz < 0.0f ? a.boxmax[2] : a.boxmin[2]) - origin.z) * iz;
  const float tzmax = ((iz < 0.0f ? a.boxmin[2] : a.boxmax[2]) - origin.z) * iz;
  const bool fail2 = (tmin > tzmax) || (tzmin > tmax);
  if (tzmin > tmin) tmin = tzmin;
  if (tzmax < tmax) tmax = tzmax;
  const bool hit = !(fail1 || fail2);

  const float* st = a.settings;
  const float fe = __ldg(st + 0), fa = __ldg(st + 1), fr = __ldg(st + 2);
  const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
  const float threshold = __ldg(st + 6);
  const float tstep = a.tstep;

  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sw = 0.0f;
  int count = 0;
  if (hit) {
    const float tnear = fmaxf(tmin, 0.0f);
    const float tfar = tmax;
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
