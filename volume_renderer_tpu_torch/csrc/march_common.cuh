// march_common.cuh: what the forward and the backward march share.
//
// The volume and argument structs, the trilinear fetch, the angle and the
// ray set-up. march_bwd.cu replays the forward step for step, so both
// kernels take their arithmetic from here: one copy, one rounding.

#pragma once

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

// The eye ray of pixel (px, py) (ops/geometry.py:generate_rays: only xVec
// is renormalized) clipped to the box (intersect_box, the reference's
// cascade). False when the ray misses the box.
__device__ __forceinline__ bool make_ray(const MarchArgs& a, int px, int py, V3& origin, V3& dir,
                                         float& tnear, float& tfar) {
  const float* R = a.rotation;
  const V3 xv = {__ldg(R + 0), __ldg(R + 3), __ldg(R + 6)};
  const V3 yv = {__ldg(R + 1), __ldg(R + 4), __ldg(R + 7)};
  const V3 zv = {__ldg(R + 2), __ldg(R + 5), __ldg(R + 8)};
  const float u = (float)px / (float)a.width * 2.0f - 1.0f;
  const float v = (float)py / (float)a.height * 2.0f * a.ratio - a.ratio;
  const float nd = -a.dist;
  origin = {xv.x * a.cam_off + zv.x * nd, xv.y * a.cam_off + zv.y * nd,
                     xv.z * a.cam_off + zv.z * nd};
  const float xd = dot(xv, xv);
  const float xinv = xd > 0.0f ? rsqrtf(xd) : 0.0f;
  const V3 xn = {xv.x * xinv, xv.y * xinv, xv.z * xinv};
  dir = {u * xn.x + v * yv.x + zv.x * a.focal, u * xn.y + v * yv.y + zv.y * a.focal,
         u * xn.z + v * yv.z + zv.z * a.focal};
  const float dd = dot(dir, dir);
  const float dinv = dd > 0.0f ? rsqrtf(dd) : 0.0f;
  dir = {dir.x * dinv, dir.y * dinv, dir.z * dinv};

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
  tnear = fmaxf(tmin, 0.0f);
  tfar = tmax;
  return !(fail1 || fail2);
}

}  // namespace
