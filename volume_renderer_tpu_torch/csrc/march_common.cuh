// march_common.cuh: what the forward and the backward march share.
//
// The volume and argument structs, the trilinear fetch, the emission taps of
// a lit step, the angle, the shading and the ray set-up. march_bwd.cu replays
// the forward step for step, and the z-brick kernels (brick_fwd.cu,
// brick_bwd.cu) take the same steps over a z-window of each volume, so all of
// them take their arithmetic from here: one copy, one rounding.

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

// Four float32 (D, H, W) volumes packed as one (D, H, W, 4) grid, x fastest:
// a voxel's four values are one 16-byte load.
struct Vol4 {
  const float4* data;
  int d, h, w;
};

// Two float32 (D, H, W) volumes packed as one (D, H, W, 2) grid, x fastest:
// a voxel's two values are one 8-byte load.
struct Vol2 {
  const float2* data;
  int d, h, w;
};

// Mirrored field for field by MarchArgs in ops/cuda_march.py.
struct MarchArgs {
  Vol em, ab, re, gx, gy, gz, lut;
  Vol4 packed;             // K5: emission, gx, gy, gz of one shape, or null
  const float* rotation;   // (3, 3) row-major; its columns are xVec, yVec, zVec
  const float* settings;   // factor_emission, factor_absorption,
                           // factor_reflection, color rgb, opacity_threshold
  const float* light_pos;  // (n_lights, 3)
  const float* light_col;  // (n_lights, 3)
  float* out;              // (height, width, 3)
  int* steps;              // (height, width) composited samples, or null
  int width, height;       // a band of height image rows, from row row0:
  int row0, image_height;  // every (height, width) array holds the band alone
  int n_lights, n_steps;
  float ratio, cam_off, focal, dist, tstep;
  float boxmin[3], boxmax[3], boxscale[3], gstep[3];
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// The lower corner along one axis, before the clamp to the volume, and its
// weight f: u = c * n - 0.5, floor. The float is clamped to [-1, n] before
// the cast, so no out-of-range float reaches the conversion.
__device__ __forceinline__ int floor_index(float c, int n, float& f) {
  const float u = c * (float)n - 0.5f;
  const float f0 = floorf(u);
  f = u - f0;
  return (int)fminf(fmaxf(f0, -1.0f), (float)n);
}

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

// Corner indices and weight along one axis, clamped to [0, n - 1].
__device__ __forceinline__ float corner(float c, int n, int& i0, int& i1) {
  float f;
  const int i = floor_index(c, n, f);
  i0 = clamp_index(i, n);
  i1 = clamp_index(i + 1, n);
  return f;
}

__device__ __forceinline__ float lerp(float a, float b, float f) { return a + f * (b - a); }

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

// ---- where a grid lies along z ----
//
// A kernel reads a grid that is the whole volume (WholeZ) or, on the z-brick
// path, a halo-padded z-window of it (ZSlab, corner_carry.cuh). Four
// functions of the placement say what differs: the depth that a normalized z
// is taken against (z_depth), the offset of a row at a global z (row_offset),
// the z corners of a normalized z (z_corner), and a trilinear fetch at
// normalized coordinates (z_sample). For WholeZ they are the single-device
// kernels' own expressions.
struct WholeZ {};

__device__ __forceinline__ int z_depth(const Vol& v, WholeZ) { return v.d; }

__device__ __forceinline__ float z_sample(const Vol& v, WholeZ, V3 c) { return sample(v, c); }

// Offset of row (y, z) of v, each corner clamped to the volume.
__device__ __forceinline__ size_t row_offset(const Vol& v, WholeZ, int y, int z) {
  return (size_t)clamp_index(y, v.h) * (size_t)v.w +
         (size_t)clamp_index(z, v.d) * ((size_t)v.w * (size_t)v.h);
}

// The z corners of normalized z c, clamped to the volume, and their weight.
__device__ __forceinline__ float z_corner(const Vol& v, WholeZ, float c, int& z0, int& z1) {
  return corner(c, v.d, z0, z1);
}

__device__ __forceinline__ V3 to_sample(const MarchArgs& a, V3 p) {
  return {(p.x - a.boxmin[0]) * a.boxscale[0], (p.y - a.boxmin[1]) * a.boxscale[1],
          (p.z - a.boxmin[2]) * a.boxscale[2]};
}

// ---- the emission fetch of a lit step with its six gradient taps ----
//
// Tap x+ is sample(em, to_sample(p + (gstep.x, 0, 0))): its y and z
// coordinates are the centre's float for float, so its y and z corners and
// weights are the centre's; only its x pair differs. Likewise for the y and
// z taps. Along each axis the centre and its two taps read a window of four
// voxels: slot k is voxel clamp(i - 1 + k), i the centre's unclamped lower
// corner, so the centre's pair is slots 1, 2, and a tap whose lower corner
// is i + d reads slots 1 + d, 2 + d. The window holds both taps when the
// plus tap's d is 0 or 1 and the minus tap's -1 or 0: wherever the tap
// offset is at most one voxel (half a voxel on an isotropic axis). Such an
// axis is "near"; on a far axis (anisotropic volumes) the two taps are
// fetched on their own, as sample() does.

// One axis of the window.
struct TapAxis {
  int i;         // the centre's lower corner before the clamp
  int dp, dm;    // the plus and minus taps' lower corners minus i
  float f;       // the centre's weight
  float fp, fm;  // the plus and minus taps' weights
  bool near;
  // slots 0 and 3: used by a tap of a near axis
  __device__ __forceinline__ bool slot0() const { return near && dm < 0; }
  __device__ __forceinline__ bool slot3() const { return near && dp > 0; }
};

// c, cp, cm: the normalized coordinate of the centre and of the plus and
// minus taps along one axis of n voxels.
__device__ __forceinline__ TapAxis tap_axis(float c, float cp, float cm, int n) {
  TapAxis t;
  t.i = floor_index(c, n, t.f);
  t.dp = floor_index(cp, n, t.fp) - t.i;
  t.dm = floor_index(cm, n, t.fm) - t.i;
  t.near = (t.dp == 0 || t.dp == 1) && (t.dm == 0 || t.dm == -1);
  return t;
}

struct TapGeom {
  TapAxis x, y, z;
};

// The window of position p (sample coordinates s = to_sample(a, p)) in the
// emission grid a.em, placed along z by zp: z corners are global rows.
template <class ZP = WholeZ>
__device__ __forceinline__ TapGeom tap_geom(const MarchArgs& a, V3 p, V3 s, ZP zp = ZP()) {
  const V3 sp = to_sample(a, {p.x + a.gstep[0], p.y + a.gstep[1], p.z + a.gstep[2]});
  const V3 sm = to_sample(a, {p.x - a.gstep[0], p.y - a.gstep[1], p.z - a.gstep[2]});
  return {tap_axis(s.x, sp.x, sm.x, a.em.w), tap_axis(s.y, sp.y, sm.y, a.em.h),
          tap_axis(s.z, sp.z, sm.z, z_depth(a.em, zp))};
}

// q[1 + d], for d in -1..2
__device__ __forceinline__ float slot(const float (&q)[4], int d) {
  return d < 0 ? q[0] : d == 0 ? q[1] : d == 1 ? q[2] : q[3];
}

// The x blend of one row's window for a tap whose lower corner is i + d.
__device__ __forceinline__ float blend_x(const float (&q)[4], int d, float f) {
  return lerp(slot(q, d), slot(q, d + 1), f);
}

// The centre fetch and the six taps (xp, xm, yp, ym, zp, zm) of emission.
struct EmTaps {
  float c, xp, xm, yp, ym, zp, zm;
};

// Each value is the float that sample() gives at its own coordinates: the
// same voxels blended with the same weights in the same order (x, then y,
// then z); a blend is shared only where it is the same operation on the
// same inputs. Each voxel of the window is loaded once: 20 loads where
// every axis is near and the offset half a voxel (at most 32 for offsets up
// to a voxel), against 56 for seven sample() calls. A row's loads are
// blended as soon as they arrive, so that few of them are live at once.
// On a z-window (zp a ZSlab) the rows are clamped at the whole volume's
// faces, then shifted into the window, as fetch_cell does: with two halo
// rows a side every tap of an owned sample at an offset of up to a voxel
// lies inside the window, so the values are the whole volume's.
template <class ZP = WholeZ>
__device__ __forceinline__ EmTaps fetch_em_taps(const MarchArgs& a, V3 p, const TapGeom& g,
                                                ZP zp = ZP()) {
  const Vol& v = a.em;
  const TapAxis &X = g.x, &Y = g.y, &Z = g.z;
  const int x0 = clamp_index(X.i - 1, v.w), x1 = clamp_index(X.i, v.w);
  const int x2 = clamp_index(X.i + 1, v.w), x3 = clamp_index(X.i + 2, v.w);
  const bool need_x0 = X.slot0(), need_x3 = X.slot3();
  // x blends with the centre's weight by y slot and z slot (ly: z slots 1,
  // 2; lz: y slots 1, 2), and the x taps' x blends of the centre's rows
  float ly[4][2], lz[2][4], bp[2][2], bm[2][2];
#pragma unroll
  for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
    for (int kz = 0; kz < 2; ++kz) {
      const float* row = v.data + row_offset(v, zp, Y.i + ky, Z.i + kz);
      const float q[4] = {need_x0 ? __ldg(row + x0) : 0.0f, __ldg(row + x1), __ldg(row + x2),
                          need_x3 ? __ldg(row + x3) : 0.0f};
      ly[1 + ky][kz] = lz[ky][1 + kz] = lerp(q[1], q[2], X.f);
      bp[ky][kz] = blend_x(q, X.dp, X.fp);
      bm[ky][kz] = blend_x(q, X.dm, X.fm);
    }
  }
  // y slots 0 and 3 at z slots 1, 2; z slots 0 and 3 at y slots 1, 2: read
  // by the y or z taps alone, at x slots 1, 2
  const bool need_y[2] = {Y.slot0(), Y.slot3()}, need_z[2] = {Z.slot0(), Z.slot3()};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = 3 * e, d = k - 1;  // slot k is corner i + d
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ly[k][j] = lz[j][k] = 0.0f;
      if (need_y[e]) {
        const float* row = v.data + row_offset(v, zp, Y.i + d, Z.i + j);
        ly[k][j] = lerp(__ldg(row + x1), __ldg(row + x2), X.f);
      }
      if (need_z[e]) {
        const float* row = v.data + row_offset(v, zp, Y.i + j, Z.i + d);
        lz[j][k] = lerp(__ldg(row + x1), __ldg(row + x2), X.f);
      }
    }
  }

  EmTaps t;
  t.c = lerp(lerp(ly[1][0], ly[2][0], Y.f), lerp(ly[1][1], ly[2][1], Y.f), Z.f);
  if (X.near) {
    t.xp = lerp(lerp(bp[0][0], bp[1][0], Y.f), lerp(bp[0][1], bp[1][1], Y.f), Z.f);
    t.xm = lerp(lerp(bm[0][0], bm[1][0], Y.f), lerp(bm[0][1], bm[1][1], Y.f), Z.f);
  } else {
    t.xp = z_sample(v, zp, to_sample(a, {p.x + a.gstep[0], p.y, p.z}));
    t.xm = z_sample(v, zp, to_sample(a, {p.x - a.gstep[0], p.y, p.z}));
  }
  if (Y.near) {
    const float q0[4] = {ly[0][0], ly[1][0], ly[2][0], ly[3][0]};
    const float q1[4] = {ly[0][1], ly[1][1], ly[2][1], ly[3][1]};
    t.yp = lerp(blend_x(q0, Y.dp, Y.fp), blend_x(q1, Y.dp, Y.fp), Z.f);
    t.ym = lerp(blend_x(q0, Y.dm, Y.fm), blend_x(q1, Y.dm, Y.fm), Z.f);
  } else {
    t.yp = z_sample(v, zp, to_sample(a, {p.x, p.y + a.gstep[1], p.z}));
    t.ym = z_sample(v, zp, to_sample(a, {p.x, p.y - a.gstep[1], p.z}));
  }
  if (Z.near) {
    // the y blend of each z slot, then the z blend with the tap's weight
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = lerp(lz[0][k], lz[1][k], Y.f);
    t.zp = blend_x(q, Z.dp, Z.fp);
    t.zm = blend_x(q, Z.dm, Z.fm);
  } else {
    t.zp = z_sample(v, zp, to_sample(a, {p.x, p.y, p.z + a.gstep[2]}));
    t.zm = z_sample(v, zp, to_sample(a, {p.x, p.y, p.z - a.gstep[2]}));
  }
  return t;
}

// acos of the normalized dot product, pi/2 for near-zero-length inputs,
// the ratio clamped to [-1, 1].
__device__ __forceinline__ float angle(V3 a, V3 b) {
  const float d2 = dot(a, a) * dot(b, b);
  float ratio = 0.0f;
  if (d2 > kAngleDenomEps * kAngleDenomEps) ratio = dot(a, b) * rsqrtf(d2);
  return acosf(fminf(fmaxf(ratio, -1.0f), 1.0f));
}

// Illumination summed over the lights (ops/raymarch_core.py:shade_from_taps)
// for the emission gradient g at p: K4, K5 and the lit z-brick phase 2.
__device__ __forceinline__ V3 shade(const MarchArgs& a, V3 p, V3 g, V3 origin, float re, float fr,
                                    V3 color) {
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

// The eye ray of pixel (px, py) of the band, image row row0 + py
// (ops/geometry.py:generate_rays: only xVec is renormalized), clipped to
// the box (intersect_box, the reference's cascade). False when the ray
// misses the box. v is computed from the image row over the image's
// height, so a band's ray is the whole image's, bit for bit.
__device__ __forceinline__ bool make_ray(const MarchArgs& a, int px, int py, V3& origin, V3& dir,
                                         float& tnear, float& tfar) {
  const float* R = a.rotation;
  const V3 xv = {__ldg(R + 0), __ldg(R + 3), __ldg(R + 6)};
  const V3 yv = {__ldg(R + 1), __ldg(R + 4), __ldg(R + 7)};
  const V3 zv = {__ldg(R + 2), __ldg(R + 5), __ldg(R + 8)};
  const float u = (float)px / (float)a.width * 2.0f - 1.0f;
  const float v = (float)(a.row0 + py) / (float)a.image_height * 2.0f * a.ratio - a.ratio;
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
