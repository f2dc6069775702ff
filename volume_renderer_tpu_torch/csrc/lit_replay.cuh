// lit_replay.cuh: the lit replay of one sample and its adjoint.
//
// What the lit backward kernels share: lit K2 and K6 (march_bwd.cu), which
// replay a whole ray over whole volumes, and the lit z-brick gradient segment
// (brick_bwd.cu), which replays the samples one brick owns over its
// halo-padded z-windows. A volume's placement along z (WholeZ or ZSlab,
// march_common.cuh and corner_carry.cuh) is the one thing that differs: the
// sample's fetches, its shading chain and its scatters are the same code, so
// the brick segment's arithmetic is K6's, rounding for rounding.
//
// The emission gradient that shades a sample comes from the six emission
// taps (on-the-fly, K4's step) or, LOOKUP, from the three gradient volumes
// (K5's step: each fetched at its own corners, or with PACKED one cell of
// the float4 grid that packs emission and the three, fetch_packed). K2L
// reads absorption and reflection at that cell too, where both are of
// emission's shape (PAIR_IN): one float2 grid that the wrapper packs for the
// call (ops/cuda_grads.py, pack_lookup_pair), as unlit K2 reads emission and
// absorption from its pair (pack_pair).
//
// Per sample, given the pixel cotangent g, the saved image's g . out and the
// carried prefix = sum T (g . s) and opacity:
//   d s     = g T
//   d alpha = -(g . out - prefix) / (1 - alpha)      (0 where alpha = 1)
// and the closed-form adjoint of the step: the shading chain backwards per
// light (d shade -> d LUT coordinates -> d angles -> d normal -> d gradient),
// the gradient's cotangent to the six emission taps, scattered through the
// window's adjoint (scatter_em_taps), or LOOKUP to the three gradient
// volumes at their own corners (scatter; the lookup gradient is the sampled
// value itself, no tap difference); emission's own cotangent at its 8
// corners (LOOKUP; with PACKED the four cotangents of the pack's cell as
// one float4 a corner into an accumulator of the pack's layout,
// scatter_packed), absorption and reflection at their own (scatter; beside
// the pack, where both have emission's shape, as one float2 at emission's
// cell, PAIRED); and
// the per-ray sums of the transfer parameters:
//   E   = sum T alpha em          -> factor_emission, color
//   F   = sum d absorption * ab   -> factor_absorption
//   rac = sum d reflection * re   -> factor_reflection
//   P   = sum (d illuminated)_c * contrib_l, per light in shared memory
//                                 -> light_colors, color
#pragma once

#include "corner_carry.cuh"

namespace {

constexpr float kAnglePoleEps = 1e-6f;
constexpr float kAngleFloor = 1e-6f;

// Register caps of the kernels that replay lit samples (__maxnreg__), in
// march_bwd.cu and brick_bwd.cu alike. kLitMaxRegisters: K6's, K6L's and
// the lit and lookup gradient segments'; at 168 a 16x8 block takes 21504
// registers, and an SM holds three. kUnpackedMaxRegisters: the lookup
// forms whose gradient volumes have another shape than emission's, each
// fetched at its own corners; ptxas spilled 12 bytes in some of them under
// 168, under K2's launch bounds (128) and with caps of 176-216, none at
// 232 (nvcc 12.9 for sm_90a, one build a cap); at 232 a 16x8 block takes
// 29696 registers, and an SM holds two, a block fewer than at 168.
constexpr int kLitMaxRegisters = 168;
constexpr int kUnpackedMaxRegisters = 232;

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

// v itself, as a value the compiler cannot prove equal to v: what is
// computed from it is computed again instead of kept live in registers.
__device__ __forceinline__ V3 opaque(V3 v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(v.x), "+f"(v.y), "+f"(v.z));
#endif
  return v;
}

// Trilinear fetch with its derivatives by the normalized coordinates: the
// lerp differences times the axis length (u = c * n - 0.5). A clamped
// corner pair is one texel twice, so the derivative vanishes at an edge.
__device__ __forceinline__ float sample_grad(const Vol& v, float cx, float cy, float cz,
                                             V3& d) {
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
  const float dx0 = (c100 - c000) + fy * ((c110 - c010) - (c100 - c000));
  const float dx1 = (c101 - c001) + fy * ((c111 - c011) - (c101 - c001));
  const float dy0 = c10 - c00, dy1 = c11 - c01;
  d.x = (dx0 + fz * (dx1 - dx0)) * (float)v.w;
  d.y = (dy0 + fz * (dy1 - dy0)) * (float)v.h;
  d.z = (c1 - c0) * (float)v.d;
  return c0 + fz * (c1 - c0);
}

// Adjoint of z_sample(): adds d times the 8 trilinear weights at the 8
// clamped corners, z placed as zp says. A sample clamped at an edge sends
// both corners' weights to the one edge voxel.
template <class ZP = WholeZ>
__device__ __forceinline__ void scatter(float* grid, const Vol& v, V3 c, float d, ZP zp = ZP()) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = corner(c.x, v.w, x0, x1);
  const float fy = corner(c.y, v.h, y0, y1);
  const float fz = z_corner(v, zp, c.z, z0, z1);
  const size_t sy = (size_t)v.w;
  const size_t sz = (size_t)v.w * (size_t)v.h;
  const float gx0 = 1.0f - fx, gy0 = 1.0f - fy, gz0 = 1.0f - fz;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  atomicAdd(grid + x0 + r00, gx0 * gy0 * gz0 * d);
  atomicAdd(grid + x1 + r00, fx * gy0 * gz0 * d);
  atomicAdd(grid + x0 + r10, gx0 * fy * gz0 * d);
  atomicAdd(grid + x1 + r10, fx * fy * gz0 * d);
  atomicAdd(grid + x0 + r01, gx0 * gy0 * fz * d);
  atomicAdd(grid + x1 + r01, fx * gy0 * fz * d);
  atomicAdd(grid + x0 + r11, gx0 * fy * fz * d);
  atomicAdd(grid + x1 + r11, fx * fy * fz * d);
}

// The centre's weights c and the taps' t = (plus - minus) by window slot
// along one near axis (march_common.cuh: the plus tap's pair is at slots
// 1 + dp, 2 + dp, the minus tap's at 1 + dm, 2 + dm).
__device__ __forceinline__ void slot_weights(const TapAxis& w, float (&c)[4], float (&t)[4]) {
  c[0] = 0.0f;
  c[1] = 1.0f - w.f;
  c[2] = w.f;
  c[3] = 0.0f;
  const bool m0 = w.dm < 0, p0 = w.dp == 0;
  t[0] = m0 ? -(1.0f - w.fm) : 0.0f;
  t[1] = (p0 ? 1.0f - w.fp : 0.0f) - (m0 ? w.fm : 1.0f - w.fm);
  t[2] = (p0 ? w.fp : 1.0f - w.fp) - (m0 ? 0.0f : w.fm);
  t[3] = p0 ? 0.0f : w.fp;
}

// Adjoint of fetch_em_taps for the cotangent d_c of the centre and
// h = (d xp, d yp, d zp) of the taps (d xm = -h.x, ...): per window voxel
// (kx, ky, kz) the total
//   d_c cx cy cz + h.x tx cy cz + h.y cx ty cz + h.z cx cy tz
// goes into one atomic add, instead of one per tap and corner: one for each
// voxel fetch_em_taps loads (20 at half-voxel offsets), against 56. The taps
// of a far axis scatter on their own, as the adjoint of their own sample().
// Rows are placed along z by zp, as fetch_em_taps places them.
template <class ZP = WholeZ>
__device__ __forceinline__ void scatter_em_taps(float* grid, const MarchArgs& a, V3 p,
                                                const TapGeom& g, float d_c, V3 h,
                                                ZP zp = ZP()) {
  const Vol& v = a.em;
  const TapAxis &X = g.x, &Y = g.y, &Z = g.z;
  float cx[4], cy[4], cz[4], tx[4], ty[4], tz[4];
  slot_weights(X, cx, tx);
  slot_weights(Y, cy, ty);
  slot_weights(Z, cz, tz);
  const float hx = X.near ? h.x : 0.0f, hy = Y.near ? h.y : 0.0f, hz = Z.near ? h.z : 0.0f;
  const int xs[4] = {clamp_index(X.i - 1, v.w), clamp_index(X.i, v.w), clamp_index(X.i + 1, v.w),
                     clamp_index(X.i + 2, v.w)};
  const bool need_x[4] = {X.slot0(), true, true, X.slot3()};
  // the centre's rows (y, z slots 1, 2): every term
#pragma unroll
  for (int ky = 1; ky < 3; ++ky) {
#pragma unroll
    for (int kz = 1; kz < 3; ++kz) {
      float* row = grid + row_offset(v, zp, Y.i - 1 + ky, Z.i - 1 + kz);
      const float rc = cy[ky] * cz[kz];
      const float ryz = hy * ty[ky] * cz[kz] + hz * cy[ky] * tz[kz];
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const float total = rc * (d_c * cx[kx] + hx * tx[kx]) + cx[kx] * ryz;
        if (need_x[kx] && total != 0.0f) atomicAdd(row + xs[kx], total);
      }
    }
  }
  // y slots 0 and 3 (the y taps alone), z slots 0 and 3 (the z taps alone),
  // at x slots 1, 2
  const bool need_y[2] = {Y.slot0(), Y.slot3()}, need_z[2] = {Z.slot0(), Z.slot3()};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = 3 * e;
#pragma unroll
    for (int j = 1; j < 3; ++j) {
      if (need_y[e]) {
        float* row = grid + row_offset(v, zp, Y.i - 1 + k, Z.i - 1 + j);
        const float w = hy * ty[k] * cz[j];
#pragma unroll
        for (int kx = 1; kx < 3; ++kx) {
          const float total = cx[kx] * w;
          if (total != 0.0f) atomicAdd(row + xs[kx], total);
        }
      }
      if (need_z[e]) {
        float* row = grid + row_offset(v, zp, Y.i - 1 + j, Z.i - 1 + k);
        const float w = cy[j] * (hz * tz[k]);
#pragma unroll
        for (int kx = 1; kx < 3; ++kx) {
          const float total = cx[kx] * w;
          if (total != 0.0f) atomicAdd(row + xs[kx], total);
        }
      }
    }
  }
  if (!X.near) {
    scatter(grid, v, to_sample(a, {p.x + a.gstep[0], p.y, p.z}), h.x, zp);
    scatter(grid, v, to_sample(a, {p.x - a.gstep[0], p.y, p.z}), -h.x, zp);
  }
  if (!Y.near) {
    scatter(grid, v, to_sample(a, {p.x, p.y + a.gstep[1], p.z}), h.y, zp);
    scatter(grid, v, to_sample(a, {p.x, p.y - a.gstep[1], p.z}), -h.y, zp);
  }
  if (!Z.near) {
    scatter(grid, v, to_sample(a, {p.x, p.y, p.z + a.gstep[2]}), h.z, zp);
    scatter(grid, v, to_sample(a, {p.x, p.y, p.z - a.gstep[2]}), -h.z, zp);
  }
}

// Adjoint of angle() (ops/vjp.py:angle_backward): the cotangents of a and b
// for the cotangent d_ang of the angle.
__device__ __forceinline__ void angle_bwd(V3 a, V3 b, float d_ang, bool floor_, V3& da, V3& db) {
  const float a2 = dot(a, a), b2 = dot(b, b);
  const float d2 = a2 * b2;
  const bool safe_d = d2 > kAngleDenomEps * kAngleDenomEps;
  const float inv = safe_d ? rsqrtf(d2) : 0.0f;
  const float r = fminf(fmaxf(safe_d ? dot(a, b) * inv : 0.0f, -1.0f), 1.0f);
  const float s2 = 1.0f - r * r;
  float d_acos = 0.0f;
  if (floor_) {
    if (safe_d) d_acos = -rsqrtf(fmaxf(s2, kAngleFloor));
  } else {
    if (safe_d && fabsf(r) < 1.0f - kAnglePoleEps) d_acos = -rsqrtf(s2);
  }
  const float d_r = d_acos * d_ang;
  const float ra = r * (safe_d ? 1.0f / a2 : 0.0f);
  const float rb = r * (safe_d ? 1.0f / b2 : 0.0f);
  da = {d_r * (b.x * inv - ra * a.x), d_r * (b.y * inv - ra * a.y), d_r * (b.z * inv - ra * a.z)};
  db = {d_r * (a.x * inv - rb * b.x), d_r * (a.y * inv - rb * b.y), d_r * (a.z * inv - rb * b.z)};
}

__device__ __forceinline__ float4 scaled(float4 c, float w) {
  return make_float4(w * c.x, w * c.y, w * c.z, w * c.w);
}
__device__ __forceinline__ float2 scaled(float2 c, float w) {
  return make_float2(w * c.x, w * c.y);
}

// Adjoint of fetch_packed: each channel of c times the 8 trilinear weights of
// cell k into acc, a float32 accumulator of several volumes' cotangents, of
// shape v by the channels and placed as zp places it, x fastest: one vector
// reduction a corner (atomicAdd on a float4 or a float2, red.global.add.v4.f32
// or .v2.f32, which compute capability 9.x has for global memory), 8 a
// sample where the grids took 8 scalar adds each. x0 and x1 are neighbours,
// so a row pair of a float4 accumulator reaches at most two 32-byte sectors,
// of a float2 one at most two as well, mostly one.
// - T float4, a lookup replay's pack (D, H, W, 4) of emission's and the
//   three gradient volumes' cotangents, laid out as K5's pack: 8 float4
//   reductions a sample for 32 scalar adds;
// - T float2, its pair (D, H, W, 2) of absorption's and reflection's, both
//   of emission's shape and neither aliased, at emission's cell: 8 float2
//   reductions a sample for 16 scalar adds.
template <class T, class ZP>
__device__ __forceinline__ void scatter_packed(T* acc, const Vol& v, const Cell& k, T c,
                                               ZP zp) {
  const int x0 = clamp_index(k.x, v.w), x1 = clamp_index(k.x + 1, v.w);
  const int y0 = clamp_index(k.y, v.h), y1 = clamp_index(k.y + 1, v.h);
  const int z0 = corner_row(k.z, v, zp), z1 = corner_row(k.z + 1, v, zp);
  const size_t sy = (size_t)v.w;
  const size_t sz = (size_t)v.w * (size_t)v.h;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  const size_t off[8] = {x0 + r00, x1 + r00, x0 + r10, x1 + r10,
                         x0 + r01, x1 + r01, x0 + r11, x1 + r11};
  float w[8];
  corner_weights(k, w);
#pragma unroll
  for (int j = 0; j < 8; ++j) atomicAdd(acc + off[j], scaled(c, w[j]));
}

// The gradient grids a lit replay scatters into; null where the role is
// aliased to emission (its cotangent is added to emission's), where the
// replay does not scatter (lit K2), or, for the gradient volumes' (gx, gy,
// gz), without lookup gradients. With lookup gradients read from the pack,
// emission's and the gradient volumes' cotangents go into pack, the float4
// accumulator of the pack's layout, instead of em, gx, gy and gz; PAIRED,
// absorption's and reflection's into pair, the float2 accumulator of
// emission's shape, instead of ab and re.
struct LitGrids {
  float *em, *ab, *re, *gx, *gy, *gz;
  float4* pack;
  float2* pair;
};

// Where each grid a lit replay reads lies along z: all WholeZ for the
// single-device kernels, the brick's ZSlab windows for the gradient segment.
template <class ZP>
struct LitPlaces {
  ZP em, ab, re, gx, gy, gz;
};

// What a lit replay reads once a ray: the transfer settings, and whether the
// angle adjoint floors 1 - r^2 (the kernels' convention) or is zero at the
// poles (autograd's).
struct LitConsts {
  float fe, fa, fr, tstep;
  V3 color;
  bool floor_;
};

__device__ __forceinline__ LitConsts lit_consts(const MarchArgs& a, bool floor_) {
  const float* st = a.settings;
  return {__ldg(st + 0), __ldg(st + 1), __ldg(st + 2), a.tstep,
          {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)}, floor_};
}

// What a lit replay carries along a ray.
struct LitRay {
  V3 origin, g;                   // the eye point and the pixel cotangent
  float total_dot;                // g . out, the saved image's pixel
  float prefix;                   // sum T (g . s) of the samples before
  float acc_e, acc_f, acc_rac;    // the per-ray sums E, F and rac
};

// Replays the sample at position p (s = to_sample(a, p)) that a ray takes
// with the opacity sw carried into it, adds its adjoint (the grids with
// SCATTER, the per-ray sums in r, the per-light sums at sums[k * stride],
// k = 3 l + c), and updates sw past it. z places every grid along z. LOOKUP:
// the gradient volumes shade the sample, from a.packed with PACKED (the
// four volumes of one shape, emission's). PAIRED: absorption and reflection,
// of emission's shape and place, scatter as one float2 at emission's cell.
// PAIR_IN (K2L): absorption and reflection, of emission's shape and place,
// are read from pair, their (D, H, W, 2) grid, at the pack's cell: one
// 8-byte load a corner and no cell of their own, where sampling each
// volume makes 8 four-byte loads at a cell it computes itself. Each
// channel is blended as sample() blends its volume, so both are the same
// floats.
template <bool SCATTER, bool LOOKUP, bool PACKED, bool AB_ALIASED, bool RE_ALIASED,
          bool PAIRED, bool PAIR_IN = false, class ZP>
__device__ __forceinline__ void lit_replay_sample(const MarchArgs& a, const LitConsts& c,
                                                  const LitGrids& d, const LitPlaces<ZP>& z,
                                                  V3 p, V3 s, float& sw, LitRay& r,
                                                  float* sums, int stride,
                                                  const Vol2& pair = Vol2{}) {
  static_assert(LOOKUP || !PACKED, "only the lookup gradient volumes are packed");
  static_assert(!PAIRED || (PACKED && !AB_ALIASED && !RE_ALIASED),
                "absorption and reflection pair beside the pack, neither aliased");
  static_assert(!PAIR_IN || (PACKED && !SCATTER && !AB_ALIASED && !RE_ALIASED),
                "K2L reads absorption and reflection as a pair beside the pack, neither aliased");
  const float fe = c.fe, fa = c.fa, fr = c.fr, tstep = c.tstep;
  const V3 color = c.color, g = r.g, origin = r.origin;
  // ---- the step's forward values, as march_fwd.cu has them ----
  float em, ab_in = 0.0f, re_in = 0.0f;  // ab_in, re_in: PAIR_IN's
  V3 grad;
  if constexpr (LOOKUP && PACKED) {
    const Cell k = cell_of(a.em, as_slab(a.em, z.em), s);
    const float4 q = fetch_packed(a.packed, k, z.em);
    em = q.x;
    grad = {q.y, q.z, q.w};
    if constexpr (PAIR_IN) {
      const float2 w = fetch_packed2(pair, k, z.em);
      ab_in = w.x;
      re_in = w.y;
    }
  } else if constexpr (LOOKUP) {
    em = z_sample(a.em, z.em, s);
    grad = {z_sample(a.gx, z.gx, s), z_sample(a.gy, z.gy, s), z_sample(a.gz, z.gz, s)};
  } else {
    const EmTaps e = fetch_em_taps(a, p, tap_geom(a, p, s, z.em), z.em);
    em = e.c;
    grad = {(e.xp - e.xm) * 0.5f, (e.yp - e.ym) * 0.5f, (e.zp - e.zm) * 0.5f};
  }
  const float ab = PAIR_IN ? ab_in : AB_ALIASED ? em : z_sample(a.ab, z.ab, s);
  const float emission = fe * em;
  const float absorption = fa * ab;
  const float transmit = expf(-absorption * tstep);
  const float alpha = 1.0f - transmit;
  V3 illum = {emission * tstep * color.x, emission * tstep * color.y,
              emission * tstep * color.z};
  const float tw = 1.0f - sw;
  const V3 d_s = scale(g, tw);
  const V3 d_illum = scale(d_s, alpha);

  float d_refl = 0.0f;
  V3 d_grad = {0.0f, 0.0f, 0.0f};
  {
    const float re = PAIR_IN ? re_in : RE_ALIASED ? em : z_sample(a.re, z.re, s);
    const float g2 = dot(grad, grad);
    const float inv = g2 > kGradEps2 ? rsqrtf(g2) : 0.0f;
    const V3 n = {grad.x * -inv, grad.y * -inv, grad.z * -inv};
    const float reflection = fr * re;
    const V3 light_in = sub(origin, p);
    const float d_in = dot(light_in, n);
    const V3 in_proj = {light_in.x - n.x * d_in, light_in.y - n.y * d_in,
                        light_in.z - n.z * d_in};
    V3 d_n = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < a.n_lights; ++l) {
      const V3 lp = {__ldg(a.light_pos + 3 * l), __ldg(a.light_pos + 3 * l + 1),
                     __ldg(a.light_pos + 3 * l + 2)};
      const V3 lc = {__ldg(a.light_col + 3 * l), __ldg(a.light_col + 3 * l + 1),
                     __ldg(a.light_col + 3 * l + 2)};
      const V3 light_out = sub(lp, p);
      const float al = angle(n, light_in) / kPi;
      const float be = angle(n, light_out) / kPi;
      const float d_out = dot(light_out, n);
      const V3 out_proj = {light_out.x - n.x * d_out, light_out.y - n.y * d_out,
                           light_out.z - n.z * d_out};
      const float gam = angle(in_proj, out_proj) / kPi;
      V3 d_lut_c = {0.0f, 0.0f, 0.0f};
      const float lut = SCATTER ? sample_grad(a.lut, al, be, gam, d_lut_c)
                                : sample(a.lut, al, be, gam);
      const float contrib = reflection * lut;
      illum.x = illum.x + contrib * lc.x * color.x;
      illum.y = illum.y + contrib * lc.y * color.y;
      illum.z = illum.z + contrib * lc.z * color.z;

      float* sum = sums + 3 * l * stride;
      sum[0] += d_illum.x * contrib;
      sum[stride] += d_illum.y * contrib;
      sum[2 * stride] += d_illum.z * contrib;
      const float d_contrib = d_illum.x * lc.x * color.x + d_illum.y * lc.y * color.y +
                              d_illum.z * lc.z * color.z;
      d_refl = d_refl + d_contrib * lut;
      if (SCATTER) {
        // d lut -> d angles -> d normal; the tangent-plane projections
        // pull the third angle back to the normal too:
        // in_proj = light_in - (light_in . n) n  =>
        // d n -= (u . n) light_in + (light_in . n) u, likewise out
        const float d_lut = d_contrib * reflection;
        V3 d_a, d_b, u, v, unused;
        angle_bwd(n, light_in, d_lut * d_lut_c.x / kPi, c.floor_, d_a, unused);
        angle_bwd(n, light_out, d_lut * d_lut_c.y / kPi, c.floor_, d_b, unused);
        angle_bwd(in_proj, out_proj, d_lut * d_lut_c.z / kPi, c.floor_, u, v);
        const float un = dot(u, n), vn = dot(v, n);
        d_n.x = d_n.x + d_a.x + d_b.x - light_in.x * un - u.x * d_in - light_out.x * vn -
                v.x * d_out;
        d_n.y = d_n.y + d_a.y + d_b.y - light_in.y * un - u.y * d_in - light_out.y * vn -
                v.y * d_out;
        d_n.z = d_n.z + d_a.z + d_b.z - light_in.z * un - u.z * d_in - light_out.z * vn -
                v.z * d_out;
      }
    }
    r.acc_rac = r.acc_rac + d_refl * re;
    if (SCATTER) {
      // n = -grad / |grad|
      const float k = dot(d_n, grad) * inv * inv * inv;
      d_grad = {d_n.x * -inv + grad.x * k, d_n.y * -inv + grad.y * k,
                d_n.z * -inv + grad.z * k};
    }
  }

  // ---- cotangents of (s, alpha) from the under operator ----
  r.prefix = r.prefix + tw * (g.x * (illum.x * alpha) + g.y * (illum.y * alpha) +
                              g.z * (illum.z * alpha));
  const float one_m_a = 1.0f - alpha;
  const float d_alpha = one_m_a > 0.0f ? -(r.total_dot - r.prefix) / one_m_a : 0.0f;

  // ---- adjoint of the step ----
  const float d_absorption = (d_alpha + dot(d_s, illum)) * (transmit * tstep);
  r.acc_f = r.acc_f + d_absorption * ab;
  r.acc_e = r.acc_e + tw * alpha * em;
  if (SCATTER) {
    // the sample's coordinates (and window) are rebuilt from p here, not
    // kept live through the lights
    const V3 q = opaque(p);
    const V3 sq = to_sample(a, q);
    float d_at_em = dot(d_illum, color) * tstep * fe;
    const float d_ab = d_absorption * fa;
    if (AB_ALIASED) {
      d_at_em = d_at_em + d_ab;
    } else if (!PAIRED) {
      scatter(d.ab, a.ab, sq, d_ab, z.ab);
    }
    const float d_re = d_refl * fr;
    if (RE_ALIASED) {
      d_at_em = d_at_em + d_re;
    } else if (!PAIRED) {
      scatter(d.re, a.re, sq, d_re, z.re);
    }
    if constexpr (LOOKUP && PACKED) {
      const Cell k = cell_of(a.em, as_slab(a.em, z.em), sq);
      scatter_packed(d.pack, a.em, k, make_float4(d_at_em, d_grad.x, d_grad.y, d_grad.z), z.em);
      if constexpr (PAIRED) scatter_packed(d.pair, a.em, k, make_float2(d_ab, d_re), z.em);
    } else if constexpr (LOOKUP) {
      scatter(d.em, a.em, sq, d_at_em, z.em);
      scatter(d.gx, a.gx, sq, d_grad.x, z.gx);
      scatter(d.gy, a.gy, sq, d_grad.y, z.gy);
      scatter(d.gz, a.gz, sq, d_grad.z, z.gz);
    } else {
      scatter_em_taps(d.em, a, q, tap_geom(a, q, sq, z.em), d_at_em,
                      {d_grad.x * 0.5f, d_grad.y * 0.5f, d_grad.z * 0.5f}, z.em);
    }
  }

  sw = tw * alpha + sw;
}

}  // namespace
