// march_bwd.cu: the backward ray march for Hopper (sm_90a).
//
// Replaces the gradient modes of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688), launched by
// the pl.pallas_call at :1935 through _replay_grads_tiled (:2020) and
// _voxel_grads_tiled (:2031):
//   K2  grad_mode            march_bwd_kernel<LIT, SCATTER=false>
//   K3  scatter              march_bwd_scatter_kernel (unlit)
//   K6  scatter + lighting   march_bwd_lit_scatter_kernel
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
// Lit (on-the-fly gradients only), the shading chain runs backwards per
// light: d shade -> d LUT coordinates -> d angles -> d normal -> d six
// emission taps. The angle adjoint floors 1 - r^2 at 1e-6 when
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
// What the design does about it. A thread per ray; K2 in 16x16 blocks like
// the forward, K3 and K6 in 16x8 (a warp is two rows of 16 neighbouring
// rays, as in a 16x16 block; see their kernels), so the atomics of a warp
// fall into few cache lines. atomicAdd whose result is unused compiles to a
// reduction (RED) that does not wait for the old value.
// - K3 (march_bwd_scatter_kernel) computes a sample's cell once for both
//   grids where absorption has emission's shape, fetches both at its
//   corners, and carries the ray's pending corner sums in registers
//   (corner_carry.cuh, CornerCarry, as the K7 gradient segment does): a
//   corner goes out as one atomic add when the ray leaves it, about 2 a
//   sample for both grids instead of 16 (chip_smoke.py, march_flushes).
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

#include "corner_carry.cuh"

// Mirrored field for field by GradArgs in ops/cuda_grads.py.
struct GradArgs {
  MarchArgs m;         // out and steps are unused
  const float* g;      // (height, width, 3) pixel cotangent
  const float* image;  // (height, width, 3) the forward kernel's output
  float* d_em;         // zero-initialised gradient grids, SCATTER only;
  float* d_ab;         // null when the role is aliased to emission
  float* d_re;         // or unlit
  float* planes;       // (3 + 3 n_lights, height, width)
  int angle_floor;
};

namespace {

constexpr int kThreads = kBlock * kBlock;
constexpr float kAnglePoleEps = 1e-6f;
constexpr float kAngleFloor = 1e-6f;

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

// Adjoint of sample(): adds d times the 8 trilinear weights at the 8
// clamped corners. A sample clamped at an edge sends both corners' weights
// to the one edge voxel.
__device__ __forceinline__ void scatter(float* grid, const Vol& v, V3 c, float d) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = corner(c.x, v.w, x0, x1);
  const float fy = corner(c.y, v.h, y0, y1);
  const float fz = corner(c.z, v.d, z0, z1);
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
__device__ __forceinline__ void scatter_em_taps(float* grid, const MarchArgs& a, V3 p,
                                                const TapGeom& g, float d_c, V3 h) {
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
      float* row = grid + row_offset(v, Y.i - 1 + ky, Z.i - 1 + kz);
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
        float* row = grid + row_offset(v, Y.i - 1 + k, Z.i - 1 + j);
        const float w = hy * ty[k] * cz[j];
#pragma unroll
        for (int kx = 1; kx < 3; ++kx) {
          const float total = cx[kx] * w;
          if (total != 0.0f) atomicAdd(row + xs[kx], total);
        }
      }
      if (need_z[e]) {
        float* row = grid + row_offset(v, Y.i - 1 + j, Z.i - 1 + k);
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
    scatter(grid, v, to_sample(a, {p.x + a.gstep[0], p.y, p.z}), h.x);
    scatter(grid, v, to_sample(a, {p.x - a.gstep[0], p.y, p.z}), -h.x);
  }
  if (!Y.near) {
    scatter(grid, v, to_sample(a, {p.x, p.y + a.gstep[1], p.z}), h.y);
    scatter(grid, v, to_sample(a, {p.x, p.y - a.gstep[1], p.z}), -h.y);
  }
  if (!Z.near) {
    scatter(grid, v, to_sample(a, {p.x, p.y, p.z + a.gstep[2]}), h.z);
    scatter(grid, v, to_sample(a, {p.x, p.y, p.z - a.gstep[2]}), -h.z);
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

// The backward march of one ray: the pixel of this thread of a COLS x ROWS
// block.
template <bool LIT, bool SCATTER, bool AB_ALIASED, bool RE_ALIASED, int COLS, int ROWS>
__device__ __forceinline__ void march_bwd_ray(const GradArgs& ga) {
  constexpr int kT = COLS * ROWS;
  extern __shared__ float light_sums[];  // [3 n_lights][kT], a column per thread
  const MarchArgs& a = ga.m;
  const int px = blockIdx.x * COLS + threadIdx.x;
  const int py = blockIdx.y * ROWS + threadIdx.y;
  if (px >= a.width || py >= a.height) return;
  const int tid = threadIdx.y * COLS + threadIdx.x;
  const int n_lights = LIT ? a.n_lights : 0;
  for (int k = 0; k < 3 * n_lights; ++k) light_sums[k * kT + tid] = 0.0f;

  V3 origin, dir;
  float tnear, tfar;
  const bool hit = make_ray(a, px, py, origin, dir, tnear, tfar);

  const float* st = a.settings;
  const float fe = __ldg(st + 0), fa = __ldg(st + 1), fr = __ldg(st + 2);
  const V3 color = {__ldg(st + 3), __ldg(st + 4), __ldg(st + 5)};
  const float threshold = __ldg(st + 6);
  const float tstep = a.tstep;
  const bool floor_ = ga.angle_floor != 0;

  const size_t pix = (size_t)py * a.width + px;
  const V3 g = {__ldg(ga.g + 3 * pix), __ldg(ga.g + 3 * pix + 1), __ldg(ga.g + 3 * pix + 2)};
  const V3 out = {__ldg(ga.image + 3 * pix), __ldg(ga.image + 3 * pix + 1),
                  __ldg(ga.image + 3 * pix + 2)};
  const float total_dot = dot(g, out);

  float acc_e = 0.0f, acc_f = 0.0f, acc_rac = 0.0f;
  if (hit && !(g.x == 0.0f && g.y == 0.0f && g.z == 0.0f)) {
    float sw = 0.0f, prefix = 0.0f;
    float t = tnear;
    V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
    const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
    for (int i = 0; i < a.n_steps; ++i) {
      // ---- the step's forward values, as march_fwd.cu has them ----
      const V3 s = to_sample(a, p);
      float em;
      V3 grad = {0.0f, 0.0f, 0.0f};
      if (LIT) {
        const EmTaps e = fetch_em_taps(a, p, tap_geom(a, p, s));
        em = e.c;
        grad = {(e.xp - e.xm) * 0.5f, (e.yp - e.ym) * 0.5f, (e.zp - e.zm) * 0.5f};
      } else {
        em = sample(a.em, s);
      }
      const float ab = AB_ALIASED ? em : sample(a.ab, s);
      const float emission = fe * em;
      const float absorption = fa * ab;
      const float transmit = expf(-absorption * tstep);
      const float alpha = 1.0f - transmit;
      V3 illum = {emission * tstep * color.x, emission * tstep * color.y,
                  emission * tstep * color.z};
      const float tw = 1.0f - sw;
      const V3 d_s = scale(g, tw);
      const V3 d_illum = scale(d_s, alpha);

      float re = 0.0f, d_refl = 0.0f;
      V3 d_grad = {0.0f, 0.0f, 0.0f};
      if (LIT) {
        re = RE_ALIASED ? em : sample(a.re, s);
        const float g2 = dot(grad, grad);
        const float inv = g2 > kGradEps2 ? rsqrtf(g2) : 0.0f;
        const V3 n = {grad.x * -inv, grad.y * -inv, grad.z * -inv};
        const float reflection = fr * re;
        const V3 light_in = sub(origin, p);
        const float d_in = dot(light_in, n);
        const V3 in_proj = {light_in.x - n.x * d_in, light_in.y - n.y * d_in,
                            light_in.z - n.z * d_in};
        V3 d_n = {0.0f, 0.0f, 0.0f};
        for (int l = 0; l < n_lights; ++l) {
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

          float* sums = light_sums + 3 * l * kT + tid;
          sums[0] += d_illum.x * contrib;
          sums[kT] += d_illum.y * contrib;
          sums[2 * kT] += d_illum.z * contrib;
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
            angle_bwd(n, light_in, d_lut * d_lut_c.x / kPi, floor_, d_a, unused);
            angle_bwd(n, light_out, d_lut * d_lut_c.y / kPi, floor_, d_b, unused);
            angle_bwd(in_proj, out_proj, d_lut * d_lut_c.z / kPi, floor_, u, v);
            const float un = dot(u, n), vn = dot(v, n);
            d_n.x = d_n.x + d_a.x + d_b.x - light_in.x * un - u.x * d_in - light_out.x * vn -
                    v.x * d_out;
            d_n.y = d_n.y + d_a.y + d_b.y - light_in.y * un - u.y * d_in - light_out.y * vn -
                    v.y * d_out;
            d_n.z = d_n.z + d_a.z + d_b.z - light_in.z * un - u.z * d_in - light_out.z * vn -
                    v.z * d_out;
          }
        }
        acc_rac = acc_rac + d_refl * re;
        if (SCATTER) {
          // n = -grad / |grad|
          const float k = dot(d_n, grad) * inv * inv * inv;
          d_grad = {d_n.x * -inv + grad.x * k, d_n.y * -inv + grad.y * k,
                    d_n.z * -inv + grad.z * k};
        }
      }

      // ---- cotangents of (s, alpha) from the under operator ----
      prefix = prefix + tw * (g.x * (illum.x * alpha) + g.y * (illum.y * alpha) +
                              g.z * (illum.z * alpha));
      const float one_m_a = 1.0f - alpha;
      const float d_alpha = one_m_a > 0.0f ? -(total_dot - prefix) / one_m_a : 0.0f;

      // ---- adjoint of the step ----
      const float d_absorption = (d_alpha + dot(d_s, illum)) * (transmit * tstep);
      acc_f = acc_f + d_absorption * ab;
      acc_e = acc_e + tw * alpha * em;
      if (SCATTER) {
        // lit, the sample's coordinates and window are rebuilt from p here,
        // not kept live through the lights
        const V3 q = LIT ? opaque(p) : p;
        const V3 sq = LIT ? to_sample(a, q) : s;
        float d_at_em = dot(d_illum, color) * tstep * fe;
        const float d_ab = d_absorption * fa;
        if (AB_ALIASED) {
          d_at_em = d_at_em + d_ab;
        } else {
          scatter(ga.d_ab, a.ab, sq, d_ab);
        }
        if (LIT) {
          const float d_re = d_refl * fr;
          if (RE_ALIASED) {
            d_at_em = d_at_em + d_re;
          } else {
            scatter(ga.d_re, a.re, sq, d_re);
          }
          scatter_em_taps(ga.d_em, a, q, tap_geom(a, q, sq), d_at_em,
                          {d_grad.x * 0.5f, d_grad.y * 0.5f, d_grad.z * 0.5f});
        } else {
          scatter(ga.d_em, a.em, s, d_at_em);
        }
      }

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
  ga.planes[2 * plane + pix] = acc_rac;
  for (int k = 0; k < 3 * n_lights; ++k) {
    ga.planes[(3 + k) * plane + pix] = light_sums[k * kT + tid];
  }
}

template <bool LIT, bool SCATTER, bool AB_ALIASED, bool RE_ALIASED>
__global__ void __launch_bounds__(kThreads) march_bwd_kernel(const GradArgs ga) {
  march_bwd_ray<LIT, SCATTER, AB_ALIASED, RE_ALIASED, kBlock, kBlock>(ga);
}

// K6 in a kernel of its own, in 16x8 blocks (a warp is two rows of 16
// neighbouring rays, as in a 16x16 block). It needs up to 174 registers
// without spilling; left to itself, ptxas held one variant (every role
// aliased) at 128 and spilled. Capped at 168 none spills, and an SM holds
// three of these blocks: 12 warps, where one 16x16 block gave 8. Capped at
// 128 (16 warps) every K6 variant spilled and ran slower in trial builds.
constexpr int kMaxRegisters = 168;
constexpr int kK6Cols = 16, kK6Rows = 8;

template <bool AB_ALIASED, bool RE_ALIASED>
__global__ void __maxnreg__(kMaxRegisters) march_bwd_lit_scatter_kernel(const GradArgs ga) {
  march_bwd_ray<true, true, AB_ALIASED, RE_ALIASED, kK6Cols, kK6Rows>(ga);
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

template <bool LIT, bool SCATTER, bool AB, bool RE>
cudaError_t launch(const GradArgs& ga, cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  constexpr int cols = LIT && SCATTER ? kK6Cols : kBlock, rows = LIT && SCATTER ? kK6Rows : kBlock;
  const dim3 block(cols, rows);
  const dim3 grid((a.width + cols - 1) / cols, (a.height + rows - 1) / rows);
  const size_t shared = LIT ? sizeof(float) * 3 * a.n_lights * cols * rows : 0;
  if constexpr (LIT && SCATTER) {
    march_bwd_lit_scatter_kernel<AB, RE><<<grid, block, shared, stream>>>(ga);
  } else {
    march_bwd_kernel<LIT, SCATTER, AB, RE><<<grid, block, shared, stream>>>(ga);
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

template <bool LIT, bool SCATTER>
cudaError_t launch_aliasing(const GradArgs& ga, bool ab_aliased, bool re_aliased,
                            cudaStream_t stream) {
  if (ab_aliased) {
    return (!LIT || re_aliased) ? launch<LIT, SCATTER, true, true>(ga, stream)
                                : launch<LIT, SCATTER, true, false>(ga, stream);
  }
  return (!LIT || re_aliased) ? launch<LIT, SCATTER, false, true>(ga, stream)
                              : launch<LIT, SCATTER, false, false>(ga, stream);
}

}  // namespace

extern "C" {

// Size of GradArgs, so that the Python side can check its mirror.
size_t vr_grad_args_size() { return sizeof(GradArgs); }

// The most lights a launch takes: their per-thread sums must fit the 48 KB
// of shared memory a block gets without opting in to more.
int vr_march_bwd_max_lights() { return (48 * 1024) / (int)(sizeof(float) * 3 * kThreads); }

// Launches the backward march on ``stream``; returns the launch's
// cudaError_t. lit: on-the-fly lighting; scatter: also the voxel grids
// (K3 unlit, K6 lit), else only the per-ray planes (K2).
int vr_march_bwd(const GradArgs* args, int lit, int scatter, int ab_aliased, int re_aliased,
                 void* stream) {
  const GradArgs& ga = *args;
  if (ga.m.width <= 0 || ga.m.height <= 0) return (int)cudaSuccess;
  if (lit && ga.m.n_lights > vr_march_bwd_max_lights()) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lit) {
    return (int)(scatter ? launch_aliasing<true, true>(ga, ab_aliased, re_aliased, s)
                         : launch_aliasing<true, false>(ga, ab_aliased, re_aliased, s));
  }
  return (int)(scatter ? launch_unlit_scatter(ga, ab_aliased, s)
                       : launch_aliasing<false, false>(ga, ab_aliased, re_aliased, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
