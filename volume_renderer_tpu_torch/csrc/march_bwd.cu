// march_bwd.cu: the backward ray march for Hopper (sm_90a).
//
// Replaces the gradient modes of the TPU kernel
// volume_renderer_tpu/ops/pallas_march.py:_march_kernel (:688), launched by
// the pl.pallas_call at :1935 through _replay_grads_tiled (:2020) and
// _voxel_grads_tiled (:2031):
//   K2  grad_mode            march_bwd<LIT, SCATTER=false>
//   K3  scatter              march_bwd<LIT=false, SCATTER=true>
//   K6  scatter + lighting   march_bwd<LIT=true, SCATTER=true>
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
// What bounds it on this card. Per sample the scatter issues 8 float
// atomic adds per tap: 8 or 16 unlit, up to 72 lit, into grids of the
// volume's size, and the rays of neighbouring pixels hit the same voxels.
// The roofline counts float32 operations against the volumes read and the
// grids written once and calls it operation-bound; what it waits on is the
// latency of the gathers, as the forward does, and the throughput of the
// atomic units in L2.
//
// What the design does about it. A thread per ray in 16x16 blocks like the
// forward, so the atomics of a warp fall into few cache lines. atomicAdd
// whose result is unused compiles to a reduction (RED) that does not wait
// for the old value. Nothing of the TPU design is carried over: the one-hot
// matmul scatter, the read-modify-write windows, the overflow ladder and
// the sweep axis stood in for atomics. The per-light sums live in shared
// memory, one private column per thread, so the number of lights is not a
// compile-time constant. A ray whose cotangent is zero is skipped: all it
// could add is zero.
//
// Atomic adds land in no fixed order, so the grids differ from run to run
// in the last bits. Build flags as for march_fwd.cu (-fmad=false, no fast
// math). Plain C interface, loaded with ctypes (ops/cuda_grads.py).

#include "march_common.cuh"

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

template <bool LIT, bool SCATTER, bool AB_ALIASED, bool RE_ALIASED>
__global__ void __launch_bounds__(kThreads) march_bwd_kernel(const GradArgs ga) {
  extern __shared__ float light_sums[];  // [3 n_lights][kThreads], a column per thread
  const MarchArgs& a = ga.m;
  const int px = blockIdx.x * kBlock + threadIdx.x;
  const int py = blockIdx.y * kBlock + threadIdx.y;
  if (px >= a.width || py >= a.height) return;
  const int tid = threadIdx.y * kBlock + threadIdx.x;
  const int n_lights = LIT ? a.n_lights : 0;
  for (int k = 0; k < 3 * n_lights; ++k) light_sums[k * kThreads + tid] = 0.0f;

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
      const float em = sample(a.em, s);
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
      const float gs0 = a.gstep[0], gs1 = a.gstep[1], gs2 = a.gstep[2];
      if (LIT) {
        re = RE_ALIASED ? em : sample(a.re, s);
        const float xp = sample(a.em, to_sample(a, {p.x + gs0, p.y, p.z}));
        const float xm = sample(a.em, to_sample(a, {p.x - gs0, p.y, p.z}));
        const float yp = sample(a.em, to_sample(a, {p.x, p.y + gs1, p.z}));
        const float ym = sample(a.em, to_sample(a, {p.x, p.y - gs1, p.z}));
        const float zp = sample(a.em, to_sample(a, {p.x, p.y, p.z + gs2}));
        const float zm = sample(a.em, to_sample(a, {p.x, p.y, p.z - gs2}));
        const V3 grad = {(xp - xm) * 0.5f, (yp - ym) * 0.5f, (zp - zm) * 0.5f};
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

          float* sums = light_sums + 3 * l * kThreads + tid;
          sums[0] += d_illum.x * contrib;
          sums[kThreads] += d_illum.y * contrib;
          sums[2 * kThreads] += d_illum.z * contrib;
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
        float d_at_em = dot(d_illum, color) * tstep * fe;
        const float d_ab = d_absorption * fa;
        if (AB_ALIASED) {
          d_at_em = d_at_em + d_ab;
        } else {
          scatter(ga.d_ab, a.ab, s, d_ab);
        }
        if (LIT) {
          const float d_re = d_refl * fr;
          if (RE_ALIASED) {
            d_at_em = d_at_em + d_re;
          } else {
            scatter(ga.d_re, a.re, s, d_re);
          }
          scatter(ga.d_em, a.em, to_sample(a, {p.x + gs0, p.y, p.z}), d_grad.x * 0.5f);
          scatter(ga.d_em, a.em, to_sample(a, {p.x - gs0, p.y, p.z}), d_grad.x * -0.5f);
          scatter(ga.d_em, a.em, to_sample(a, {p.x, p.y + gs1, p.z}), d_grad.y * 0.5f);
          scatter(ga.d_em, a.em, to_sample(a, {p.x, p.y - gs1, p.z}), d_grad.y * -0.5f);
          scatter(ga.d_em, a.em, to_sample(a, {p.x, p.y, p.z + gs2}), d_grad.z * 0.5f);
          scatter(ga.d_em, a.em, to_sample(a, {p.x, p.y, p.z - gs2}), d_grad.z * -0.5f);
        }
        scatter(ga.d_em, a.em, s, d_at_em);
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
    ga.planes[(3 + k) * plane + pix] = light_sums[k * kThreads + tid];
  }
}

template <bool LIT, bool SCATTER, bool AB, bool RE>
cudaError_t launch(const GradArgs& ga, cudaStream_t stream) {
  const MarchArgs& a = ga.m;
  const dim3 block(kBlock, kBlock);
  const dim3 grid((a.width + kBlock - 1) / kBlock, (a.height + kBlock - 1) / kBlock);
  const size_t shared = LIT ? sizeof(float) * 3 * a.n_lights * kThreads : 0;
  march_bwd_kernel<LIT, SCATTER, AB, RE><<<grid, block, shared, stream>>>(ga);
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
  return (int)(scatter ? launch_aliasing<false, true>(ga, ab_aliased, re_aliased, s)
                       : launch_aliasing<false, false>(ga, ab_aliased, re_aliased, s));
}

const char* vr_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
