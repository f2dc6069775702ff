// brick_common.cuh: what the two z-brick kernels share.
//
// A brick holds rows [b * bd, (b + 1) * bd) of a volume plus two halo rows
// on each side, and marches the part of every ray that it owns. The ray is
// that of the whole box: positions advance from step 0 by accumulation, as
// march_fwd.cu advances them, so a sample has the same position in every
// brick and in the single-device march.
//
// Phase 1 walks each ray from step 0 to the first step that its brick owns
// (walk_to_brick) and stores there the ray's entry record: the step index,
// t and the accumulated position. Phase 2 and the gradient segment resume
// from that record (load_entry) and never walk: the positions are stored,
// not recomputed, so they stay bit-equal. ops/brick_march.py
// (BrickRays.walk, Entry) is the plain version of both, step for step.

#pragma once

#include "corner_carry.cuh"

// Mirrored field for field by _BrickArgs in ops/cuda_bricks.py.
struct BrickArgs {
  MarchArgs m;          // em, ab: the brick's halo-padded grids; out: its contribution
  int n_bricks, brick;  // B and b
  int em_d_global, em_z_off;  // depth of the whole volume; global row of the
  int ab_d_global, ab_z_off;  // grid's first padded row (0 for a depth-1 volume)
  const float* w_in;    // (height, width) entry opacity; null means zero
  float* w_out;         // (height, width) exit opacity
  int* entry_step;      // (height, width) the entry record: phase 1 writes it,
  float* entry_state;   // (height, width, 4) phase 2 and the gradient segment read it
  int re_d_global, re_z_off;  // lit: reflection's grid, and the gradient
  int gx_d_global, gx_z_off;  // volumes' (lookup), placed as em and ab
  int gy_d_global, gy_z_off;
  int gz_d_global, gz_z_off;
};

namespace {

// Whether grid v, whose first padded row is global row z_off of a volume of
// depth d_global, has the shape and place of the brick's emission grid: then
// it shares emission's cells (a sample's corners and weights).
__host__ __device__ __forceinline__ bool same_place(const Vol& v, int z_off, int d_global,
                                                    const BrickArgs& a) {
  return v.d == a.m.em.d && v.h == a.m.em.h && v.w == a.m.em.w && z_off == a.em_z_off &&
         d_global == a.em_d_global;
}

// The entry record of a ray in a brick: the first step i that the brick
// owns, with t and the position p there. i = -1: the ray misses the box or
// never reaches the brick.
struct Entry {
  int i;
  float t;
  V3 p;
};

// The owner of a sample at normalized z: clamp(floor(s.z * B), 0, B - 1),
// one expression that does not know b, so every sample has exactly one
// owner. Along a ray the owner is monotone.
__device__ __forceinline__ float owner_of(float sz, float nb) {
  return fminf(fmaxf(floorf(sz * nb), 0.0f), nb - 1.0f);
}

// Walks the ray of pixel (px, py) from step 0, without fetching, to the
// first step that brick a.brick owns. Returns its entry record (i = -1
// where the ray misses the box, moves away from the brick, passes tfar or
// runs out of steps first) and the ray's step and far end.
__device__ __forceinline__ Entry walk_to_brick(const BrickArgs& a, int px, int py, V3& step,
                                               float& tfar) {
  const MarchArgs& m = a.m;
  Entry e = {-1, 0.0f, {0.0f, 0.0f, 0.0f}};
  V3 origin, dir;
  float tnear;
  if (!make_ray(m, px, py, origin, dir, tnear, tfar)) return e;
  const float tstep = m.tstep;
  const float nb = (float)a.n_bricks, bf = (float)a.brick;
  float t = tnear;
  V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
  step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
  for (int i = 0; i < m.n_steps; ++i) {
    const float owner = owner_of(to_sample(m, p).z, nb);
    if (owner == bf) return {i, t, p};
    if (!((step.z > 0.0f && owner < bf) || (step.z < 0.0f && owner > bf))) return e;
    t = t + tstep;
    if (!(t <= tfar)) return e;
    p = {p.x + step.x, p.y + step.y, p.z + step.z};
  }
  return e;
}

// Phase 1 stores the record of pixel pix; phase 2 and the gradient segment
// read it back.
__device__ __forceinline__ void store_entry(const BrickArgs& a, size_t pix, const Entry& e) {
  a.entry_step[pix] = e.i;
  reinterpret_cast<float4*>(a.entry_state)[pix] = make_float4(e.t, e.p.x, e.p.y, e.p.z);
}

__device__ __forceinline__ Entry load_entry(const BrickArgs& a, size_t pix) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(a.entry_state) + pix);
  return {__ldg(a.entry_step + pix), s.x, {s.y, s.z, s.w}};
}

// Whether a ray that enters the brick with opacity sw composites anything:
// the first sample of a ray composites unconditionally, a later one only
// while sw <= threshold (the march's stop test, taken before the sample).
__device__ __forceinline__ bool enters(const Entry& e, float sw, float threshold) {
  return e.i == 0 || (e.i > 0 && sw <= threshold);
}

// The ray's step and far end, for a resume from its record: the set-up of
// walk_to_brick, float for float.
__device__ __forceinline__ void ray_step(const MarchArgs& m, int px, int py, V3& step,
                                         float& tfar) {
  V3 origin, dir;
  float tnear;
  make_ray(m, px, py, origin, dir, tnear, tfar);
  step = {dir.x * m.tstep, dir.y * m.tstep, dir.z * m.tstep};
}

// The same, and the ray's origin, which lighting needs.
__device__ __forceinline__ void ray_step(const MarchArgs& m, int px, int py, V3& step,
                                         float& tfar, V3& origin) {
  V3 dir;
  float tnear;
  make_ray(m, px, py, origin, dir, tnear, tfar);
  step = {dir.x * m.tstep, dir.y * m.tstep, dir.z * m.tstep};
}

// Marches the brick's part of a ray from its entry record e (e.i >= 0).
// body(s, p, sw) is called for every sample the brick composites, with its
// normalized position s, its position p and the opacity sw carried into it,
// which body updates. Returns the number of samples composited. A ray that leaves the
// brick, or moves away from it, ends; a later sample composites only while
// sw <= threshold and t <= tfar, the single-device march's stop test taken
// before the sample instead of after its predecessor.
template <typename Body>
__device__ __forceinline__ int march_brick(const BrickArgs& a, const Entry& e, V3 step,
                                           float tfar, float threshold, float& sw, Body body) {
  const MarchArgs& m = a.m;
  const float tstep = m.tstep;
  const float nb = (float)a.n_bricks, bf = (float)a.brick;
  float t = e.t;
  V3 p = e.p;
  int count = 0;
  for (int i = e.i; i < m.n_steps; ++i) {
    const V3 s = to_sample(m, p);
    const float owner = owner_of(s.z, nb);
    if (owner == bf) {
      if (i > 0 && !(sw <= threshold)) break;
      body(s, p, sw);
      ++count;
    } else if (!((step.z > 0.0f && owner < bf) || (step.z < 0.0f && owner > bf))) {
      break;
    }
    t = t + tstep;
    if (!(t <= tfar)) break;
    p = {p.x + step.x, p.y + step.y, p.z + step.z};
  }
  return count;
}

}  // namespace
