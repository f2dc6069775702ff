// brick_common.cuh: what the two z-brick kernels share.
//
// A brick holds rows [b * bd, (b + 1) * bd) of a volume plus two halo rows
// on each side, and marches the part of every ray that it owns. The ray is
// that of the whole box: positions advance from step 0 by accumulation, as
// march_fwd.cu advances them, and nothing is fetched until the brick is
// reached, so a sample has the same position in every brick and in the
// single-device march. ops/brick_march.py (BrickRays.walk) is the plain
// version of walk_brick below, step for step.

#pragma once

#include "march_common.cuh"

// Mirrored field for field by _BrickArgs in ops/cuda_bricks.py.
struct BrickArgs {
  MarchArgs m;          // em, ab: the brick's halo-padded grids; out: its contribution
  int n_bricks, brick;  // B and b
  int em_d_global, em_z_off;  // depth of the whole volume; global row of the
  int ab_d_global, ab_z_off;  // grid's first padded row (0 for a depth-1 volume)
  const float* w_in;    // (height, width) entry opacity; null means zero
  float* w_out;         // (height, width) exit opacity
};

namespace {

// Where a padded grid lies in its volume.
struct ZSlab {
  int d_global, z_off;
};

// corner() along z for a brick: the indices are clamped against the whole
// depth, as the single-device fetch clamps them, then shifted into the
// brick. The second clamp only keeps a stray index inside the allocation:
// with two halo rows no owned sample reaches it.
__device__ __forceinline__ float corner_z(float c, const Vol& v, ZSlab z, int& i0, int& i1) {
  int g0, g1;
  const float f = corner(c, z.d_global, g0, g1);
  i0 = min(max(g0 - z.z_off, 0), v.d - 1);
  i1 = min(max(g1 - z.z_off, 0), v.d - 1);
  return f;
}

// sample() of march_common.cuh on a brick, at global coordinates.
__device__ __forceinline__ float sample_slab(const Vol& v, ZSlab z, V3 c) {
  int x0, x1, y0, y1, z0, z1;
  const float fx = corner(c.x, v.w, x0, x1);
  const float fy = corner(c.y, v.h, y0, y1);
  const float fz = corner_z(c.z, v, z, z0, z1);
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

// Walks the ray of pixel (px, py) through brick a.brick. body(p, s, sw) is
// called for every sample the brick composites, with its world position p,
// its normalized position s and the opacity sw carried into it, which body
// updates. Returns the number of samples composited.
//
// Sample n belongs to brick clamp(floor(s.z * B), 0, B - 1): one expression
// that does not know b, so every sample has exactly one owner. Along a ray
// the owner is monotone, so a ray that has left the brick, or moves away
// from it, ends. The first sample of a ray composites unconditionally, a
// later one only while sw <= threshold and t <= tfar: the single-device
// march's stop test, taken before the sample instead of after its
// predecessor.
template <typename Body>
__device__ __forceinline__ int walk_brick(const BrickArgs& a, int px, int py, float threshold,
                                          float& sw, Body body) {
  const MarchArgs& m = a.m;
  V3 origin, dir;
  float tnear, tfar;
  if (!make_ray(m, px, py, origin, dir, tnear, tfar)) return 0;
  const float tstep = m.tstep;
  const float nb = (float)a.n_bricks, bf = (float)a.brick;
  float t = tnear;
  V3 p = {origin.x + dir.x * tnear, origin.y + dir.y * tnear, origin.z + dir.z * tnear};
  const V3 step = {dir.x * tstep, dir.y * tstep, dir.z * tstep};
  int count = 0;
  for (int i = 0; i < m.n_steps; ++i) {
    const V3 s = to_sample(m, p);
    const float owner = fminf(fmaxf(floorf(s.z * nb), 0.0f), nb - 1.0f);
    if (owner == bf) {
      if (i > 0 && !(sw <= threshold)) break;
      body(p, s, sw);
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
