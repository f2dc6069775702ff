// corner_carry.cuh: a sample's cell, its fetch, and the carried scatter.
//
// What the kernels share for the corners of a trilinear sample: the cell
// (the lower corner before any clamp, and the weights), the fetch of one or
// two volumes or of a packed grid (K5's four volumes, K2's two, K2L's
// absorption and reflection, lit K7 phase 2's four windows) at its
// corners, and the carry that sums a ray's
// shares of a cell's corners in registers before they go out as atomic
// adds. The z-brick kernels address a halo-padded grid
// (ZSlab: its global depth and the global row of its first row); a
// single-device kernel passes whole(v), for which slab_row is clamp_index.

#pragma once

#include "march_common.cuh"

namespace {

// Where a grid lies in its volume along z.
struct ZSlab {
  int d_global, z_off;
};

// A grid that is the whole volume.
__device__ __forceinline__ ZSlab whole(const Vol& v) { return {v.d, 0}; }

// The ZSlab of grid v placed as zp places it (a cell's z is taken against it).
__device__ __forceinline__ ZSlab as_slab(const Vol& v, WholeZ) { return whole(v); }
__device__ __forceinline__ ZSlab as_slab(const Vol&, ZSlab z) { return z; }

// A grid row for global row g: clamped against the whole depth, as the
// single-device fetch clamps, then shifted into the grid. The second clamp
// only keeps a stray index inside the allocation: with two halo rows no
// owned sample of a brick reaches it. v: a Vol, or a packed Vol4 of the
// grid's shape.
template <class V>
__device__ __forceinline__ int slab_row(int g, const V& v, ZSlab z) {
  return min(max(clamp_index(g, z.d_global) - z.z_off, 0), v.d - 1);
}

// The lower corner of a sample before any clamp (z in global rows), and
// its weights: corner() of march_common.cuh without the clamp.
struct Cell {
  int x, y, z;
  float fx, fy, fz;
};

__device__ __forceinline__ Cell cell_of(const Vol& v, ZSlab z, V3 c) {
  Cell k;
  k.x = floor_index(c.x, v.w, k.fx);
  k.y = floor_index(c.y, v.h, k.fy);
  k.z = floor_index(c.z, z.d_global, k.fz);
  return k;
}

// sample() of march_common.cuh at the corners of cell k: the same voxels
// blended with the same weights in the same order, so the same float.
__device__ __forceinline__ float fetch_cell(const Vol& v, ZSlab z, const Cell& k) {
  const int x0 = clamp_index(k.x, v.w), x1 = clamp_index(k.x + 1, v.w);
  const int y0 = clamp_index(k.y, v.h), y1 = clamp_index(k.y + 1, v.h);
  const int z0 = slab_row(k.z, v, z), z1 = slab_row(k.z + 1, v, z);
  const float fx = k.fx, fy = k.fy, fz = k.fz;
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

// A window's placement along z (march_common.cuh, WholeZ): normalized z is
// taken against the whole depth, a global row is clamped to the whole
// volume and shifted into the window (slab_row), and a fetch is
// fetch_cell's.
__device__ __forceinline__ int z_depth(const Vol&, ZSlab z) { return z.d_global; }

__device__ __forceinline__ float z_sample(const Vol& v, ZSlab z, V3 c) {
  return fetch_cell(v, z, cell_of(v, z, c));
}

__device__ __forceinline__ size_t row_offset(const Vol& v, ZSlab z, int y, int g) {
  return (size_t)clamp_index(y, v.h) * (size_t)v.w +
         (size_t)slab_row(g, v, z) * ((size_t)v.w * (size_t)v.h);
}

__device__ __forceinline__ float z_corner(const Vol& v, ZSlab z, float c, int& z0, int& z1) {
  float f;
  const int i = floor_index(c, z.d_global, f);
  z0 = slab_row(i, v, z);
  z1 = slab_row(i + 1, v, z);
  return f;
}

// fetch_cell of two volumes a and b of one shape and place: one cell, one
// set of offsets, the loads of both issued corner by corner before the
// blends.
__device__ __forceinline__ void fetch_cell_pair(const Vol& a, const Vol& b, ZSlab z,
                                                const Cell& k, float& va, float& vb) {
  const int x0 = clamp_index(k.x, a.w), x1 = clamp_index(k.x + 1, a.w);
  const int y0 = clamp_index(k.y, a.h), y1 = clamp_index(k.y + 1, a.h);
  const int z0 = slab_row(k.z, a, z), z1 = slab_row(k.z + 1, a, z);
  const float fx = k.fx, fy = k.fy, fz = k.fz;
  const size_t sy = (size_t)a.w;
  const size_t sz = (size_t)a.w * (size_t)a.h;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  const size_t off[8] = {x0 + r00, x1 + r00, x0 + r10, x1 + r10,
                         x0 + r01, x1 + r01, x0 + r11, x1 + r11};
  float c[2][8];
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    c[0][k8] = __ldg(a.data + off[k8]);
    c[1][k8] = __ldg(b.data + off[k8]);
  }
  float out[2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float c00 = c[n][0] + fx * (c[n][1] - c[n][0]);
    const float c10 = c[n][2] + fx * (c[n][3] - c[n][2]);
    const float c01 = c[n][4] + fx * (c[n][5] - c[n][4]);
    const float c11 = c[n][6] + fx * (c[n][7] - c[n][6]);
    const float c0 = c00 + fy * (c10 - c00);
    const float c1 = c01 + fy * (c11 - c01);
    out[n] = c0 + fz * (c1 - c0);
  }
  va = out[0];
  vb = out[1];
}

// fetch_cell's blends of the 8 corner values q[a + 2 b + 4 c]
__device__ __forceinline__ float blend_cell(float q0, float q1, float q2, float q3, float q4,
                                            float q5, float q6, float q7, const Cell& k) {
  const float c00 = q0 + k.fx * (q1 - q0);
  const float c10 = q2 + k.fx * (q3 - q2);
  const float c01 = q4 + k.fx * (q5 - q4);
  const float c11 = q6 + k.fx * (q7 - q6);
  const float c0 = c00 + k.fy * (c10 - c00);
  const float c1 = c01 + k.fy * (c11 - c01);
  return c0 + k.fz * (c1 - c0);
}

// A corner row of a packed grid at global row g: clamped to the grid
// (whole along z) or, on a window, clamped to the whole volume and shifted
// in (slab_row).
template <class V>
__device__ __forceinline__ int corner_row(int g, const V& v, WholeZ) { return clamp_index(g, v.d); }

template <class V>
__device__ __forceinline__ int corner_row(int g, const V& v, ZSlab z) { return slab_row(g, v, z); }

// The 8 corners of cell k in a packed grid v (Vol4 or Vol2), placed along z
// by zp, c[a + 2 b + 4 c] at corner (x + a, y + b, z + c): one load a corner.
template <class V, class T, class ZP = WholeZ>
__device__ __forceinline__ void load_corners(const V& v, const Cell& k, T (&c)[8], ZP zp = ZP()) {
  const int x0 = clamp_index(k.x, v.w), x1 = clamp_index(k.x + 1, v.w);
  const int y0 = clamp_index(k.y, v.h), y1 = clamp_index(k.y + 1, v.h);
  const int z0 = corner_row(k.z, v, zp), z1 = corner_row(k.z + 1, v, zp);
  const size_t sy = (size_t)v.w;
  const size_t sz = (size_t)v.w * (size_t)v.h;
  const size_t r00 = y0 * sy + z0 * sz, r10 = y1 * sy + z0 * sz;
  const size_t r01 = y0 * sy + z1 * sz, r11 = y1 * sy + z1 * sz;
  const T* p = v.data;
  c[0] = __ldg(p + x0 + r00);
  c[1] = __ldg(p + x1 + r00);
  c[2] = __ldg(p + x0 + r10);
  c[3] = __ldg(p + x1 + r10);
  c[4] = __ldg(p + x0 + r01);
  c[5] = __ldg(p + x1 + r01);
  c[6] = __ldg(p + x0 + r11);
  c[7] = __ldg(p + x1 + r11);
}

// The four volumes of a Vol4 at the corners of cell k (K5; lit K7 phase 2
// on a window, zp a ZSlab): one 16-byte load a corner, each channel
// blended as sample() (fetch_cell) blends its volume, so each is the float
// that sample() gives.
template <class ZP = WholeZ>
__device__ __forceinline__ float4 fetch_packed(const Vol4& v, const Cell& k, ZP zp = ZP()) {
  float4 c[8];
  load_corners(v, k, c, zp);
  return {blend_cell(c[0].x, c[1].x, c[2].x, c[3].x, c[4].x, c[5].x, c[6].x, c[7].x, k),
          blend_cell(c[0].y, c[1].y, c[2].y, c[3].y, c[4].y, c[5].y, c[6].y, c[7].y, k),
          blend_cell(c[0].z, c[1].z, c[2].z, c[3].z, c[4].z, c[5].z, c[6].z, c[7].z, k),
          blend_cell(c[0].w, c[1].w, c[2].w, c[3].w, c[4].w, c[5].w, c[6].w, c[7].w, k)};
}

// The two volumes of a Vol2 at the corners of cell k (unlit K2; K2L's
// absorption and reflection at emission's cell): one 8-byte load a corner,
// each channel the float that sample() gives.
template <class ZP = WholeZ>
__device__ __forceinline__ float2 fetch_packed2(const Vol2& v, const Cell& k, ZP zp = ZP()) {
  float2 c[8];
  load_corners(v, k, c, zp);
  return {blend_cell(c[0].x, c[1].x, c[2].x, c[3].x, c[4].x, c[5].x, c[6].x, c[7].x, k),
          blend_cell(c[0].y, c[1].y, c[2].y, c[3].y, c[4].y, c[5].y, c[6].y, c[7].y, k)};
}

// The 8 trilinear weights of cell k by slot a + 2 b + 4 c (corner
// (x + a, y + b, z + c)): the x weight times the y weight times the z weight.
__device__ __forceinline__ void corner_weights(const Cell& k, float (&w)[8]) {
  const float fx = k.fx, fy = k.fy, fz = k.fz;
  const float gx0 = 1.0f - fx, gy0 = 1.0f - fy, gz0 = 1.0f - fz;
  w[0] = gx0 * gy0 * gz0;
  w[1] = fx * gy0 * gz0;
  w[2] = gx0 * fy * gz0;
  w[3] = fx * fy * gz0;
  w[4] = gx0 * gy0 * fz;
  w[5] = fx * gy0 * fz;
  w[6] = gx0 * fy * fz;
  w[7] = fx * fy * fz;
}

// The pending corner sums of one ray's current cell in N grids of one shape
// and place: s[n][a + 2 b + 4 c] is what the ray's samples in this cell, and
// in earlier cells sharing the corner, added to corner (x + a, y + b, z + c)
// of grid n. Every index into s is a constant after unrolling, so the sums
// stay in registers.
//
// The step is under half a voxel, so consecutive samples of a ray mostly
// share their cell, or 4 of its corners after crossing one face: a sample
// in the same cell adds into the sums, a sample that crosses a face keeps
// the corners both cells share and flushes the rest, and the ray flushes
// all when it ends. A flush is one atomicAdd without a return value
// (red.global.add.f32), at the corner clamped and shifted as the fetch
// clamps and shifts it, skipped for a sum that is still zero. This is the
// exact adjoint of the same fetches; only the order of the float additions
// changes, and atomic adds land in no fixed order anyway.
template <int N>
struct CornerCarry {
  float* grid[N];
  Vol v;
  ZSlab zs;
  int x, y, z;  // the cell; far from any real one until the first sample
  float s[N][8];

  // g1: the second grid, with N = 2
  __device__ __forceinline__ CornerCarry(const Vol& vol, ZSlab slab, float* g0, float* g1)
      : v(vol), zs(slab), x(-(1 << 29)), y(-(1 << 29)), z(-(1 << 29)) {
    grid[0] = g0;
    if constexpr (N == 2) grid[1] = g1;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int k = 0; k < 8; ++k) s[n][k] = 0.0f;
    }
  }

  // Adds slot k into the grids, clamped and shifted as the fetch clamps and
  // shifts its corner, and clears it.
  __device__ __forceinline__ void flush(int k) {
    const size_t off = (size_t)clamp_index(x + (k & 1), v.w) +
                       (size_t)clamp_index(y + ((k >> 1) & 1), v.h) * (size_t)v.w +
                       (size_t)slab_row(z + (k >> 2), v, zs) * ((size_t)v.w * (size_t)v.h);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (s[n][k] != 0.0f) atomicAdd(grid[n] + off, s[n][k]);
      s[n][k] = 0.0f;
    }
  }

  __device__ __forceinline__ void flush_all() {
#pragma unroll
    for (int k = 0; k < 8; ++k) flush(k);
  }

  // One step of d (-1, 0 or 1) along the axis of slot bit `bit`: the 4
  // corners left behind are flushed, the 4 kept move to the other side.
  __device__ __forceinline__ void shift(int bit, int d) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k & bit) continue;
      const int lo = k, hi = k | bit;
      if (d > 0) {
        flush(lo);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s[n][lo] = s[n][hi];
          s[n][hi] = 0.0f;
        }
      } else if (d < 0) {
        flush(hi);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s[n][hi] = s[n][lo];
          s[n][lo] = 0.0f;
        }
      }
    }
  }

  // Makes cell c the current one, flushing the corners it does not share.
  __device__ __forceinline__ void move_to(const Cell& c) {
    const int dx = c.x - x, dy = c.y - y, dz = c.z - z;
    if (dx == 0 && dy == 0 && dz == 0) return;
    if (abs(dx) > 1 || abs(dy) > 1 || abs(dz) > 1) {
      flush_all();
    } else {  // axis by axis: each flush addresses the cell as moved so far
      shift(1, dx);
      x = c.x;
      shift(2, dy);
      y = c.y;
      shift(4, dz);
    }
    x = c.x;
    y = c.y;
    z = c.z;
  }

  // d0 into grid 0 and, with N = 2, d1 into grid 1, spread by the weights w
  __device__ __forceinline__ void add(const float (&w)[8], float d0, float d1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[0][k] = s[0][k] + w[k] * d0;
      if constexpr (N == 2) s[1][k] = s[1][k] + w[k] * d1;
    }
  }
};

}  // namespace
