// K1's cast, as device functions shared by the kernels that cast: K1
// itself (raycast_slab.cu) and the fused LIDAR step and reset (S and R,
// lidar_fused.cu). The design and the numerics are K1's, described in
// raycast_slab.cu: one warp per env, the env's map packed into H*W
// row-major bits in shared memory (word k holds cells 32k..32k+31), up to
// sixteen rays a pass with lane 2j + a holding ray j's end on axis a, each
// ray testing only the hull of the columns and rows whose slab pairs can
// hold a candidate. Every operation is an explicitly rounded intrinsic;
// the library is built with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRaysPerPass = 16;  // two lanes (x, y) per ray

// Per-axis slab parameters of the cell [lo, lo + 1] for a segment starting
// at o with extent d and inv = 1 / d; d == 0 handled exactly
// (raycast.py:_slab_axis). torch.minimum/maximum propagate NaN and a NaN
// bound fails every a <= b test of its row or column; mapping NaN to
// (near, far) = (+inf, -inf) fails exactly the same tests, so fminf/fmaxf
// can be used per cell.
__device__ __forceinline__ void slab_axis(float o, float d, float inv, float lo,
                                          float& near_t, float& far_t) {
  const float hi = __fadd_rn(lo, 1.0f);
  if (d == 0.0f) {
    const bool inside = (lo <= o) && (o <= hi);
    near_t = inside ? -CUDART_INF_F : CUDART_INF_F;
    far_t = inside ? CUDART_INF_F : -CUDART_INF_F;
    return;
  }
  const float t1 = __fmul_rn(__fsub_rn(lo, o), inv);
  const float t2 = __fmul_rn(__fsub_rn(hi, o), inv);
  if (isnan(t1) || isnan(t2)) {
    near_t = CUDART_INF_F;
    far_t = -CUDART_INF_F;
    return;
  }
  near_t = fminf(t1, t2);
  far_t = fmaxf(t1, t2);
}

// Bits of a non-negative float (or +inf) that order as the floats do.
__device__ __forceinline__ uint32_t order_bits(float t) {
  return __float_as_uint(__fadd_rn(t, 0.0f));  // -0 -> +0
}

__device__ __forceinline__ float pulled_back(float t_hit, float seg, float eps) {
  return fmaxf(__fmaf_rn(t_hit, seg, -eps), 0.0f);
}

// The cells of the ray's candidate hull, enumerated 32 per pass: lane k of
// pass i takes cell k + 32 i, row-major over the hull.
struct Hull {
  int x0, y0, ncols, total;
  int qx, qy;    // this lane's cell, relative to (x0, y0)
  int sx, sy;    // the step of one pass of 32 cells
};

__device__ __forceinline__ bool make_hull(uint32_t cols, uint32_t rows, int lane, Hull& hl) {
  if (cols == 0u || rows == 0u) return false;
  hl.x0 = __ffs(cols) - 1;
  hl.y0 = __ffs(rows) - 1;
  hl.ncols = 32 - __clz(cols) - hl.x0;
  hl.total = hl.ncols * (32 - __clz(rows) - hl.y0);
  // floor(k / ncols) for k <= 32, ncols <= 32: the quotient is at least
  // 0.5 / ncols from an integer, far above __fdividef's error.
  const float nc = static_cast<float>(hl.ncols);
  hl.qy = static_cast<int>(__fdividef(static_cast<float>(lane) + 0.5f, nc));
  hl.qx = lane - hl.qy * hl.ncols;
  hl.sy = static_cast<int>(__fdividef(32.5f, nc));
  hl.sx = 32 - hl.sy * hl.ncols;
  return true;
}

__device__ __forceinline__ void next_pass(Hull& hl) {
  hl.qx += hl.sx;
  hl.qy += hl.sy;
  if (hl.qx >= hl.ncols) {
    hl.qx -= hl.ncols;
    hl.qy += 1;
  }
}

__device__ __forceinline__ bool wall_bit(const uint32_t* bits, int cell) {
  return (bits[cell >> 5] >> (cell & 31)) & 1u;
}

// Reads the env's map m (hw <= 1024 bytes, one per cell, row-major) once,
// coalesced, and packs it into bits[0..31] (cells past hw are 0); the warp
// reads bits after the __syncwarp.
__device__ __forceinline__ void pack_map_bytes(const uint8_t* m, int hw, int lane,
                                               uint32_t* bits) {
  uint8_t cell[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = k * 32 + lane;
    cell[k] = i < hw ? m[i] : 0;
  }
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t b = __ballot_sync(kFull, cell[k] != 0);
    if (lane == k) word = b;
  }
  bits[lane] = word;
  __syncwarp();
}

// One pass of `count` <= kRaysPerPass rays from (ox, oy) over the map
// `bits` (h x w, row-major). Lane 2j + a holds ray j's end on axis a in
// `end`; lane j its segment length in `seg` (ignored under kOwnLen, where
// the pass computes the contracted |d| = sqrt(fma(dy, dy, dx * dx)) of
// d = end - origin). Returns, in lane j < count, ray j's distance: the
// hit parameter pulled back by eps along |d|, |d| on a miss, and 0 for a
// typed scan that met one isolated graze only. Every lane of the warp
// calls it with the same count.
template <bool kTyped, bool kOwnLen>
__device__ __forceinline__ float cast_pass(const uint32_t* bits, int h, int w, float ox,
                                           float oy, int lane, int count, float end, float seg,
                                           float eps) {
  const float lo = static_cast<float>(lane);
  // Lane 2j + a: ray j's extent on axis a and its reciprocal.
  float d = 0.0f, inv = 0.0f;
  if ((lane >> 1) < count) {
    d = __fsub_rn(end, (lane & 1) ? oy : ox);
    if (d != 0.0f) inv = __fdiv_rn(1.0f, d);
  }
  if (kOwnLen) {  // lane j: ray j's |d| = sqrt(fma(dy, dy, dx * dx))
    const float dx = __shfl_sync(kFull, d, (2 * lane) & 31);
    const float dy = __shfl_sync(kFull, d, (2 * lane + 1) & 31);
    seg = __fsqrt_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  }
  float t_mine = CUDART_INF_F;  // lane j: ray j's hit parameter
  bool single_mine = false;     // lane j: its typed scan met one isolated graze only
  for (int j = 0; j < count; ++j) {
    const float dx = __shfl_sync(kFull, d, 2 * j), dy = __shfl_sync(kFull, d, 2 * j + 1);
    const float ix = __shfl_sync(kFull, inv, 2 * j), iy = __shfl_sync(kFull, inv, 2 * j + 1);
    // Lane x holds column x's slab pair, lane y row y's.
    float nx, fx, ny, fy;
    slab_axis(ox, dx, ix, lo, nx, fx);
    slab_axis(oy, dy, iy, lo, ny, fy);
    const uint32_t cols = __ballot_sync(kFull, lane < w && nx <= 1.0f && fx >= 0.0f);
    const uint32_t rows = __ballot_sync(kFull, lane < h && ny <= 1.0f && fy >= 0.0f);
    Hull hl;
    const bool any_cell = make_hull(cols, rows, lane, hl);  // uniform

    if (!kTyped) {
      // Clips hoisted into the separable pairs (raycast.py fast path).
      const float nx0 = fmaxf(nx, 0.0f), fxc = fminf(fx, 1.0f);
      const float ny0 = fmaxf(ny, 0.0f), fyc = fminf(fy, 1.0f);
      float t = CUDART_INF_F;
      if (any_cell) {
        for (int k = lane; k - lane < hl.total; k += 32) {
          const int cx = hl.x0 + hl.qx, cy = hl.y0 + hl.qy;
          const float a_x = __shfl_sync(kFull, nx0, cx), b_x = __shfl_sync(kFull, fxc, cx);
          const float a_y = __shfl_sync(kFull, ny0, cy), b_y = __shfl_sync(kFull, fyc, cy);
          if (k < hl.total && wall_bit(bits, cy * w + cx)) {
            const float a = fmaxf(a_x, a_y);
            if (a <= fminf(b_x, b_y)) t = fminf(t, a);
          }
          next_pass(hl);
        }
      }
      const uint32_t tb = __reduce_min_sync(kFull, order_bits(t));
      if (lane == j) t_mine = __uint_as_float(tb);
      continue;
    }

    const bool sx_pos = dx >= 0.0f, sy_pos = dy >= 0.0f;
    bool any_nd = false, any_iso = false;
    float t_nd = CUDART_INF_F, t_iso_min = CUDART_INF_F;
    uint32_t iso_max = 0u;  // bits of the largest isolated graze (0 = none or +0)
    if (any_cell) {
      for (int k = lane; k - lane < hl.total; k += 32) {
        const int x = hl.x0 + hl.qx, y = hl.y0 + hl.qy;
        const float nxc = __shfl_sync(kFull, nx, x), fxc = __shfl_sync(kFull, fx, x);
        const float nyc = __shfl_sync(kFull, ny, y), fyc = __shfl_sync(kFull, fy, y);
        next_pass(hl);
        if (k >= hl.total || !wall_bit(bits, y * w + x)) continue;
        const float a = fmaxf(fmaxf(nxc, nyc), 0.0f);
        const float b = fminf(fminf(fxc, fyc), 1.0f);
        if (!(a <= b)) continue;
        if (a < b) {  // a real crossing interval
          any_nd = true;
          t_nd = fminf(t_nd, a);
          continue;
        }
        // A zero-width graze. It is isolated unless a cell flanking the
        // grazed corner is a wall (outside the map counts as free). Case
        // A (entry from x == exit from y) passes from (x - sx, y) into
        // (x, y + sy); case B mirrors it.
        auto wall = [&](int cx, int cy) {
          return cx >= 0 && cx < w && cy >= 0 && cy < h && wall_bit(bits, cy * w + cx);
        };
        const bool flank = (nxc >= nyc)
            ? (wall(x, sy_pos ? y + 1 : y - 1) || wall(sx_pos ? x - 1 : x + 1, y))
            : (wall(sx_pos ? x + 1 : x - 1, y) || wall(x, sy_pos ? y - 1 : y + 1));
        if (!flank) {
          any_iso = true;
          t_iso_min = fminf(t_iso_min, a);
          iso_max = max(iso_max, order_bits(a));
        }
      }
    }
    any_nd = __any_sync(kFull, any_nd);
    any_iso = __any_sync(kFull, any_iso);
    const uint32_t nd_bits = __reduce_min_sync(kFull, order_bits(t_nd));
    const uint32_t iso_min = __reduce_min_sync(kFull, order_bits(t_iso_min));
    iso_max = __reduce_max_sync(kFull, iso_max);
    // GEOS result typing: line-only -> nearest entry; points-only ->
    // Point (distance 0) or MultiPoint (nearest graze); mixed -> a
    // GeometryCollection, which the reference reports as a miss.
    const bool hit_line = any_nd && !any_iso;
    const bool points = !any_nd && any_iso;
    if (lane == j) {
      t_mine = hit_line ? __uint_as_float(nd_bits)
                        : (points ? __uint_as_float(iso_min) : CUDART_INF_F);
      single_mine = points && iso_min == iso_max;
    }
  }
  return single_mine ? 0.0f : (t_mine < CUDART_INF_F ? pulled_back(t_mine, seg, eps) : seg);
}

}  // namespace
