// K1: the batched slab raycast, hand-written for Hopper (sm_90a).
//
// Replaces apx's Pallas TPU kernel apx/ops/raycast_pallas.py (`_kernel`,
// launched by raycast_grid_pallas / raycast_grid_pallas_batch). For env n
// and segment r it tests the segment origin[n] -> targets[n, r] against
// the wall cells of the env's (H, W) occupancy map, H, W <= 32:
//
//   raycast_fast_launch:  the untyped cast, equal bitwise to
//     apx_torch.ops.raycast.raycast_grid(geos_typing=False);
//   raycast_typed_launch: the GEOS-typed reset scan (zero-width corner
//     grazes classified as in apx/ops/raycast.py:172-227), equal bitwise
//     to raycast_grid(geos_typing=True).
//
// What bounds it: instruction issue. Per cell the slab test is a handful
// of min/max/compare/select instructions on values in registers; the bytes
// (the map once, the segments, the output) take less time at the HBM rate.
// The first design (one warp per (env, ray), one lane per map column) ran
// a 32-step row loop per ray that tested every cell of the map, read the
// env's map from global memory once per ray, and left half of every warp
// idle on 16-column windows.
//
// Design: one warp per env, eight envs per 256-thread block; the warp
// casts all R rays of the launch.
//  * The env's map is read once, coalesced, and packed into H*W bits in
//    shared memory (__ballot_sync over 32 consecutive cells, row-major);
//    every ray and the typed variant's flank tests read the bits.
//  * The segments' extents and the reciprocals 1/dx, 1/dy are computed
//    once per ray and axis, sixteen rays at a time in the lanes
//    (lane 2j + a holds ray j's axis a), and shuffled to the warp per ray.
//  * Per ray, lane x computes column x's slab pair and lane y row y's (as
//    before), and the cast tests only the cells of the hull of the columns
//    with near_x <= 1 and far_x >= 0 times the hull of the rows with
//    near_y <= 1 and far_y >= 0, spread over all 32 lanes whatever W is.
//  * Exactness of the cull: a cell is a candidate only if a <= b, with
//    a = max(near_x, near_y, 0) and b = min(far_x, far_y, 1) (the fast
//    form clips each pair first, which is the same). a <= b implies
//    near_x <= a <= b <= 1 and 0 <= a <= b <= far_x, and the same for y.
//    So a cell whose column (or row) fails near <= 1 or far >= 0 fails
//    a <= b; a NaN pair, mapped to (+inf, -inf), fails both tests as it
//    fails a <= b. The minimum and the graze sets over the remaining cells
//    are those over the whole map, and the test inside is unchanged, so
//    the result is bitwise the dense one. For a segment inside the map
//    these columns and rows lie in its bounding box with a one-cell
//    margin: a column wholly behind the origin has far_x < 0 and one
//    wholly past the end near_x > 1 (apx's own sub-slice argument,
//    apx/envs/lidar_localization.py:363-388). A beam of range 5 tests at
//    most 7 x 7 cells, a move or slide cast a few; a segment whose box is
//    the whole map tests all H * W cells, 32 per pass.
//  * The per-ray minimum is one __reduce_min_sync over the candidates as
//    unsigned bits (non-negative floats order as their bits; -0 is made
//    +0 first, which no output can tell apart).
//
// Numerics: every multiply, add and divide is written with an explicitly
// rounded intrinsic, and the library is built with -fmad=false, so nvcc
// contracts nothing. The one fused multiply-add is the pull-back
// fma(t_hit, |d|, -eps) that the JAX reference's jitted casts contain; the
// plain PyTorch form computes the same single-rounded FMA
// (apx_torch/core/numerics.py). The segment lengths |d| come from the
// caller, as K1's `len` input did, since the reference rounds them
// differently at different call sites; with no lengths (a null `seg`) the
// kernel computes the contracted form jnp.linalg.norm takes in apx's jitted
// casts, |d| = sqrt(fma(dy, dy, dx * dx)) with d = targets - origin (the
// float32 subtraction, correctly rounded root), as apx feeds it to its
// Pallas call from the same XLA program (raycast_pallas.py:106, :131). That
// is a compile-time flag (kOwnLen), not a run-time branch: a run-time
// branch cost K3 18% (PERF.md). Infinities are IEEE infinities, as
// in the dense reference (the Pallas kernel's +-3e38 sentinel was a Mosaic
// workaround).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
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

template <bool kTyped, bool kOwnLen>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
raycast_kernel(const uint8_t* __restrict__ occ, const float* __restrict__ origin,
               const float* __restrict__ targets, const float* __restrict__ seg_len,
               float* __restrict__ out, int n, int r, int h, int w, float eps) {
  __shared__ uint32_t bits_all[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + warp;
  if (env >= n) return;  // uniform across the warp; no block barrier follows
  uint32_t* bits = bits_all[warp];

  // The origin and the first pass's segment ends and lengths (lane 2j + a:
  // ray j's end on axis a; lane j: its length), loaded before the map so
  // that the loads' latencies overlap.
  const float ox = origin[2 * env], oy = origin[2 * env + 1];
  const size_t ray0 = static_cast<size_t>(env) * r;
  int count = min(kRaysPerPass, r);
  float end = (lane >> 1) < count ? targets[2 * ray0 + lane] : 0.0f;
  float seg = 0.0f;
  if (!kOwnLen && lane < count) seg = seg_len[ray0 + lane];

  // The env's map as H*W row-major bits: word k holds cells 32k..32k+31.
  const int hw = h * w;
  const uint8_t* m = occ + static_cast<size_t>(env) * hw;
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

  const float lo = static_cast<float>(lane);
  for (int base = 0; base < r; base += kRaysPerPass) {
    if (base > 0) {
      count = min(kRaysPerPass, r - base);
      end = (lane >> 1) < count ? targets[2 * (ray0 + base) + lane] : 0.0f;
      if (!kOwnLen) seg = lane < count ? seg_len[ray0 + base + lane] : 0.0f;
    }
    // Lane 2j + a: ray base + j's extent on axis a and its reciprocal.
    float d = 0.0f, inv = 0.0f;
    if ((lane >> 1) < count) {
      d = __fsub_rn(end, (lane & 1) ? oy : ox);
      if (d != 0.0f) inv = __fdiv_rn(1.0f, d);
    }
    if (kOwnLen) {  // lane j: ray base + j's |d| = sqrt(fma(dy, dy, dx * dx))
      const float dx = __shfl_sync(kFull, d, (2 * lane) & 31);
      const float dy = __shfl_sync(kFull, d, (2 * lane + 1) & 31);
      seg = __fsqrt_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
    }
    float t_mine = CUDART_INF_F;  // lane j: ray base + j's hit parameter
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
    if (lane < count) {
      out[ray0 + base + lane] =
          single_mine ? 0.0f : (t_mine < CUDART_INF_F ? pulled_back(t_mine, seg, eps) : seg);
    }
  }
}

template <bool kTyped, bool kOwnLen>
void launch_kernel(unsigned blocks, cudaStream_t stream, const void* occ, const void* origin,
                   const void* targets, const void* seg, void* out, int n, int r, int h, int w,
                   float eps) {
  raycast_kernel<kTyped, kOwnLen><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const uint8_t*>(occ), static_cast<const float*>(origin),
      static_cast<const float*>(targets), static_cast<const float*>(seg),
      static_cast<float*>(out), n, r, h, w, eps);
}

template <bool kTyped>
int launch(const void* occ, const void* origin, const void* targets, const void* seg,
           void* out, int n, int r, int h, int w, float eps, void* stream) {
  if (n <= 0 || r <= 0) return 0;
  if (h < 1 || h > 32 || w < 1 || w > 32) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto st = static_cast<cudaStream_t>(stream);
  if (seg == nullptr) {
    launch_kernel<kTyped, true>(blocks, st, occ, origin, targets, seg, out, n, r, h, w, eps);
  } else {
    launch_kernel<kTyped, false>(blocks, st, occ, origin, targets, seg, out, n, r, h, w, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/raycast_cuda.py).
// Pointers are device pointers: occ (N, H, W) bool as bytes, origin (N, 2)
// f32, targets (N, R, 2) f32, seg (N, R) f32 segment lengths or null (the
// kernel computes the contracted |d|), out (N, R) f32; all contiguous.
// Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int raycast_fast_launch(const void* occ, const void* origin, const void* targets,
                                   const void* seg, void* out, int n, int r, int h, int w,
                                   float eps, void* stream) {
  return launch<false>(occ, origin, targets, seg, out, n, r, h, w, eps, stream);
}

extern "C" int raycast_typed_launch(const void* occ, const void* origin, const void* targets,
                                    const void* seg, void* out, int n, int r, int h, int w,
                                    float eps, void* stream) {
  return launch<true>(occ, origin, targets, seg, out, n, r, h, w, eps, stream);
}
