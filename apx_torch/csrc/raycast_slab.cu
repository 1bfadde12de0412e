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
// casts all R rays of the launch. The map's packing and the cast of one
// pass of rays live in raycast_cast.cuh (pack_map_bytes, cast_pass), which
// the fused LIDAR step and reset (lidar_fused.cu) call too.
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

#include "raycast_cast.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

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
  pack_map_bytes(occ + static_cast<size_t>(env) * h * w, h * w, lane, bits);

  for (int base = 0; base < r; base += kRaysPerPass) {
    if (base > 0) {
      count = min(kRaysPerPass, r - base);
      end = (lane >> 1) < count ? targets[2 * (ray0 + base) + lane] : 0.0f;
      if (!kOwnLen) seg = lane < count ? seg_len[ray0 + base + lane] : 0.0f;
    }
    const float dist = cast_pass<kTyped, kOwnLen>(bits, h, w, ox, oy, lane, count, end, seg, eps);
    if (lane < count) out[ray0 + base + lane] = dist;
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
