// K2: the per-env occupancy-window gather, hand-written for Hopper (sm_90a).
//
// Replaces apx's Pallas TPU kernel apx/ops/window_pallas.py (`kernel` in
// extract_windows_pallas, batched by make_window_extractor). apx cuts the
// (24, win) window padded[n, y0:y0+24, x0:x0+win] from a ray-padded copy
// of the map that it carries in its state, because the TPU's DMA engines
// need an in-bounds source. The padding is all zeros, so this kernel reads
// the unpadded (H, W) map instead: with (x0, y0) = starts[n] brought into
// range against the virtual padded dimensions (H + 2 pad, W + 2 pad) as
// jax.lax.dynamic_slice brings its start indices (a negative index counts
// from the end, then each is clamped into [0, W + 2 pad - win] x
// [0, H + 2 pad - 24]), window cell (r, c) is occ[n, y0 + r - pad,
// x0 + c - pad] where that cell lies in the map, and 0 elsewhere. Equal
// bitwise to apx_torch.ops.window.extract_windows.
//
// What bounds it: bytes, a few hundred per env (the window's cells inside
// the map read, 24 * win written, the starts), and at the LIDAR step's
// N = 4096 the launch itself. The design keeps the work per byte small:
//
//   * one warp per env, kWarps envs per block; the env's starts are one
//     broadcast load per warp, clamped once, and every index after that is
//     32-bit arithmetic with no division in the per-byte path;
//   * each lane stores whole units of kStore bytes (16: one row chunk per
//     lane; 4: consecutive lanes on consecutive words of a row; 1: any
//     win), and a window cell outside the map is written as 0 without a
//     load: a row outside the map loads nothing;
//   * where the map's rows are whole 4-byte words (W % 4 == 0 and an
//     aligned map), a lane reads the aligned words of its map row that
//     cover its unit and shifts them into place (__funnelshift_r), so a
//     32-cell row is read as its one 32-byte sector; otherwise it reads
//     bytes.
//
// The launcher picks the widest store that divides win.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 24;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ int slice_start(int i, int dim, int size) {
  if (i < 0) i += dim;  // no overflow: dim > 0 > i
  return min(max(i, 0), dim - size);
}

// Map word j of a row (4 cells), or 0 outside [0, words).
__device__ __forceinline__ uint32_t map_word(const uint32_t* row, int j, int words) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(words) ? __ldg(row + j) : 0u;
}

// Map cell x of a row, or 0 outside [0, w).
__device__ __forceinline__ uint32_t map_byte(const uint8_t* row, int x, int w) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(w) ? __ldg(row + x) : 0u;
}

// The kStore cells of a map row from map column c on, as little-endian
// words (v[0] holds cells c..c+3), 0 outside the map.
template <int kStore, bool kWordLoads>
__device__ __forceinline__ void load_unit(const uint8_t* row, int c, int w, uint32_t* v) {
  constexpr int kWords = kStore >= 4 ? kStore / 4 : 1;
  if (kStore == 1) {
    v[0] = map_byte(row, c, w);
  } else if (kWordLoads) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
    const int j = c >> 2;  // floor(c / 4): c may be negative
    const int shift = 8 * (c & 3);
    uint32_t lo = map_word(r, j, w >> 2);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t hi = map_word(r, j + k + 1, w >> 2);
      v[k] = __funnelshift_r(lo, hi, shift);
      lo = hi;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) x |= map_byte(row, c + 4 * k + b, w) << (8 * b);
      v[k] = x;
    }
  }
}

template <int kStore>
__device__ __forceinline__ void store_unit(uint8_t* dst, const uint32_t* v) {
  if (kStore == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (kStore == 4) {
    *reinterpret_cast<uint32_t*>(dst) = v[0];
  } else {
    *dst = static_cast<uint8_t>(v[0]);
  }
}

// One warp per env. The 24 x (win / kStore) units of the window are dealt
// to the lanes in row-major order, lane l taking units l, l + 32, ...;
// (row, unit) advances by (32 / q, 32 % q) per turn, so the loop divides
// nothing.
template <int kStore, bool kWordLoads>
__global__ void __launch_bounds__(kThreads)
window_kernel(const uint8_t* __restrict__ occ, const int2* __restrict__ starts,
              uint8_t* __restrict__ out, int n, int h, int w, int pad, int win) {
  const int env = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (env >= n) return;
  const int lane = threadIdx.x & 31;
  const int2 s = starts[env];
  const int c0 = slice_start(s.x, w + 2 * pad, win) - pad;  // map column of window column 0
  const int r0 = slice_start(s.y, h + 2 * pad, kRows) - pad;  // map row of window row 0
  const uint8_t* map = occ + static_cast<size_t>(env) * static_cast<size_t>(h * w);
  uint8_t* dst = out + static_cast<size_t>(env) * static_cast<size_t>(kRows * win);

  const int q = win / kStore;  // units per window row (once per thread)
  int r = lane / q;
  int k = lane - r * q;
  const int dr = 32 / q, dk = 32 - dr * q;
  while (r < kRows) {
    uint32_t v[kStore >= 4 ? kStore / 4 : 1] = {};
    const int y = r0 + r;
    if (static_cast<unsigned>(y) < static_cast<unsigned>(h)) {
      load_unit<kStore, kWordLoads>(map + y * w, c0 + k * kStore, w, v);
    }
    store_unit<kStore>(dst + r * win + k * kStore, v);
    r += dr;
    k += dk;
    if (k >= q) {
      k -= q;
      ++r;
    }
  }
}

template <int kStore>
void launch(bool word_loads, unsigned blocks, cudaStream_t s, const uint8_t* occ,
            const int2* starts, uint8_t* out, int n, int h, int w, int pad, int win) {
  if (word_loads) {
    window_kernel<kStore, true><<<blocks, kThreads, 0, s>>>(occ, starts, out, n, h, w, pad, win);
  } else {
    window_kernel<kStore, false><<<blocks, kThreads, 0, s>>>(occ, starts, out, n, h, w, pad, win);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/window_cuda.py).
// Device pointers: occ (N, H, W) bool as bytes, starts (N, 2) int32
// (x0, y0) in padded coordinates, out (N, 24, win) uint8; all contiguous.
// Needs H, W >= 1, pad >= 0, H + 2 pad >= 24 and W + 2 pad >= win >= 1.
// Each lane stores the widest unit (16, 4 or 1 bytes) that divides win.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).
extern "C" int window_launch(const void* occ, const void* starts, void* out, int n, int h, int w,
                             int pad, int win, void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || h < 1 || w < 1 || pad < 0 || h + 2 * pad < kRows || w + 2 * pad < win) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool word_loads = w % 4 == 0 && reinterpret_cast<uintptr_t>(occ) % 4 == 0;
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(occ);
  const int2* st = static_cast<const int2*>(starts);
  uint8_t* d = static_cast<uint8_t*>(out);
  if (win % 16 == 0) {
    launch<16>(word_loads, blocks, s, o, st, d, n, h, w, pad, win);
  } else if (win % 4 == 0) {
    launch<4>(word_loads, blocks, s, o, st, d, n, h, w, pad, win);
  } else {
    launch<1>(word_loads, blocks, s, o, st, d, n, h, w, pad, win);
  }
  return static_cast<int>(cudaGetLastError());
}
