// K2: the per-env occupancy-window gather, hand-written for Hopper (sm_90a).
//
// Replaces apx's Pallas TPU kernel apx/ops/window_pallas.py (`kernel` in
// extract_windows_pallas, batched by make_window_extractor). For env n it
// copies the (24, win) window occ_padded[n, y0:y0+24, x0:x0+win] of the
// ray-padded (Hp, Wp) map, as bytes, with (x0, y0) = starts[n] brought into
// range as jax.lax.dynamic_slice brings its start indices (the semantics of
// apx's kernel in interpret mode and of its unbatched and fallback paths):
// a negative index counts from the end, then each is clamped into
// [0, Wp - win] x [0, Hp - 24]. Equal bitwise to
// apx_torch.ops.window.extract_windows.
//
// The TPU kernel issued 8 DMA copies per program, and the TPU's DMA
// engines refuse 16-lane slices, so apx ran it only in interpret mode. On
// Hopper a 16-byte row gather is ordinary work: one thread per output
// byte, consecutive threads on consecutive bytes of a window row, so each
// warp reads two 16-byte row segments of one env's map and writes 32
// consecutive output bytes. The kernel moves 24 * win bytes in and out per
// env plus its starts; it is bound by those bytes (and, at the LIDAR
// step's N = 4096, by the launch itself), not by arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 24;
constexpr int kThreads = 256;

__device__ __forceinline__ int slice_start(int i, int dim, int size) {
  if (i < 0) i += dim;
  return min(max(i, 0), dim - size);
}

__global__ void __launch_bounds__(kThreads)
window_kernel(const uint8_t* __restrict__ occ, const int32_t* __restrict__ starts,
              uint8_t* __restrict__ out, int n, int hp, int wp, int win) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_env = static_cast<long long>(kRows) * win;
  if (i >= per_env * n) return;
  const long long env = i / per_env;
  const int within = static_cast<int>(i - env * per_env);
  const int row = within / win;
  const int col = within - row * win;
  const int x0 = slice_start(starts[2 * env], wp, win);
  const int y0 = slice_start(starts[2 * env + 1], hp, kRows);
  out[i] = occ[env * hp * wp + static_cast<long long>(y0 + row) * wp + x0 + col] != 0;
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/window_cuda.py).
// Device pointers: occ (N, Hp, Wp) bool as bytes, starts (N, 2) int32
// (x0, y0), out (N, 24, win) uint8; all contiguous. Needs Hp >= 24 and
// Wp >= win. Launches on `stream` and returns the CUDA error of the launch
// (0 on success).
extern "C" int window_launch(const void* occ, const void* starts, void* out, int n, int hp,
                             int wp, int win, void* stream) {
  if (n <= 0) return 0;
  if (win < 1 || hp < kRows || wp < win) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * kRows * win;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  window_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<const int32_t*>(starts),
      static_cast<uint8_t*>(out), n, hp, wp, win);
  return static_cast<int>(cudaGetLastError());
}
