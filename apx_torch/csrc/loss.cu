// P: the loss and the reward of the vector env's op-by-op sites (the
// DISABLED and LOCKSTEP steps and boundary_reset_step of core/env.py) as one
// launch, hand-written for Hopper (sm_90a). P replaces no TPU kernel: apx's
// jitted step computes the loss in XLA fusions (apx/core/losses.py). The
// plain form is ops/loss_cuda.py's `plain`, the chain of ATen launches
// `loss_fn(prediction, target)` and `loss_fn.reward(...)` (9 launches for the
// normalized cross-entropy, about 10 with N1 for the localization MSE); P
// equals it bitwise, NaN as NaN. Two device functions, one per entry:
//
//   loss_cross_entropy_launch (apx_loss_cross_entropy): over (N, C) float32
//     logits, C <= 1024, and an int64 label per row,
//       picked = label in [0, C) ? (x[label] - max) - log(sum exp(x - max))
//                                : 0, plus 0.0 (the chain sums the one-hot
//                                select's zeros, so -0 becomes +0),
//       loss = -picked, then loss * scale + offset (rounded twice) where
//       affine, reward = base - loss.
//     The row's max and sum are reduced in the order of PyTorch's
//     softmax_warp_forward (aten/src/ATen/native/cuda/PersistentSoftmax.cuh),
//     which torch.log_softmax runs at C <= 1024: with P = C rounded up to a
//     power of two, a group of W = min(32, P) lanes holds a row, lane g the
//     elements g + W i for i < P / W (-inf past C), reduced in i order and
//     then by __shfl_xor butterflies from W / 2 down to 1. A warp holds
//     32 / W rows.
//   loss_mse_launch (apx_loss_mse): F2's env segment unmasked
//     (mse_terms.cuh), one thread per env.
//
// Every operation is an explicitly rounded intrinsic, and the library is
// built with -fmad=false; exp and log are CUDA's expf and logf, as
// PyTorch's kernel calls them.
//
// What bounds it: bytes. At N = 16384 and C = 200 the cross-entropy reads
// 13.1 MB of logits and moves 0.33 MB more (label, base reward, loss,
// reward): 4.0 us at 3.35 TB/s, against 9 launches and ~40 us for the
// chain. The MSE at D = 2 moves 28 bytes an env, 0.46 MB at N = 16384, under
// the ~1.5 us any launch costs.
//
// Design of the cross-entropy: 256-thread blocks, one group of 32 / W rows
// a warp and 8 such groups a block, each lane reading its own elements from
// global memory: 32 neighbouring floats of a row a load, whole 32-byte
// sectors. The row stays in registers; nothing is written but each row's
// loss and reward, by the group's first lane. No shared memory, no atomics.
// Measured against it at N = 16384, C = 200, logits from HBM, on an H100
// 80GB HBM3 at 700 W (PERF.md; 8.4-9.1 us a launch): as many blocks as are
// resident at once, grid-strided over the rows, 8.7-8.8; copying a warp's
// rows into shared memory in 16-byte words first, for the same per-lane
// order, 10.8; two rows a warp loaded before either is reduced, 10.6 (fewer
// warps resident); the next row prefetched while this one is reduced, 9.8
// (39 registers); no exp on the all-padding iteration, 9.0-9.1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mse_terms.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxClasses = 1024;
constexpr int kMaxLog2 = 10;
// The most rows or envs: n + kThreads - 1 and the thread index stay in int.
constexpr int kMaxN = INT32_MAX - kThreads;

struct CrossEntropyArgs {
  const float* prediction;  // (n, classes)
  const int64_t* label;     // (n,)
  const float* base;        // (n,)
  float* loss;              // (n,)
  float* reward;            // (n,)
  int n;
  int classes;
  int affine;
  float scale;
  float offset;
};

template <int kLog2>
__global__ void __launch_bounds__(kThreads) apx_loss_cross_entropy(CrossEntropyArgs a) {
  constexpr int kPow = 1 << kLog2;
  constexpr int kWidth = kPow < 32 ? kPow : 32;  // lanes a row
  constexpr int kIter = kPow / kWidth;           // elements a lane
  constexpr int kRows = 32 / kWidth;             // rows a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane & (kWidth - 1);
  const int c = a.classes;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRows + lane / kWidth;
  const bool live = row < a.n;
  const float* src = a.prediction + row * c;
  float x[kIter];
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
    const int e = g + kWidth * i;
    x[i] = live && e < c ? src[e] : -INFINITY;
  }
  // The max and the sum of exp(x - max), in softmax_warp_forward's order
  // and with its comparisons (a NaN row's sum is NaN whatever the max).
  float m = x[0];
#pragma unroll
  for (int i = 1; i < kIter; ++i) m = m > x[i] ? m : x[i];
#pragma unroll
  for (int off = kWidth / 2; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(kFull, m, off, kWidth);
    m = m < o ? o : m;
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kIter; ++i) s = __fadd_rn(s, expf(__fsub_rn(x[i], m)));
#pragma unroll
  for (int off = kWidth / 2; off > 0; off /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off, kWidth));
  // The label's logit: held by lane label % W of the group, in its
  // element label / W.
  const int64_t label = live ? a.label[row] : -1;
  const bool in_range = label >= 0 && label < c;
  const int at = in_range ? static_cast<int>(label) : 0;
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < kIter; ++i) mine = at / kWidth == i ? x[i] : mine;
  const float xl = __shfl_sync(kFull, mine, at & (kWidth - 1), kWidth);
  if (live && g == 0) {
    float picked = in_range ? __fsub_rn(__fsub_rn(xl, m), logf(s)) : 0.0f;
    picked = __fadd_rn(picked, 0.0f);
    float loss = -picked;
    if (a.affine) loss = __fadd_rn(__fmul_rn(loss, a.scale), a.offset);
    a.loss[row] = loss;
    a.reward[row] = __fsub_rn(a.base[row], loss);
  }
}

__global__ void __launch_bounds__(kThreads)
apx_loss_mse(const float* prediction, const float* target, const float* base, float* loss,
             float* reward, int n, int d, int fused_sum, int affine, int contract, float scale,
             float offset, float k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  mse_loss_reward(prediction + static_cast<size_t>(d) * i, target + static_cast<size_t>(d) * i,
                  d, fused_sum, affine, scale, offset, contract, k, base[i], loss[i], reward[i]);
}

template <int kLog2>
int launch_cross_entropy(const CrossEntropyArgs& a, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarps * (32 / (kLog2 < 5 ? 1 << kLog2 : 32));
  apx_loss_cross_entropy<kLog2>
      <<<(a.n + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kLog2>
int dispatch_cross_entropy(const CrossEntropyArgs& a, int log2, cudaStream_t stream) {
  if constexpr (kLog2 > kMaxLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (log2 != kLog2) return dispatch_cross_entropy<kLog2 + 1>(a, log2, stream);
    return launch_cross_entropy<kLog2>(a, stream);
  }
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/loss_cuda.py). The
// pointers are device pointers to contiguous tensors. Launches on `stream`
// and returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int loss_cross_entropy_launch(const void* prediction, const void* label,
                                         const void* base, void* loss, void* reward, int n,
                                         int classes, int affine, float scale, float offset,
                                         void* stream) {
  if (n < 0 || n > kMaxN || classes < 1 || classes > kMaxClasses)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int log2 = 0;
  while ((1 << log2) < classes) ++log2;
  const CrossEntropyArgs a{static_cast<const float*>(prediction),
                           static_cast<const int64_t*>(label), static_cast<const float*>(base),
                           static_cast<float*>(loss), static_cast<float*>(reward), n, classes,
                           affine != 0, scale, offset};
  return dispatch_cross_entropy<0>(a, log2, static_cast<cudaStream_t>(stream));
}

extern "C" int loss_mse_launch(const void* prediction, const void* target, const void* base,
                               void* loss, void* reward, int n, int d, int fused_sum, int affine,
                               int contract, float scale, float offset, float k, void* stream) {
  if (n < 0 || n > kMaxN || d < 1 || d > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_loss_mse<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prediction), static_cast<const float*>(target),
      static_cast<const float*>(base), static_cast<float*>(loss), static_cast<float*>(reward), n,
      d, fused_sum, affine, contract, scale, offset, k);
  return static_cast<int>(cudaGetLastError());
}
