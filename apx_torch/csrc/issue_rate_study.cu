// K4: the issue-rate study's chain, hand-written for Hopper (sm_90a).
//
// Replaces apx's Pallas TPU kernel apx/ops/issue_rate_study.py
// (`_chain_kernel`, launched by chain_pallas). Each element runs `iters`
// rounds of the loop-carried 16-operation slab combine chain
// (`_chain_body`: max, min, compare, and, select, x*0.5, t*0.25 + 0.125,
// acc + t) and writes acc + x. Equal bitwise to
// apx_torch.ops.issue_rate_study.chain_body.
//
// The study asks what a per-env 16-wide tile costs against full-width
// registers. Each thread carries its elements through all iterations in
// registers, so the kernel is bound by instruction issue, and the two
// layouts are the GPU reading of apx's two:
//
//   wide   (layout 0): (rows, lanes) inputs with consecutive elements on
//          consecutive threads, so every warp is full (apx: 128 lanes);
//   narrow (layout 1): (rows, lanes <= 32) inputs, lane x on column x of a
//          row, so lanes..31 idle. At lanes = 16 that is the layout of a
//          kernel with one lane per column of a 16-column window.
//
// To come near the issue rate the design removes what the chain itself
// does not need: the loop runs kUnroll iterations per trip (with a
// remainder loop), so its counter and branch are paid once per kUnroll
// iterations; and every thread carries two independent elements,
// interleaved, so that one chain's dependent latency hides behind the
// other's. Wide: thread t carries elements t and t + ceil(total / 2).
// Narrow: warp w carries rows w and w + ceil(rows / 2), lane x column x of
// both, so the idle lanes the study measures stay idle. Neither layout
// changes its share of live lanes. Every multiply and add is written with
// an explicitly rounded intrinsic (the library is built with -fmad=false);
// t*0.25 + 0.125 is exact either way, so it is one __fmaf_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

struct Chain {
  float nx, ny, fx, fy, occ, acc, x;
};

__device__ __forceinline__ Chain load_chain(const float* __restrict__ nx,
                                            const float* __restrict__ ny,
                                            const float* __restrict__ fx,
                                            const float* __restrict__ fy,
                                            const float* __restrict__ occ, int i) {
  return Chain{nx[i], ny[i], fx[i], fy[i], occ[i], 0.0f, 0.25f};
}

__device__ __forceinline__ void chain_step(Chain& c) {
  const float a = fmaxf(fmaxf(c.x, c.nx), fmaxf(__fmul_rn(c.x, 0.5f), c.ny));
  const float b = fminf(fminf(__fsub_rn(c.fx, c.x), 1.0f), fminf(c.fy, __fsub_rn(1.0f, c.x)));
  const bool valid = (c.occ > c.x) && (a <= b);
  const float t = valid ? a : b;
  c.acc = __fadd_rn(c.acc, t);
  c.x = __fmaf_rn(t, 0.25f, 0.125f);
}

__device__ __forceinline__ void run_pair(Chain& c0, Chain& c1, int iters) {
  int i = 0;
#pragma unroll 1
  for (; i + kUnroll <= iters; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      chain_step(c0);
      chain_step(c1);
    }
  }
#pragma unroll 1
  for (; i < iters; ++i) {
    chain_step(c0);
    chain_step(c1);
  }
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
             const float* __restrict__ fx, const float* __restrict__ fy,
             const float* __restrict__ occ, float* __restrict__ out,
             int rows, int lanes, int iters) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int i0, i1;
  bool second;
  if (kNarrow) {
    const int half = (rows + 1) >> 1;
    const int row = t >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= half || lane >= lanes) return;
    i0 = row * lanes + lane;
    second = row + half < rows;
    i1 = second ? i0 + half * lanes : i0;
  } else {
    const int total = rows * lanes;
    const int half = (total + 1) >> 1;
    if (t >= half) return;
    i0 = t;
    second = t + half < total;
    i1 = second ? t + half : t;
  }
  // An odd count: a thread with no second element runs its first twice.
  Chain c0 = load_chain(nx, ny, fx, fy, occ, i0);
  Chain c1 = load_chain(nx, ny, fx, fy, occ, i1);
  run_pair(c0, c1, iters);
  out[i0] = __fadd_rn(c0.acc, c0.x);
  if (second) out[i1] = __fadd_rn(c1.acc, c1.x);
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/issue_rate_study.py).
// Device pointers: five (rows, lanes) f32 inputs and the (rows, lanes) f32
// output, contiguous, rows * lanes < 2^31. layout 0 = wide, 1 = narrow
// (lanes <= 32); the threads launched, ceil(rows / 2) * 32 narrow, must
// stay below 2^31 - 256, so that a thread's index fits an int. Launches on
// `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int chain_launch(const void* nx, const void* ny, const void* fx, const void* fy,
                            const void* occ, void* out, int rows, int lanes, int iters,
                            int layout, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  const long long threads = layout == 1 ? (static_cast<long long>(rows) + 1) / 2 * 32
                                        : (static_cast<long long>(rows) * lanes + 1) / 2;
  if ((layout != 0 && (layout != 1 || lanes > 32)) ||
      static_cast<long long>(rows) * lanes > 0x7fffffffLL ||
      threads > 0x7fffffffLL - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[5] = {static_cast<const float*>(nx), static_cast<const float*>(ny),
                        static_cast<const float*>(fx), static_cast<const float*>(fy),
                        static_cast<const float*>(occ)};
  float* o = static_cast<float*>(out);
  if (layout == 1) {
    chain_kernel<true><<<blocks, kThreads, 0, s>>>(in[0], in[1], in[2], in[3], in[4], o, rows,
                                                   lanes, iters);
  } else {
    chain_kernel<false><<<blocks, kThreads, 0, s>>>(in[0], in[1], in[2], in[3], in[4], o, rows,
                                                    lanes, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
