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
// registers. One thread carries one element through all iterations in
// registers, so the kernel is bound by instruction issue, and the two
// layouts are the GPU reading of apx's two:
//
//   wide   (layout 0): (rows, lanes) inputs with consecutive elements on
//          consecutive threads, so every warp is full (apx: 128 lanes);
//   narrow (layout 1): (rows, lanes <= 32) inputs, one row per warp with
//          lane x on column x, so lanes..31 idle. At lanes = 16 that is
//          the layout of the port's K1 on a 16-column window
//          (apx_torch/csrc/raycast_slab.cu: one lane per column).
//
// Both use the same block size. Every multiply and add is written with an
// explicitly rounded intrinsic (the library is built with -fmad=false);
// t*0.25 + 0.125 is exact either way, so it is one __fmaf_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float chain(float nx, float ny, float fx, float fy, float occ,
                                       int iters) {
  float acc = 0.0f, x = 0.25f;
  for (int i = 0; i < iters; ++i) {
    const float a = fmaxf(fmaxf(x, nx), fmaxf(__fmul_rn(x, 0.5f), ny));
    const float b = fminf(fminf(__fsub_rn(fx, x), 1.0f), fminf(fy, __fsub_rn(1.0f, x)));
    const bool valid = (occ > x) && (a <= b);
    const float t = valid ? a : b;
    acc = __fadd_rn(acc, t);
    x = __fmaf_rn(t, 0.25f, 0.125f);
  }
  return __fadd_rn(acc, x);
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
             const float* __restrict__ fx, const float* __restrict__ fy,
             const float* __restrict__ occ, float* __restrict__ out,
             int rows, int lanes, int iters) {
  long long i;
  if (kNarrow) {
    const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= rows || lane >= lanes) return;
    i = row * lanes + lane;
  } else {
    i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= static_cast<long long>(rows) * lanes) return;
  }
  out[i] = chain(nx[i], ny[i], fx[i], fy[i], occ[i], iters);
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/issue_rate_study.py).
// Device pointers: five (rows, lanes) f32 inputs and the (rows, lanes) f32
// output, contiguous. layout 0 = wide, 1 = narrow (lanes <= 32). Launches
// on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int chain_launch(const void* nx, const void* ny, const void* fx, const void* fy,
                            const void* occ, void* out, int rows, int lanes, int iters,
                            int layout, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  if (layout != 0 && (layout != 1 || lanes > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = layout == 1 ? static_cast<long long>(rows) * 32
                                        : static_cast<long long>(rows) * lanes;
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
