// N1-N3: XLA's contracted float32 arithmetic, hand-written for Hopper
// (sm_90a). These are the port's own kernels: apx has no Pallas twin,
// because XLA forms the same roundings inside its fusions. The jitted
// reference contracts a multiply feeding an add into one fused multiply-add
// and takes a correctly rounded square root; PyTorch has neither as one
// float32 operator, so the plain forms in apx_torch/core/numerics.py
// emulate them in float64 (~16 launches per FMA). Here each is one launch:
//
//   fma_f32_launch:         N1, out = fma(a, b, c) over the broadcast shape,
//                           one rounding (__fmaf_rn);
//   sum_squares_f32_launch: N2, per row of the last axis acc = x0 * x0 (one
//                           rounding), then acc = fma(xi, xi, acc) for
//                           i = 1 .. K-1 in that order: XLA-CPU's fused
//                           reduce, the order of numerics.sum_squares;
//   sqrt_f32_launch:        N3, the correctly rounded root (__fsqrt_rn).
//
// Each equals its plain form bitwise. The library is built with
// -fmad=false (N2's x0 * x0 stays a rounded product, not an FMA with 0),
// -prec-sqrt=true and -ftz=false (subnormal operands and results are
// kept, as the float64 emulation keeps them).
//
// What bounds them: the launch, at the step's sizes (a few thousand
// elements); past that, bytes: each element is one FMA, or K of them for
// N2, against 4 to 16 bytes moved.
//
// Operands are strided views: up to kMaxDims dimensions after the host has
// collapsed the mergeable ones (apx_torch/core/numerics.py), an element
// stride per dimension and operand (0 on a broadcast axis), so a slice
// d[..., 0], a [:, None] view or an expanded scalar is read in place and
// never copied. An N1 operand may instead be a float32 scalar passed by
// value (a null pointer). The output is contiguous, in the broadcast
// shape's row-major order. Index arithmetic is 32-bit where every offset
// fits, 64-bit otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 4;
constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

template <typename Index>
struct Layout {
  Index size[kMaxDims];       // innermost last; only the first kDims are read
  Index stride[3][kMaxDims];  // per operand, in elements
  Index total;
};

struct Scalars {
  const float* ptr[3];  // null: the operand is value[k]
  float value[3];
};

// Element offsets of output index i in each of the first kOps operands.
template <int kDims, int kOps, typename Index>
__device__ __forceinline__ void offsets(const Layout<Index>& l, Index i, Index (&off)[3]) {
#pragma unroll
  for (int k = 0; k < kOps; ++k) off[k] = 0;
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    Index q = i, c = i;
    if (d > 0) {
      q = i / l.size[d];
      c = i - q * l.size[d];
    }
#pragma unroll
    for (int k = 0; k < kOps; ++k) off[k] += c * l.stride[k][d];
    i = q;
  }
}

__device__ __forceinline__ float operand(const Scalars& s, int k, size_t off) {
  return s.ptr[k] != nullptr ? __ldg(s.ptr[k] + off) : s.value[k];
}

template <int kDims, typename Index>
__global__ void __launch_bounds__(kThreads)
apx_fma_f32(Scalars s, Layout<Index> l, float* __restrict__ out) {
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; i < l.total;
       i += step) {
    Index off[3];
    offsets<kDims, 3>(l, i, off);
    out[i] = __fmaf_rn(operand(s, 0, off[0]), operand(s, 1, off[1]), operand(s, 2, off[2]));
  }
}

template <int kDims, typename Index>
__global__ void __launch_bounds__(kThreads)
apx_sum_squares_f32(const float* __restrict__ x, Layout<Index> l, int k, Index k_stride,
                    float* __restrict__ out) {
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; i < l.total;
       i += step) {
    Index off[3];
    offsets<kDims, 1>(l, i, off);
    const float* row = x + off[0];
    const float x0 = __ldg(row);
    float acc = __fmul_rn(x0, x0);
    for (int j = 1; j < k; ++j) {
      const float xj = __ldg(row + static_cast<Index>(j) * k_stride);
      acc = __fmaf_rn(xj, xj, acc);
    }
    out[i] = acc;
  }
}

template <int kDims, typename Index>
__global__ void __launch_bounds__(kThreads)
apx_sqrt_f32(const float* __restrict__ x, Layout<Index> l, float* __restrict__ out) {
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; i < l.total;
       i += step) {
    Index off[3];
    offsets<kDims, 1>(l, i, off);
    out[i] = __fsqrt_rn(__ldg(x + off[0]));
  }
}

// The layout from the host's arrays: sizes[ndim], strides[ops * ndim]
// (operand-major). Fails unless 1 <= ndim <= kMaxDims and every size and
// stride is non-negative.
template <typename Index>
bool make_layout(int ndim, int ops, const int64_t* sizes, const int64_t* strides,
                 Layout<Index>& l) {
  if (ndim < 1 || ndim > kMaxDims) return false;
  l.total = 1;
  for (int d = 0; d < kMaxDims; ++d) {
    l.size[d] = 1;
    for (int k = 0; k < 3; ++k) l.stride[k][d] = 0;
  }
  for (int d = 0; d < ndim; ++d) {
    if (sizes[d] < 0) return false;
    l.size[d] = static_cast<Index>(sizes[d]);
    l.total *= l.size[d];
    for (int k = 0; k < ops; ++k) {
      if (strides[k * ndim + d] < 0) return false;
      l.stride[k][d] = static_cast<Index>(strides[k * ndim + d]);
    }
  }
  return true;
}

// True when every output index and every operand offset fits in an int32.
bool fits_32(int ndim, int ops, const int64_t* sizes, const int64_t* strides, int64_t extra) {
  int64_t total = 1;
  for (int d = 0; d < ndim; ++d) total *= sizes[d];
  if (total >= INT32_MAX) return false;
  for (int k = 0; k < ops; ++k) {
    int64_t span = extra;
    for (int d = 0; d < ndim; ++d) span += (sizes[d] > 0 ? sizes[d] - 1 : 0) * strides[k * ndim + d];
    if (span >= INT32_MAX) return false;
  }
  return true;
}

unsigned blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Index>
int fma_launch(const Scalars& s, int ndim, const int64_t* sizes, const int64_t* strides,
               float* out, cudaStream_t stream) {
  Layout<Index> l;
  if (!make_layout(ndim, 3, sizes, strides, l)) return static_cast<int>(cudaErrorInvalidValue);
  if (l.total == 0) return 0;
  const unsigned blocks = blocks_for(l.total);
  switch (ndim) {
    case 1: apx_fma_f32<1, Index><<<blocks, kThreads, 0, stream>>>(s, l, out); break;
    case 2: apx_fma_f32<2, Index><<<blocks, kThreads, 0, stream>>>(s, l, out); break;
    case 3: apx_fma_f32<3, Index><<<blocks, kThreads, 0, stream>>>(s, l, out); break;
    default: apx_fma_f32<4, Index><<<blocks, kThreads, 0, stream>>>(s, l, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int sum_squares_launch(const float* x, int ndim, const int64_t* sizes, const int64_t* strides,
                       int k, int64_t k_stride, float* out, cudaStream_t stream) {
  Layout<Index> l;
  if (k < 1 || k_stride < 0 || !make_layout(ndim, 1, sizes, strides, l))
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.total == 0) return 0;
  const unsigned blocks = blocks_for(l.total);
  const Index ks = static_cast<Index>(k_stride);
  switch (ndim) {
    case 1: apx_sum_squares_f32<1, Index><<<blocks, kThreads, 0, stream>>>(x, l, k, ks, out); break;
    case 2: apx_sum_squares_f32<2, Index><<<blocks, kThreads, 0, stream>>>(x, l, k, ks, out); break;
    case 3: apx_sum_squares_f32<3, Index><<<blocks, kThreads, 0, stream>>>(x, l, k, ks, out); break;
    default: apx_sum_squares_f32<4, Index><<<blocks, kThreads, 0, stream>>>(x, l, k, ks, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Index>
int sqrt_launch(const float* x, int ndim, const int64_t* sizes, const int64_t* strides,
                float* out, cudaStream_t stream) {
  Layout<Index> l;
  if (!make_layout(ndim, 1, sizes, strides, l)) return static_cast<int>(cudaErrorInvalidValue);
  if (l.total == 0) return 0;
  const unsigned blocks = blocks_for(l.total);
  switch (ndim) {
    case 1: apx_sqrt_f32<1, Index><<<blocks, kThreads, 0, stream>>>(x, l, out); break;
    case 2: apx_sqrt_f32<2, Index><<<blocks, kThreads, 0, stream>>>(x, l, out); break;
    case 3: apx_sqrt_f32<3, Index><<<blocks, kThreads, 0, stream>>>(x, l, out); break;
    default: apx_sqrt_f32<4, Index><<<blocks, kThreads, 0, stream>>>(x, l, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/core/numerics.py).
// Pointers are device pointers to float32 elements (a, b, c may be null:
// then the operand is va, vb, vc); sizes (ndim) and strides (one row of
// ndim element strides per operand) are host arrays, read before the
// function returns, so the launch can be captured in a CUDA graph. out is
// contiguous. Launches on `stream` and returns the CUDA error of the
// launch (0 on success).
extern "C" int fma_f32_launch(const void* a, const void* b, const void* c, float va, float vb,
                              float vc, int ndim, const int64_t* sizes, const int64_t* strides,
                              void* out, void* stream) {
  if (ndim < 1 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{{static_cast<const float*>(a), static_cast<const float*>(b),
                   static_cast<const float*>(c)},
                  {va, vb, vc}};
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return fits_32(ndim, 3, sizes, strides, 0)
             ? fma_launch<uint32_t>(s, ndim, sizes, strides, o, st)
             : fma_launch<int64_t>(s, ndim, sizes, strides, o, st);
}

extern "C" int sum_squares_f32_launch(const void* x, int ndim, const int64_t* sizes,
                                      const int64_t* strides, int k, int64_t k_stride, void* out,
                                      void* stream) {
  if (ndim < 1 || ndim > kMaxDims || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* xp = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return fits_32(ndim, 1, sizes, strides, (k - 1) * k_stride)
             ? sum_squares_launch<uint32_t>(xp, ndim, sizes, strides, k, k_stride, o, st)
             : sum_squares_launch<int64_t>(xp, ndim, sizes, strides, k, k_stride, o, st);
}

extern "C" int sqrt_f32_launch(const void* x, int ndim, const int64_t* sizes,
                               const int64_t* strides, void* out, void* stream) {
  if (ndim < 1 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  auto* xp = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return fits_32(ndim, 1, sizes, strides, 0)
             ? sqrt_launch<uint32_t>(xp, ndim, sizes, strides, o, st)
             : sqrt_launch<int64_t>(xp, ndim, sizes, strides, o, st);
}
