// K3: the batched bilinear glimpse, hand-written for Hopper (sm_90a).
//
// Replaces apx's Pallas TPU kernel apx/ops/glimpse_pallas.py (`_kernel`,
// launched by glimpse_batch_lane_major) and computes its function, which
// is also apx's einsum form apx/ops/glimpse.py extract_glimpse_batch: for
// env n, the (s0, s1) sensing grid centred at the normalized position
// pos[n] = (x, y) is sampled from the (H, W, C) image by bilinear
// interpolation and clipped to [0, 1]; uint8 images are divided by 255 on
// read. The plain PyTorch form is apx_torch/ops/glimpse.py.
//
// Design: one thread per output element (n, s, t, c). The TPU kernel puts
// 128 envs in the vector lanes and therefore reduces densely over all H
// rows and W columns, since every lane has its own sample window. A CUDA
// thread has its own addresses, so it uses the hat's sparsity instead:
// a coordinate clipped to [0, size - 1] has nonzero hat weight on the
// pixels floor(c) and floor(c) + 1 only. Each thread reads those <= 2 x 2
// taps, forms the row pass for its two columns, then the column pass, then
// the clip.
//
// What bounds it: bytes. Per output element it does some 50 float
// operations on 4 loads; per env the distinct pixels it must read are the
// sensor's footprint (at most 6 x 6 of a 28 x 28 image for a 5 x 5 sensor),
// which the threads of one env share through L1, plus 8 bytes of position
// and the output. At CircleSquare's shape (N = 4096) that is about 1 MB, so
// a launch is as short as the card's launch latency allows; PERF.md holds
// the bound and the measured time.
//
// Numerics: the library is built with -fmad=false and every operation is
// written with an explicitly rounded intrinsic, so nvcc contracts nothing.
// The one fused multiply-add is the centre pixel fma(pos, lim, (size-1)/2),
// which the jitted reference contracts and the plain form computes as an
// exact FMA too (apx_torch/core/numerics.py). Coordinates and hat weights
// are therefore bitwise those of the plain form; the plain form's dense
// products add exact zeros around the same two nonzero terms per pass, so
// the two agree to within float32 rounding of a 4-term bilinear.
// Positions are taken to be finite (the env clips them to [-1, 1]).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pixel(const float* p) { return *p; }

__device__ __forceinline__ float pixel(const uint8_t* p) {
  return __fdiv_rn(static_cast<float>(*p), 255.0f);
}

// Coordinate of sample i of an s-point grid axis, as glimpse_coords and
// interp_weights compute it: fma(p, lim, centre) + (i - (s-1)/2) * scale,
// clipped to [0, size - 1].
__device__ __forceinline__ float coord(float p, float lim, int size, int i, int s, float scale) {
  const float centre = __fmul_rn(0.5f, static_cast<float>(size - 1));
  const float pix = __fmaf_rn(p, lim, centre);
  const float off = __fmul_rn(__fsub_rn(static_cast<float>(i), __fmul_rn(0.5f, static_cast<float>(s - 1))),
                              scale);
  const float c = __fadd_rn(pix, off);
  return fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
}

// The two taps of coordinate c: pixel k0 = floor(c) with hat weight w0, and
// pixel k1 = k0 + 1 (clamped into the image) with weight w1, which is 0
// when k0 is the last pixel. Hats are max(0, 1 - |c - k|) as in the plain
// form.
__device__ __forceinline__ void taps(float c, int size, int& k0, int& k1, float& w0, float& w1) {
  const float f = floorf(c);
  k0 = static_cast<int>(f);
  w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, f))));
  if (k0 + 1 < size) {
    k1 = k0 + 1;
    w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, __fadd_rn(f, 1.0f)))));
  } else {
    k1 = k0;
    w1 = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
glimpse_kernel(const T* __restrict__ images, const float* __restrict__ pos,
               float* __restrict__ out, long long total, int h, int w, int c,
               int s0, int s1, float lim_x, float lim_y, float scale) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // Output layout (N, s0, s1, C), contiguous.
  const int ch = static_cast<int>(idx % c);
  const long long rest = idx / c;
  const int t = static_cast<int>(rest % s1);
  const int s = static_cast<int>((rest / s1) % s0);
  const long long n = rest / (static_cast<long long>(s1) * s0);

  const float r = coord(pos[2 * n + 1], lim_y, h, s, s0, scale);  // rows follow y
  const float q = coord(pos[2 * n], lim_x, w, t, s1, scale);      // columns follow x
  int r0, r1, q0, q1;
  float wr0, wr1, wq0, wq1;
  taps(r, h, r0, r1, wr0, wr1);
  taps(q, w, q0, q1, wq0, wq1);

  const T* img = images + n * h * w * c + ch;
  const float a00 = pixel(img + (static_cast<long long>(r0) * w + q0) * c);
  const float a01 = pixel(img + (static_cast<long long>(r0) * w + q1) * c);
  const float a10 = pixel(img + (static_cast<long long>(r1) * w + q0) * c);
  const float a11 = pixel(img + (static_cast<long long>(r1) * w + q1) * c);
  // Row pass for the two columns, then the column pass, then the clip.
  const float v0 = __fadd_rn(__fmul_rn(wr0, a00), __fmul_rn(wr1, a10));
  const float v1 = __fadd_rn(__fmul_rn(wr0, a01), __fmul_rn(wr1, a11));
  const float g = __fadd_rn(__fmul_rn(wq0, v0), __fmul_rn(wq1, v1));
  out[idx] = fminf(fmaxf(g, 0.0f), 1.0f);
}

template <typename T>
int launch(const void* images, const void* pos, void* out, int n, int h, int w, int c,
           int s0, int s1, float lim_x, float lim_y, float scale, void* stream) {
  if (n <= 0 || s0 <= 0 || s1 <= 0 || c <= 0) return 0;
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * s0 * s1 * c;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  glimpse_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(images), static_cast<const float*>(pos), static_cast<float*>(out),
      total, h, w, c, s0, s1, lim_x, lim_y, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/glimpse_cuda.py).
// Pointers are device pointers: images (N, H, W, C) float32 or uint8,
// pos (N, 2) float32 normalized (x, y), out (N, s0, s1, C) float32; all
// contiguous. lim_x, lim_y are sensor_pos_lim_pixels. Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int glimpse_f32_launch(const void* images, const void* pos, void* out, int n, int h,
                                  int w, int c, int s0, int s1, float lim_x, float lim_y,
                                  float scale, void* stream) {
  return launch<float>(images, pos, out, n, h, w, c, s0, s1, lim_x, lim_y, scale, stream);
}

extern "C" int glimpse_u8_launch(const void* images, const void* pos, void* out, int n, int h,
                                 int w, int c, int s0, int s1, float lim_x, float lim_y,
                                 float scale, void* stream) {
  return launch<uint8_t>(images, pos, out, n, h, w, c, s0, s1, lim_x, lim_y, scale, stream);
}
