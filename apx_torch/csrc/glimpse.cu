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
// What bounds it: bytes. An env's distinct reads are the sensor's pixel
// footprint (at most 2 s0 x 2 s1 x C) and its position; its write is
// s0 * s1 * C floats (4.9 MB at TinyImageNet's geometry and N = 4096).
// The float work per output is a 4-term bilinear and a clip. The first
// design (one thread per output element) was held back by issue, not by
// bytes: each thread decoded its index with 64-bit divisions, recomputed
// both coordinates and all four hats, and divided each uint8 tap by 255
// with a full IEEE division.
//
// Design: one warp per env, eight envs per 256-thread block, one lane per
// (column t, channel ch) of a sample row, s1 * C lanes a row.
//  * A lane computes its column's taps (pixel offsets k0, k1 and hat
//    weights w0, w1) once, into registers, and walks the sample rows; a
//    row's taps are the same in every lane, so the warp issues them once
//    per row. No index is divided in the loop.
//  * Where a row holds fewer than 32 elements the warp covers 32 / (s1 C)
//    rows at once (CircleSquare's 5 x 1 rows: five rows, 25 lanes); where
//    it holds more, a lane takes every 32nd element of the row.
//  * Consecutive lanes read consecutive bytes (or floats) of an image row
//    and write consecutive floats of the output, so loads and stores are
//    coalesced.
//  * uint8 pixels are converted with three instructions, q = x * r,
//    q + (x - 255 q) r with r = RN(1/255) and each step rounded, which
//    gives exactly __fdiv_rn(x, 255) for every x in 0..255 (checked over
//    all 256 values in tests/test_torch_glimpse.py), where one IEEE
//    division is a subroutine of dozens.
//  * Measured and set aside (PERF.md, PR 4): the taps per env in shared
//    memory with a flat element loop and 16-byte stores; a 256-entry table
//    of __fdiv_rn(i, 255) in shared memory for the uint8 conversion (a
//    shared load per tap instead of three instructions); the row pass
//    staged in shared memory once per footprint column; loads of four or
//    eight rows issued together. Each was slower.
//
// Numerics: the library is built with -fmad=false and every operation is
// written with an explicitly rounded intrinsic, so nvcc contracts nothing.
// The fused multiply-adds are the centre pixel fma(pos, lim, (size-1)/2),
// which the jitted reference contracts and the plain form computes as an
// exact FMA too (apx_torch/core/numerics.py), and the two of the uint8
// conversion, whose result is the correctly rounded quotient. Coordinates
// and hat weights are therefore bitwise those of the plain form; the
// bilinear keeps the first design's order (row pass v0, v1, column pass g,
// clip), and the plain form's dense products add exact zeros around the
// same two nonzero terms per pass, so the two agree to within float32
// rounding of a 4-term bilinear. Positions are taken to be finite (the env
// clips them to [-1, 1]).
//
// Optional index: with a non-null `index` (N,) int64, glimpse n reads image
// index[n] of `images` (M, H, W, C) instead of image n, so a glimpse can
// read a bank row (image_storage="gather") or several glimpses one image
// (the chunked unique-target sampler) without a copy. The index is the
// only change: one load per lane before the image pointer is formed. It is
// a template parameter, so the kernel without it compiles as it did
// before the index existed: taken as a run-time branch, the index slowed
// the uint8 64x64x3 glimpse from 6.8 to 8.0 us on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// The taps of one sample coordinate: element offsets of its two pixels in
// the image (row taps count in rows of W * C, column taps in C) and their
// hat weights.
struct Tap {
  int o0, o1;
  float w0, w1;
};

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
// form. `stride` turns pixel indices into element offsets.
__device__ __forceinline__ Tap taps(float c, int size, int stride) {
  const float f = floorf(c);
  const int k0 = static_cast<int>(f);
  Tap tap;
  tap.o0 = k0 * stride;
  tap.w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, f))));
  if (k0 + 1 < size) {
    tap.o1 = tap.o0 + stride;
    tap.w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, __fadd_rn(f, 1.0f)))));
  } else {
    tap.o1 = tap.o0;
    tap.w1 = 0.0f;
  }
  return tap;
}

__device__ __forceinline__ float pixel(const float* img, int i) { return img[i]; }

// x / 255 correctly rounded: the quotient estimate q = RN(x r), its exact
// remainder x - 255 q (one FMA), and one correction step.
__device__ __forceinline__ float pixel(const uint8_t* img, int i) {
  const float x = static_cast<float>(img[i]);
  const float r = 0x1.010102p-8f;  // RN(1 / 255)
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, x), r, q);
}

// rows_per_pass sample rows per pass of the warp, `active` lanes of it
// busy (see the design note); kIndexed: read image index[env].
template <typename T, bool kIndexed>
__global__ void __launch_bounds__(kWarps * 32)
glimpse_kernel(const T* __restrict__ images, const float* __restrict__ pos,
               const long long* __restrict__ index,
               float* __restrict__ out, int n, int h, int w, int c, int s0, int s1,
               float lim_x, float lim_y, float scale, int rows_per_pass, int active) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (env >= n || lane >= active) return;
  const int p = s1 * c;  // elements of one sample row
  const int s_sub = p >= 32 ? 0 : lane / p;
  const int j0 = p >= 32 ? lane : lane - s_sub * p;
  const int jstep = p >= 32 ? 32 : p;
  const float px = pos[2 * env], py = pos[2 * env + 1];
  const size_t row = kIndexed ? static_cast<size_t>(index[env]) : static_cast<size_t>(env);
  const T* img = images + row * h * w * c;
  float* dst = out + static_cast<size_t>(env) * s0 * p;  // (s0, s1, C), contiguous
  for (int j = j0; j < p; j += jstep) {
    const int t = j / c, ch = j - t * c;
    const Tap q = taps(coord(px, lim_x, w, t, s1, scale), w, c);  // columns follow x
    for (int s = s_sub; s < s0; s += rows_per_pass) {
      const Tap r = taps(coord(py, lim_y, h, s, s0, scale), h, w * c);  // rows follow y
      const float a00 = pixel(img, r.o0 + q.o0 + ch);
      const float a01 = pixel(img, r.o0 + q.o1 + ch);
      const float a10 = pixel(img, r.o1 + q.o0 + ch);
      const float a11 = pixel(img, r.o1 + q.o1 + ch);
      // Row pass for the two columns, then the column pass, then the clip.
      const float v0 = __fadd_rn(__fmul_rn(r.w0, a00), __fmul_rn(r.w1, a10));
      const float v1 = __fadd_rn(__fmul_rn(r.w0, a01), __fmul_rn(r.w1, a11));
      const float g = __fadd_rn(__fmul_rn(q.w0, v0), __fmul_rn(q.w1, v1));
      dst[s * p + j] = fminf(fmaxf(g, 0.0f), 1.0f);
    }
  }
}

template <typename T>
int launch(const void* images, const void* pos, const void* index, void* out, int n, int h,
           int w, int c, int s0, int s1, float lim_x, float lim_y, float scale, void* stream) {
  if (n <= 0 || s0 <= 0 || s1 <= 0 || c <= 0) return 0;
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int p = s1 * c;
  const int rows_per_pass = p >= 32 ? 1 : 32 / p;
  const int active = p >= 32 ? 32 : rows_per_pass * p;
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  const auto kernel = index != nullptr ? glimpse_kernel<T, true> : glimpse_kernel<T, false>;
  kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(images), static_cast<const float*>(pos),
      static_cast<const long long*>(index), static_cast<float*>(out),
      n, h, w, c, s0, s1, lim_x, lim_y, scale, rows_per_pass, active);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/glimpse_cuda.py).
// Pointers are device pointers: images (N, H, W, C) float32 or uint8 (or
// (M, H, W, C) with an index), pos (N, 2) float32 normalized (x, y), index
// (N,) int64 rows of `images` in [0, M) or null, out (N, s0, s1, C)
// float32; all contiguous. lim_x, lim_y are sensor_pos_lim_pixels.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).
extern "C" int glimpse_f32_launch(const void* images, const void* pos, const void* index,
                                  void* out, int n, int h, int w, int c, int s0, int s1,
                                  float lim_x, float lim_y, float scale, void* stream) {
  return launch<float>(images, pos, index, out, n, h, w, c, s0, s1, lim_x, lim_y, scale,
                       stream);
}

extern "C" int glimpse_u8_launch(const void* images, const void* pos, const void* index,
                                 void* out, int n, int h, int w, int c, int s0, int s1,
                                 float lim_x, float lim_y, float scale, void* stream) {
  return launch<uint8_t>(images, pos, index, out, n, h, w, c, s0, s1, lim_x, lim_y, scale,
                         stream);
}
