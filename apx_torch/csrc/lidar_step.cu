// F1: the LIDAR step's arithmetic around K1, hand-written for Hopper
// (sm_90a). The port's own kernel: apx has no Pallas twin, because XLA
// fuses the same elementwise work of apx's jitted step
// (apx/envs/lidar_localization.py:538-615) into a few fusions. Op by op in
// PyTorch it is ~70 launches a step, and N1-N3 (numerics.cu) one launch per
// rounding site; here it is four launches, one per stage between K1's
// casts (apx_torch/ops/lidar_step.py has the plain stages):
//
//   lidar_step_a_launch: base reward, unit-ball action, |a|, direction, the
//                        move's target and its unfused |d| (optionally in a
//                        window's frame);
//   lidar_step_b_launch: the position at the wall, the wall-slide
//                        candidates and their targets;
//   lidar_step_c_launch: the slide, termination, odometry origin, clip,
//                        prediction target and beam targets;
//   lidar_step_d_launch: the lidar and odometry observations.
//
// One thread per env holds its operands in registers; every rounding site
// of the plain stage is an instruction here: __fmaf_rn where the plain code
// calls fma, __fsqrt_rn for roots, __fdiv_rn for true divisions, __fmul_rn /
// __fadd_rn / __fsub_rn for each rounded operator (the library is built
// with -fmad=false, so nvcc contracts nothing on its own). PyTorch's CUDA
// clamp, clamp_min and minimum are copied with their NaN tests before
// fminf / fmaxf, so signed zeros and NaNs come out as PyTorch's. Each
// stage equals its plain form bitwise.
//
// What bounds it: the launch. A stage moves 20-100 bytes per env (about
// 0.1 MB at N = 4096, ~0.03 us at 3.35 TB/s) and does a few dozen float32
// operations per env. Blocks of 32 threads spread N = 4096 over 128 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr float kSlideEps = 1e-5f;  // float(1e-5), as PyTorch compares

__device__ __forceinline__ float torch_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float torch_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_a(const float* __restrict__ action, const float* __restrict__ pos,
                 const float* __restrict__ base, int unfused, int n,
                 float* __restrict__ base_reward, float* __restrict__ total_out,
                 float* __restrict__ direction, float* __restrict__ move_to,
                 float* __restrict__ seg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x0 = action[2 * i], x1 = action[2 * i + 1];
  // sum_squares(action): x0 * x0, then fma(x1, x1, acc).
  const float ss = __fmaf_rn(x1, x1, __fmul_rn(x0, x0));
  base_reward[i] = __fmaf_rn(-1e-3f, ss, 0.1f);
  // normalize_into_unit_ball: |x| = sqrt(ss), a true division where |x| > 1.
  const float mag = __fsqrt_rn(ss);
  const float den = mag == 0.0f ? 1.0f : mag;
  const bool scale = mag > 1.0f;
  const float a0 = scale ? __fdiv_rn(x0, den) : x0;
  const float a1 = scale ? __fdiv_rn(x1, den) : x1;
  // seg_length(a) = sqrt(fma(dy, dy, dx * dx)).
  const float total = __fsqrt_rn(__fmaf_rn(a1, a1, __fmul_rn(a0, a0)));
  total_out[i] = total;
  const float t = total == 0.0f ? 1.0f : total;
  direction[2 * i] = __fdiv_rn(a0, t);
  direction[2 * i + 1] = __fdiv_rn(a1, t);
  const float p0 = pos[2 * i], p1 = pos[2 * i + 1];
  const float m0 = __fadd_rn(p0, a0), m1 = __fadd_rn(p1, a1);
  move_to[2 * i] = m0;
  move_to[2 * i + 1] = m1;
  if (unfused) {
    float o0 = p0, o1 = p1, q0 = m0, q1 = m1;
    if (base != nullptr) {
      const float b0 = base[2 * i], b1 = base[2 * i + 1];
      o0 = __fsub_rn(p0, b0);
      o1 = __fsub_rn(p1, b1);
      q0 = __fsub_rn(m0, b0);
      q1 = __fsub_rn(m1, b1);
    }
    const float d0 = __fsub_rn(q0, o0), d1 = __fsub_rn(q1, o1);
    seg[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
  }
}

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_b(const float* __restrict__ pos, const float* __restrict__ direction,
                 const float* __restrict__ total, const float* __restrict__ d2w, int n,
                 float* __restrict__ pos1_out, float* __restrict__ rem_out,
                 int64_t* __restrict__ n_keep_out, float* __restrict__ cand_diag,
                 float* __restrict__ cand, float* __restrict__ cand_targets) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float dir0 = direction[2 * i], dir1 = direction[2 * i + 1];
  const float d = d2w[i];
  const float p0 = __fmaf_rn(dir0, d, pos[2 * i]);
  const float p1 = __fmaf_rn(dir1, d, pos[2 * i + 1]);
  pos1_out[2 * i] = p0;
  pos1_out[2 * i + 1] = p1;
  const float rem = __fsub_rn(total[i], d);
  rem_out[i] = rem;
  const float r0 = __fmul_rn(dir0, rem), r1 = __fmul_rn(dir1, rem);
  const bool k0 = r0 > kSlideEps, k1 = r1 > kSlideEps;
  const int64_t n_keep = static_cast<int64_t>(k0) + static_cast<int64_t>(k1);
  n_keep_out[i] = n_keep;
  // amax over where(keep, rem_vec, +0): the kept values are > 0 and never
  // NaN, so the order of the reduction cannot show.
  const float v0 = k0 ? r0 : 0.0f, v1 = k1 ? r1 : 0.0f;
  const float v = v0 > v1 ? v0 : v1;
  const float c0 = n_keep == 2 ? r0 : v, c1 = n_keep == 2 ? r1 : v;
  cand_diag[2 * i] = c0;
  cand_diag[2 * i + 1] = c1;
  // eye(2) * cand_diag: the off-diagonal products are signed zeros.
  const float e01 = __fmul_rn(0.0f, c1), e10 = __fmul_rn(0.0f, c0);
  const float e00 = __fmul_rn(1.0f, c0), e11 = __fmul_rn(1.0f, c1);
  float* c = cand + 4 * i;
  float* t = cand_targets + 4 * i;
  c[0] = e00;
  c[1] = e01;
  c[2] = e10;
  c[3] = e11;
  t[0] = __fadd_rn(p0, e00);
  t[1] = __fadd_rn(p1, e01);
  t[2] = __fadd_rn(p0, e10);
  t[3] = __fadd_rn(p1, e11);
}

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_c(const float* __restrict__ pos, const float* __restrict__ pos1,
                 const float* __restrict__ total, const float* __restrict__ rem,
                 const int64_t* __restrict__ n_keep, const float* __restrict__ cand,
                 const float* __restrict__ cand_diag, const float* __restrict__ cand_dist,
                 const bool* __restrict__ odo_pending, const float* __restrict__ initial_pos,
                 const float* __restrict__ map_size, const float* __restrict__ inv_map_size,
                 const float* __restrict__ beam_offsets, int beams, int n,
                 float* __restrict__ pos_out, float* __restrict__ initial_out,
                 bool* __restrict__ odo_out, bool* __restrict__ terminated,
                 bool* __restrict__ truncated, float* __restrict__ target,
                 float* __restrict__ beam_targets) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool use0 = cand_dist[2 * i] > 0.0f;
  const float* c = cand + 4 * i + (use0 ? 0 : 2);
  const float sel_diag = cand_diag[2 * i + (use0 ? 0 : 1)];
  const float sel_dist = cand_dist[2 * i + (use0 ? 0 : 1)];
  const float den = sel_diag == 0.0f ? 1.0f : sel_diag;
  const float tot = total[i];
  const bool moved = tot > 0.0f;
  const bool slide = moved && rem[i] > kSlideEps && n_keep[i] > 0;
  const float w = map_size[0], h = map_size[1];
  const float q0 = pos1[2 * i], q1 = pos1[2 * i + 1];
  const float p0 = pos[2 * i], p1 = pos[2 * i + 1];
  float x = slide ? __fmaf_rn(__fdiv_rn(c[0], den), sel_dist, q0) : q0;
  float y = slide ? __fmaf_rn(__fdiv_rn(c[1], den), sel_dist, q1) : q1;
  x = moved ? x : p0;
  y = moved ? y : p1;
  terminated[i] = (x < 0.0f || y < 0.0f) || (x >= w || y >= h);
  truncated[i] = false;
  const bool pending = odo_pending[i];
  initial_out[2 * i] = pending ? x : initial_pos[2 * i];
  initial_out[2 * i + 1] = pending ? y : initial_pos[2 * i + 1];
  odo_out[i] = false;
  x = torch_minimum(torch_clamp_min(x, 0.0f), w);
  y = torch_minimum(torch_clamp_min(y, 0.0f), h);
  pos_out[2 * i] = x;
  pos_out[2 * i + 1] = y;
  // fma(pos, 2.0 * inv_map_size, -1): the doubling is exact.
  target[2 * i] = __fmaf_rn(p0, __fmul_rn(2.0f, inv_map_size[0]), -1.0f);
  target[2 * i + 1] = __fmaf_rn(p1, __fmul_rn(2.0f, inv_map_size[1]), -1.0f);
  float* bt = beam_targets + static_cast<size_t>(2 * beams) * i;
  for (int b = 0; b < beams; ++b) {
    bt[2 * b] = __fadd_rn(x, beam_offsets[2 * b]);
    bt[2 * b + 1] = __fadd_rn(y, beam_offsets[2 * b + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_d(const float* __restrict__ dist, const float* __restrict__ pos,
                 const float* __restrict__ initial_pos, float inv_range,
                 const float* __restrict__ inv_map_size, int beams, int n,
                 float* __restrict__ lidar, float* __restrict__ odometry) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(beams) * i;
  for (int b = 0; b < beams; ++b)
    lidar[row + b] = torch_clamp(__fmul_rn(dist[row + b], inv_range), -1.0f, 1.0f);
  odometry[2 * i] = __fmul_rn(__fsub_rn(pos[2 * i], initial_pos[2 * i]), inv_map_size[0]);
  odometry[2 * i + 1] =
      __fmul_rn(__fsub_rn(pos[2 * i + 1], initial_pos[2 * i + 1]), inv_map_size[1]);
}

unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/lidar_step_cuda.py).
// Every pointer is a device pointer to a contiguous tensor of the stage's
// shapes (row-major, env-major); base and seg of stage A may be null (no
// window frame; K1 computes the contracted length). Launches on `stream`
// and returns the CUDA error of the launch (0 on success).
extern "C" int lidar_step_a_launch(const void* action, const void* pos, const void* base,
                                   int unfused, int n, void* base_reward, void* total,
                                   void* direction, void* move_to, void* seg, void* stream) {
  if (n < 0 || (unfused && seg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_lidar_step_a<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(action), static_cast<const float*>(pos),
      static_cast<const float*>(base), unfused, n, static_cast<float*>(base_reward),
      static_cast<float*>(total), static_cast<float*>(direction), static_cast<float*>(move_to),
      static_cast<float*>(seg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lidar_step_b_launch(const void* pos, const void* direction, const void* total,
                                   const void* d2w, int n, void* pos1, void* rem, void* n_keep,
                                   void* cand_diag, void* cand, void* cand_targets,
                                   void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_lidar_step_b<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(direction),
      static_cast<const float*>(total), static_cast<const float*>(d2w), n,
      static_cast<float*>(pos1), static_cast<float*>(rem), static_cast<int64_t*>(n_keep),
      static_cast<float*>(cand_diag), static_cast<float*>(cand),
      static_cast<float*>(cand_targets));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lidar_step_c_launch(const void* pos, const void* pos1, const void* total,
                                   const void* rem, const void* n_keep, const void* cand,
                                   const void* cand_diag, const void* cand_dist,
                                   const void* odo_pending, const void* initial_pos,
                                   const void* map_size, const void* inv_map_size,
                                   const void* beam_offsets, int beams, int n, void* pos_out,
                                   void* initial_out, void* odo_out, void* terminated,
                                   void* truncated, void* target, void* beam_targets,
                                   void* stream) {
  if (n < 0 || beams < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_lidar_step_c<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(pos1),
      static_cast<const float*>(total), static_cast<const float*>(rem),
      static_cast<const int64_t*>(n_keep), static_cast<const float*>(cand),
      static_cast<const float*>(cand_diag), static_cast<const float*>(cand_dist),
      static_cast<const bool*>(odo_pending), static_cast<const float*>(initial_pos),
      static_cast<const float*>(map_size), static_cast<const float*>(inv_map_size),
      static_cast<const float*>(beam_offsets), beams, n, static_cast<float*>(pos_out),
      static_cast<float*>(initial_out), static_cast<bool*>(odo_out),
      static_cast<bool*>(terminated), static_cast<bool*>(truncated), static_cast<float*>(target),
      static_cast<float*>(beam_targets));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lidar_step_d_launch(const void* dist, const void* pos, const void* initial_pos,
                                   float inv_range, const void* inv_map_size, int beams, int n,
                                   void* lidar, void* odometry, void* stream) {
  if (n < 0 || beams < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_lidar_step_d<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const float*>(pos),
      static_cast<const float*>(initial_pos), inv_range,
      static_cast<const float*>(inv_map_size), beams, n, static_cast<float*>(lidar),
      static_cast<float*>(odometry));
  return static_cast<int>(cudaGetLastError());
}
