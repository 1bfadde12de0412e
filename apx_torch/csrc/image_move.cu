// M: the image envs' move and the step observation around the glimpse, as
// one launch, hand-written for Hopper (sm_90a). M replaces no TPU kernel:
// apx's jitted step (apx/envs/image_perception.py:237-287, `move` and
// `observe`) is XLA fusions around the Pallas glimpse. The plain form is
// apx_torch/envs/image_perception.py's `ImagePerceptionEngine.move_plain`
// (`move`, then `observe_rest`: N1-N3 at the contracted sites, ATen for
// the rest); M equals it bitwise, NaN as NaN.
//
//   image_move_launch (apx_image_move): per env,
//     ss = fma(a1, a1, a0 * a0), |a| = sqrt(ss),
//     proj = |a| > 1 ? a / |a| : a (project_sphere; true divisions),
//     p' = clamp(fma(max_step, proj, p), -1, 1),
//     base_reward = -|a| * f32(1e-3),
//     t' = t + 1 (wrapping, as an int32 add), terminated = t' >= limit,
//     time_step = fma(2 float(t'), f32(1 / limit), -1), truncated = false,
//     and, where labels are randomly inverted, inverted_label =
//     t' > 0 ? 2 : label_inverted.
//
// Every operation is an explicitly rounded intrinsic, and the library is
// built with -fmad=false. The clamp keeps a NaN, as torch.clamp does
// (fminf and fmaxf would drop it); a NaN |a| is not over 1, so the action
// passes through as torch.where passes it.
//
// What bounds it: the launch. It reads 20 bytes per env (position, action,
// time; 21 with the inversion) and writes 22 (position, time, base reward,
// time step, two dones; 26 with the inverted label). At N = 16384 that is
// 0.69 MB, 0.21 us at 3.35 TB/s, against ~1.5 us for any launch. It
// replaces about 20 launches (ATen, N1 x2, N2 x2, N3 x2).
//
// Design: one thread per env, 8-byte float2 loads and stores of each
// (N, 2) leaf, 256-thread blocks: N = 16384 is 64 blocks, a single wave,
// with no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The most envs: n + kThreads - 1 and the thread index stay in int.
constexpr int kMaxN = 2147483647 - (kThreads - 1);

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
apx_image_move(const float2* __restrict__ pos, const float2* __restrict__ action,
               const int* __restrict__ time, const bool* __restrict__ label_inverted,
               float max_step_x, float max_step_y, int step_limit, float inv_limit, int n,
               float2* __restrict__ pos_out, int* __restrict__ time_out,
               float* __restrict__ base_reward, bool* __restrict__ terminated,
               bool* __restrict__ truncated, float* __restrict__ time_step,
               int* __restrict__ inverted_label) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 a = __ldg(action + i), p = __ldg(pos + i);
  const float mag = __fsqrt_rn(__fmaf_rn(a.y, a.y, __fmul_rn(a.x, a.x)));
  const bool over = mag > 1.0f;  // false for a NaN |a|: the action passes through
  const float px = over ? __fdiv_rn(a.x, mag) : a.x;
  const float py = over ? __fdiv_rn(a.y, mag) : a.y;
  pos_out[i] = make_float2(clamp_keep_nan(__fmaf_rn(max_step_x, px, p.x), -1.0f, 1.0f),
                           clamp_keep_nan(__fmaf_rn(max_step_y, py, p.y), -1.0f, 1.0f));
  // f32(1e-3), as ATen's float multiply takes the Python scalar.
  base_reward[i] = __fmul_rn(-mag, 1e-3f);
  const int t = static_cast<int>(static_cast<unsigned>(__ldg(time + i)) + 1u);
  time_out[i] = t;
  terminated[i] = t >= step_limit;
  truncated[i] = false;
  time_step[i] = __fmaf_rn(__fmul_rn(2.0f, __int2float_rn(t)), inv_limit, -1.0f);
  if (inverted_label != nullptr) inverted_label[i] = t > 0 ? 2 : (label_inverted[i] ? 1 : 0);
}

unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/image_move_cuda.py).
// Pointers are device pointers to contiguous leaves: pos, action and
// pos_out (N, 2) float32, 8-byte aligned; time and time_out (N,) int32;
// base_reward and time_step (N,) float32; terminated and truncated (N,)
// bool. label_inverted ((N,) bool) and inverted_label ((N,) int32) are both
// null, or both given where labels are randomly inverted; 0 <= N <= kMaxN.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).
extern "C" int image_move_launch(const void* pos, const void* action, const void* time,
                                 const void* label_inverted, float max_step_x, float max_step_y,
                                 int step_limit, float inv_limit, int n, void* pos_out,
                                 void* time_out, void* base_reward, void* terminated,
                                 void* truncated, void* time_step, void* inverted_label,
                                 void* stream) {
  if (n < 0 || n > kMaxN || (label_inverted == nullptr) != (inverted_label == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_image_move<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(action),
      static_cast<const int*>(time), static_cast<const bool*>(label_inverted), max_step_x,
      max_step_y, step_limit, inv_limit, n, static_cast<float2*>(pos_out),
      static_cast<int*>(time_out), static_cast<float*>(base_reward),
      static_cast<bool*>(terminated), static_cast<bool*>(truncated),
      static_cast<float*>(time_step), static_cast<int*>(inverted_label));
  return static_cast<int>(cudaGetLastError());
}
