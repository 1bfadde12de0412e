// L: LightDark's step and its reset, each as one launch, hand-written for
// Hopper (sm_90a). L replaces no TPU kernel: apx's jitted step
// (apx/envs/light_dark.py:78-107) is XLA fusions, and so is its reset's
// observation. The plain forms are apx_torch/envs/light_dark.py's
// `step_plain` and `noisy_position` (N1-N3 at the contracted sites, ATen
// for the rest); each entry equals its plain form bitwise, NaN as NaN.
//
//   light_dark_step_launch (apx_light_dark_step): the whole step,
//     ss = fma(a1, a1, a0 * a0), |a| = sqrt(ss),
//     move = |a| > 1 ? a / |a| : a (true divisions),
//     p' = fma(move, move_scale, p), terminated = any(|p'| >= 1),
//     p' clipped to [-1, 1], obs = noisy(p', noise),
//     base_reward = fma(-1e-3, ss, 1), truncated = false;
//   light_dark_reset_launch (apx_light_dark_reset): obs = noisy(p, noise)
//     of the drawn positions.
//
// Both share `noisy`: b = h2 / (fma(dy, dy, dx * dx) + h2) with d = p -
// light (a true division), std = (1 - b) * scale, obs = clamp(fma(noise,
// std, p), -2, 2). The scale is an argument: the env's draws take the
// folded sqrt(2) * noise_scale, the drop-in's standard-normal draws the
// noise scale itself. Every operation is an explicitly rounded intrinsic,
// and the library is built with -fmad=false. The clamps keep a NaN, as
// torch.clamp does (fminf and fmaxf would drop it).
//
// What bounds them: the launch. The step reads 24 bytes per env (position,
// action, noise) and writes 22 (position, observation, base reward, two
// dones); the reset reads 16 and writes 8. At N = 16384 that is 0.75 MB,
// 0.22 us at 3.35 TB/s, against ~1.5 us for any launch. They replace 24
// launches (17 ATen, N1 x3, N2 x3, N3) and 9 (7 ATen, N1, N2).
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

struct Light {
  float x, y, h2;  // the light's position and its height squared
};

// torch.clamp: a NaN passes through.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float2 noisy(float2 p, float2 z, Light l, float scale) {
  const float dx = __fsub_rn(p.x, l.x), dy = __fsub_rn(p.y, l.y);
  const float dist_sq = __fadd_rn(__fmaf_rn(dy, dy, __fmul_rn(dx, dx)), l.h2);
  const float std = __fmul_rn(__fsub_rn(1.0f, __fdiv_rn(l.h2, dist_sq)), scale);
  return make_float2(clamp_keep_nan(__fmaf_rn(z.x, std, p.x), -2.0f, 2.0f),
                     clamp_keep_nan(__fmaf_rn(z.y, std, p.y), -2.0f, 2.0f));
}

__global__ void __launch_bounds__(kThreads)
apx_light_dark_step(const float2* __restrict__ pos, const float2* __restrict__ action,
                    const float2* __restrict__ noise, Light light, float move_scale,
                    float scale, int n, float2* __restrict__ pos_out,
                    float2* __restrict__ obs, float* __restrict__ base_reward,
                    bool* __restrict__ terminated, bool* __restrict__ truncated) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float2 a = __ldg(action + i), p = __ldg(pos + i);
  const float ss = __fmaf_rn(a.y, a.y, __fmul_rn(a.x, a.x));
  const float mag = __fsqrt_rn(ss);
  const bool over = mag > 1.0f;  // false for a NaN |a|: the action passes through
  const float mx = over ? __fdiv_rn(a.x, mag) : a.x;
  const float my = over ? __fdiv_rn(a.y, mag) : a.y;
  float2 q = make_float2(__fmaf_rn(mx, move_scale, p.x), __fmaf_rn(my, move_scale, p.y));
  terminated[i] = fabsf(q.x) >= 1.0f || fabsf(q.y) >= 1.0f;
  q = make_float2(clamp_keep_nan(q.x, -1.0f, 1.0f), clamp_keep_nan(q.y, -1.0f, 1.0f));
  pos_out[i] = q;
  obs[i] = noisy(q, __ldg(noise + i), light, scale);
  // f32(-1e-3), as the plain form's N1 takes it by value.
  base_reward[i] = __fmaf_rn(-1e-3f, ss, 1.0f);
  truncated[i] = false;
}

__global__ void __launch_bounds__(kThreads)
apx_light_dark_reset(const float2* __restrict__ pos, const float2* __restrict__ noise,
                     Light light, float scale, int n, float2* __restrict__ obs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  obs[i] = noisy(__ldg(pos + i), __ldg(noise + i), light, scale);
}

unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/light_dark_cuda.py).
// Pointers are device pointers to contiguous leaves, each (N, 2) float32
// leaf 8-byte aligned, base_reward (N,) float32, terminated and truncated
// (N,) bool; 0 <= N <= kMaxN. Launches on `stream` and returns the CUDA
// error of the launch (0 on success).
extern "C" int light_dark_step_launch(const void* pos, const void* action, const void* noise,
                                      float light_x, float light_y, float h2, float move_scale,
                                      float scale, int n, void* pos_out, void* obs,
                                      void* base_reward, void* terminated, void* truncated,
                                      void* stream) {
  if (n < 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_light_dark_step<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(action),
      static_cast<const float2*>(noise), Light{light_x, light_y, h2}, move_scale, scale, n,
      static_cast<float2*>(pos_out), static_cast<float2*>(obs), static_cast<float*>(base_reward),
      static_cast<bool*>(terminated), static_cast<bool*>(truncated));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int light_dark_reset_launch(const void* pos, const void* noise, float light_x,
                                       float light_y, float h2, float scale, int n, void* obs,
                                       void* stream) {
  if (n < 0 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_light_dark_reset<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(noise),
      Light{light_x, light_y, h2}, scale, n, static_cast<float2*>(obs));
  return static_cast<int>(cudaGetLastError());
}
