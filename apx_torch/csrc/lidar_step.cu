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
// One thread per env holds its operands in registers. The stages' bodies
// are lidar_stages.cuh's device functions, which S (lidar_fused.cu, the
// whole step in one launch on the whole-map backends) calls too; every
// rounding site of the plain stage is an instruction there. Each stage
// equals its plain form bitwise. Since S, F1 runs on the backends whose
// casts use a window (the bit windows, K2's, the per-cast windows, the
// one-hot window) and under the beam tables.
//
// What bounds it: the launch. A stage moves 20-100 bytes per env (about
// 0.1 MB at N = 4096, ~0.03 us at 3.35 TB/s) and does a few dozen float32
// operations per env. Blocks of 32 threads spread N = 4096 over 128 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lidar_stages.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_a(const float* __restrict__ action, const float* __restrict__ pos,
                 const float* __restrict__ base, int unfused, int n,
                 float* __restrict__ base_reward, float* __restrict__ total_out,
                 float* __restrict__ direction, float* __restrict__ move_to,
                 float* __restrict__ seg) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool framed = base != nullptr;
  const StageA a = lidar_stage_a(action[2 * i], action[2 * i + 1], pos[2 * i], pos[2 * i + 1],
                                 unfused != 0, framed, framed ? base[2 * i] : 0.0f,
                                 framed ? base[2 * i + 1] : 0.0f);
  base_reward[i] = a.base_reward;
  total_out[i] = a.total;
  direction[2 * i] = a.dir0;
  direction[2 * i + 1] = a.dir1;
  move_to[2 * i] = a.move0;
  move_to[2 * i + 1] = a.move1;
  if (unfused) seg[i] = a.seg;
}

__global__ void __launch_bounds__(kThreads)
apx_lidar_step_b(const float* __restrict__ pos, const float* __restrict__ direction,
                 const float* __restrict__ total, const float* __restrict__ d2w, int n,
                 float* __restrict__ pos1_out, float* __restrict__ rem_out,
                 int64_t* __restrict__ n_keep_out, float* __restrict__ cand_diag,
                 float* __restrict__ cand, float* __restrict__ cand_targets) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const StageB b = lidar_stage_b(pos[2 * i], pos[2 * i + 1], direction[2 * i],
                                 direction[2 * i + 1], total[i], d2w[i]);
  pos1_out[2 * i] = b.pos0;
  pos1_out[2 * i + 1] = b.pos1;
  rem_out[i] = b.rem;
  n_keep_out[i] = b.n_keep;
  cand_diag[2 * i] = b.diag0;
  cand_diag[2 * i + 1] = b.diag1;
  for (int k = 0; k < 4; ++k) {
    cand[4 * i + k] = b.cand[k];
    cand_targets[4 * i + k] = b.targets[k];
  }
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
  const float c[4] = {cand[4 * i], cand[4 * i + 1], cand[4 * i + 2], cand[4 * i + 3]};
  const StageC s = lidar_stage_c(
      pos[2 * i], pos[2 * i + 1], pos1[2 * i], pos1[2 * i + 1], total[i], rem[i],
      static_cast<int>(n_keep[i]), c, cand_diag[2 * i], cand_diag[2 * i + 1],
      cand_dist[2 * i], cand_dist[2 * i + 1], odo_pending[i], initial_pos[2 * i],
      initial_pos[2 * i + 1], map_size[0], map_size[1], inv_map_size[0], inv_map_size[1]);
  terminated[i] = s.terminated;
  truncated[i] = false;
  initial_out[2 * i] = s.init0;
  initial_out[2 * i + 1] = s.init1;
  odo_out[i] = false;
  pos_out[2 * i] = s.x;
  pos_out[2 * i + 1] = s.y;
  target[2 * i] = s.target0;
  target[2 * i + 1] = s.target1;
  float* bt = beam_targets + static_cast<size_t>(2 * beams) * i;
  for (int b = 0; b < beams; ++b) {
    bt[2 * b] = lidar_beam_end(s.x, beam_offsets[2 * b]);
    bt[2 * b + 1] = lidar_beam_end(s.y, beam_offsets[2 * b + 1]);
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
  for (int b = 0; b < beams; ++b) lidar[row + b] = lidar_value(dist[row + b], inv_range);
  odometry[2 * i] = odometry_value(pos[2 * i], initial_pos[2 * i], inv_map_size[0]);
  odometry[2 * i + 1] = odometry_value(pos[2 * i + 1], initial_pos[2 * i + 1], inv_map_size[1]);
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
