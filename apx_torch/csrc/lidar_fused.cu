// S and R: the LIDAR env's step and reset, each as one launch, hand-written
// for Hopper (sm_90a). The port's own kernels: apx has no Pallas twin. Its
// jitted step (apx/envs/lidar_localization.py:538-615) is XLA fusions
// around three casts, and its reset (:493-537 with `_observe`) a fetch,
// a gather and the GEOS-typed scan, which under NEXT_STEP runs for every
// env on every step (apx/core/env.py:254-387). The plain forms are
// apx_torch/ops/lidar_fused.py (`step_plain`, `reset_plain`); each kernel
// equals its plain form bitwise.
//
//   lidar_fused_step_launch (S): F1's four stages (lidar_stages.cuh) and
//     K1's three casts (raycast_cast.cuh): the move (1 ray, the stage's
//     unfused |d|), the two wall-slide candidates and the beams (K1's own
//     contracted |d|), on the whole map;
//   lidar_fused_reset_launch (R): from the bank's row words, the map as the
//     `occ` leaf, the spawn position, the reset scan (typed, or untyped as
//     apx's "pallas" backend scans) and the observation, lidar =
//     clamp(dist / range, -1, 1) with a true division. R reads the row
//     words, the spawn cell and the dataset index from the bank itself
//     (MapBank.spawn's three gathers), or takes them gathered (a sharded
//     bank, the bit windows' row halves). Given a mask, it computes only
//     the envs the mask selects: under NEXT_STEP the merge (merge.cu)
//     reads the reset only where the env was done, one step in 101 on
//     LIDARLocRooms-v0, and apx's vmapped select computes both sides only
//     because XLA has no per-lane branch.
//
// What bounds them: the launch and the casts' instructions. S moves ~1.1 KB
// per env (the map's bytes, 64 bytes of operands and outputs), R ~1.1 KB
// (the row words, the map written once, the observation); at N = 4096 that
// is ~1.4 us at 3.35 TB/s. Before them the dense step was K1 x 3 and F1 x 4
// (seven launches, the map read and packed into bits three times) and the
// reset ~20 PyTorch operators (an (N, H, W) int64 unpack of the row words
// among them) and K1 typed, which read the unpacked map back.
//
// Design: one warp per env, eight envs per 256-thread block, as K1. The
// warp packs the env's map into bits in shared memory once. S reads the
// `occ` bytes (K1's packing). R builds them from the row words: lane k
// shifts word k of the row-major bits (cells 32k .. 32k + 31, which for
// W < 32 span rows) out of the rows' words, with no per-cell work, and
// writes the `occ` bytes from the bits, 16 cells per 16-byte store where
// the maps' size allows. Every lane computes the step's stages itself
// (the same operands, the same results: nothing to broadcast) and the
// casts run K1's pass over the bits. Lane j writes beam j; lane 0 the
// per-env outputs. A warp of R whose env the mask leaves out returns
// before it reads anything, and its slots of the outputs stay as they
// were; launches given a mask add the envs asked and computed to a device
// counter (apx_torch/core/trace.py), one atomic each per block that has
// any to add.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lidar_stages.cuh"
#include "raycast_cast.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// Lane 2j + a's end of beam base + j on axis a, from (x, y).
__device__ __forceinline__ float beam_end(const float* beam_offsets, int base, int count,
                                          int lane, float x, float y) {
  if ((lane >> 1) >= count) return 0.0f;
  return lidar_beam_end((lane & 1) ? y : x, beam_offsets[2 * base + lane]);
}

// Lane k's word k of the row-major map bits (cells 32k .. 32k + 31, 0 past
// H*W) from the rows' words, lane y holding row y's (W <= 32 bits), into
// bits[lane]. The cells of a word come from at most 1 + ceil(31 / W) rows:
// the rest of the first row (at least one cell), then whole rows.
__device__ __forceinline__ void pack_map_words(uint32_t row_word, int h, int w, int lane,
                                               uint32_t* bits) {
  const int first = 32 * lane;
  int y = first / w, x = first - y * w, filled = 0;
  uint32_t word = 0;
  const int rows = 1 + (31 + w - 1) / w;  // uniform across the warp
  for (int i = 0; i < rows; ++i) {
    const uint32_t r = __shfl_sync(kFull, row_word, min(y, 31));
    if (filled < 32 && y < h) {
      const int take = min(w - x, 32 - filled);
      const uint32_t mask = take == 32 ? kFull : (1u << take) - 1u;
      word |= ((r >> x) & mask) << filled;
      filled += take;
      y += 1;
      x = 0;
    }
  }
  bits[lane] = word;
  __syncwarp();
}

// The map's cells as bytes (1 = wall) at m, from its bits: sixteen cells a
// lane per 16-byte store where H*W is a multiple of 16 (so every env's map
// starts 16-byte aligned), else a cell a lane per byte store.
__device__ __forceinline__ void write_map_bytes(const uint32_t* bits, int hw, int lane,
                                                uint8_t* m) {
  if (hw % 16 == 0) {
    for (int q = lane; 16 * q < hw; q += 32) {
      const uint32_t half = (bits[q >> 1] >> (16 * (q & 1))) & 0xffffu;
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t nib = half >> (4 * j);
        out[j] = (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 |
                 ((nib >> 3) & 1u) << 24;
      }
      reinterpret_cast<uint4*>(m)[q] = make_uint4(out[0], out[1], out[2], out[3]);
    }
    return;
  }
  for (int c = lane; c < hw; c += 32) m[c] = wall_bit(bits, c);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apx_lidar_fused_step(const uint8_t* __restrict__ occ, const float* __restrict__ action,
                     const float* __restrict__ pos, const bool* __restrict__ odo_pending,
                     const float* __restrict__ initial_pos, const float* __restrict__ map_size,
                     const float* __restrict__ inv_map_size,
                     const float* __restrict__ beam_offsets, int beams, float inv_range,
                     float eps, int n, int h, int w, float* __restrict__ pos_out,
                     float* __restrict__ initial_out, bool* __restrict__ odo_out,
                     float* __restrict__ base_reward, bool* __restrict__ terminated,
                     bool* __restrict__ truncated, float* __restrict__ target,
                     float* __restrict__ lidar, float* __restrict__ odometry) {
  __shared__ uint32_t bits_all[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + warp;
  if (env >= n) return;  // uniform across the warp; no block barrier follows
  uint32_t* bits = bits_all[warp];

  // The env's operands, loaded before the map so that the latencies
  // overlap (every lane reads the same words).
  const float p0 = pos[2 * env], p1 = pos[2 * env + 1];
  const float x0 = action[2 * env], x1 = action[2 * env + 1];
  const bool pending = odo_pending[env];
  const float i0 = initial_pos[2 * env], i1 = initial_pos[2 * env + 1];
  pack_map_bytes(occ + static_cast<size_t>(env) * h * w, h * w, lane, bits);

  // Stage A, then the move cast with its unfused |d|.
  const StageA a = lidar_stage_a(x0, x1, p0, p1, true, false, 0.0f, 0.0f);
  float end = lane == 0 ? a.move0 : (lane == 1 ? a.move1 : 0.0f);
  const float d2w = __shfl_sync(
      kFull, cast_pass<false, false>(bits, h, w, p0, p1, lane, 1, end, a.seg, eps), 0);

  // Stage B, then the two wall-slide candidates from the position at the wall.
  const StageB b = lidar_stage_b(p0, p1, a.dir0, a.dir1, a.total, d2w);
  end = lane == 0 ? b.targets[0]
      : lane == 1 ? b.targets[1]
      : lane == 2 ? b.targets[2]
      : lane == 3 ? b.targets[3] : 0.0f;
  const float cd = cast_pass<false, true>(bits, h, w, b.pos0, b.pos1, lane, 2, end, 0.0f, eps);
  const float dist0 = __shfl_sync(kFull, cd, 0), dist1 = __shfl_sync(kFull, cd, 1);

  // Stage C, then the beams from the clipped position and stage D's lidar.
  const StageC c = lidar_stage_c(p0, p1, b.pos0, b.pos1, a.total, b.rem, b.n_keep, b.cand,
                                 b.diag0, b.diag1, dist0, dist1, pending, i0, i1, map_size[0],
                                 map_size[1], inv_map_size[0], inv_map_size[1]);
  const size_t row = static_cast<size_t>(env) * beams;
  for (int base = 0; base < beams; base += kRaysPerPass) {
    const int count = min(kRaysPerPass, beams - base);
    end = beam_end(beam_offsets, base, count, lane, c.x, c.y);
    const float dist = cast_pass<false, true>(bits, h, w, c.x, c.y, lane, count, end, 0.0f, eps);
    if (lane < count) lidar[row + base + lane] = lidar_value(dist, inv_range);
  }
  if (lane == 0) {
    pos_out[2 * env] = c.x;
    pos_out[2 * env + 1] = c.y;
    initial_out[2 * env] = c.init0;
    initial_out[2 * env + 1] = c.init1;
    odo_out[env] = false;
    base_reward[env] = a.base_reward;
    terminated[env] = c.terminated;
    truncated[env] = false;
    target[2 * env] = c.target0;
    target[2 * env + 1] = c.target1;
    odometry[2 * env] = odometry_value(c.x, c.init0, inv_map_size[0]);
    odometry[2 * env + 1] = odometry_value(c.y, c.init1, inv_map_size[1]);
  }
}

// Where R reads an env's row words and spawn cell. Gathered (bank_pos
// null): words (N, H) and flat (N,), row `env`. From the bank: words
// (rows, H), flat (rows, max_free) the free cells' row-major indices, and
// the draws bank_pos and k (N,): row bank_pos[env], cell flat[row, k[env]],
// and indices[row] (rows,) into map_idx (N,).
struct ResetSource {
  const int64_t* words;
  const int64_t* flat;
  const int64_t* bank_pos;
  const int64_t* k;
  const int64_t* indices;
  int64_t* map_idx;
  int rows;
  int max_free;
};

template <bool kTyped>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apx_lidar_fused_reset(ResetSource src, const bool* __restrict__ mask,
                      unsigned long long* __restrict__ counter,
                      const float* __restrict__ beam_offsets, int beams, float range,
                      const float* __restrict__ inv_map_size, float eps, int n, int h, int w,
                      uint8_t* __restrict__ occ, float* __restrict__ pos_out,
                      bool* __restrict__ odo_out, float* __restrict__ lidar,
                      float* __restrict__ odometry) {
  __shared__ uint32_t bits_all[kWarpsPerBlock][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + warp;
  // The env is computed where the mask (if any) selects it. The counter
  // (given with a mask) takes the block's count before any warp leaves,
  // since the count is a barrier of the whole block.
  const bool computed = env < n && (mask == nullptr || mask[env]);
  if (counter != nullptr) {  // uniform across the grid
    const int in_block = __syncthreads_count(computed && lane == 0);
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) atomicAdd(counter, static_cast<unsigned long long>(n));
      if (in_block > 0) atomicAdd(counter + 1, static_cast<unsigned long long>(in_block));
    }
  }
  if (!computed) return;  // uniform across the warp; no block barrier follows
  uint32_t* bits = bits_all[warp];

  // The env's row of words and its spawn cell's index, from the bank or
  // gathered; lane y holds row y's word (W <= 32 bits).
  int64_t row = env, f;
  if (src.bank_pos != nullptr) {
    row = src.bank_pos[env];
    const int64_t k = src.k[env];
    if (row < 0 || row >= src.rows || k < 0 || k >= src.max_free) __trap();  // as ATen's gather
    f = src.flat[row * src.max_free + k];
  } else {
    f = src.flat[env];
  }
  const uint32_t row_word =
      lane < h ? static_cast<uint32_t>(src.words[row * h + lane]) : 0u;

  // The map as H*W row-major bits: lane k builds word k (cells 32k ..
  // 32k + 31) from the rows' words, a row's bits at a time (for W < 32 a
  // word spans rows), then the map is written as the occ bytes.
  const int hw = h * w;
  pack_map_words(row_word, h, w, lane, bits);
  write_map_bytes(bits, hw, lane, occ + static_cast<size_t>(env) * hw);

  // The spawn position, the centre of cell (flat % W, flat // W).
  const int cell = static_cast<int>(f);  // < H*W <= 1024
  const float px = __fadd_rn(static_cast<float>(cell % w), 0.5f);
  const float py = __fadd_rn(static_cast<float>(cell / w), 0.5f);
  const size_t out_row = static_cast<size_t>(env) * beams;
  for (int base = 0; base < beams; base += kRaysPerPass) {
    const int count = min(kRaysPerPass, beams - base);
    const float end = beam_end(beam_offsets, base, count, lane, px, py);
    const float dist = cast_pass<kTyped, true>(bits, h, w, px, py, lane, count, end, 0.0f, eps);
    if (lane < count) {
      lidar[out_row + base + lane] = torch_clamp(__fdiv_rn(dist, range), -1.0f, 1.0f);
    }
  }
  if (lane == 0) {
    pos_out[2 * env] = px;
    pos_out[2 * env + 1] = py;
    odo_out[env] = true;
    odometry[2 * env] = odometry_value(px, px, inv_map_size[0]);
    odometry[2 * env + 1] = odometry_value(py, py, inv_map_size[1]);
    if (src.map_idx != nullptr) src.map_idx[env] = src.indices[row];
  }
}

template <bool kTyped>
void launch_reset(unsigned blocks, cudaStream_t stream, const ResetSource& src,
                  const void* mask, void* counter, const void* beam_offsets, int beams,
                  float range, const void* inv_map_size, float eps, int n, int h, int w,
                  void* occ, void* pos_out, void* odo_out, void* lidar, void* odometry) {
  apx_lidar_fused_reset<kTyped><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      src, static_cast<const bool*>(mask), static_cast<unsigned long long*>(counter),
      static_cast<const float*>(beam_offsets), beams, range,
      static_cast<const float*>(inv_map_size), eps, n, h, w, static_cast<uint8_t*>(occ),
      static_cast<float*>(pos_out), static_cast<bool*>(odo_out), static_cast<float*>(lidar),
      static_cast<float*>(odometry));
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

bool bad_shape(int n, int h, int w, int beams) {
  return n < 0 || beams < 0 || h < 1 || h > 32 || w < 1 || w > 32;
}

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/lidar_fused_cuda.py).
// Every pointer is a device pointer to a contiguous tensor: occ (N, H, W)
// bool as bytes, action, pos, initial_pos (N, 2) f32, odo_pending (N,)
// bool, map_size and inv_map_size (2,) f32, beam_offsets (B, 2) f32; the
// outputs pos, initial_pos, target, odometry (N, 2) f32, odo_pending,
// terminated, truncated (N,) bool, base_reward (N,) f32, lidar (N, B) f32.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).
extern "C" int lidar_fused_step_launch(const void* occ, const void* action, const void* pos,
                                       const void* odo_pending, const void* initial_pos,
                                       const void* map_size, const void* inv_map_size,
                                       const void* beam_offsets, int beams, float inv_range,
                                       float eps, int n, int h, int w, void* pos_out,
                                       void* initial_out, void* odo_out, void* base_reward,
                                       void* terminated, void* truncated, void* target,
                                       void* lidar, void* odometry, void* stream) {
  if (bad_shape(n, h, w, beams)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  apx_lidar_fused_step<<<blocks_for(n), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<const float*>(action),
      static_cast<const float*>(pos), static_cast<const bool*>(odo_pending),
      static_cast<const float*>(initial_pos), static_cast<const float*>(map_size),
      static_cast<const float*>(inv_map_size), static_cast<const float*>(beam_offsets), beams,
      inv_range, eps, n, h, w, static_cast<float*>(pos_out), static_cast<float*>(initial_out),
      static_cast<bool*>(odo_out), static_cast<float*>(base_reward),
      static_cast<bool*>(terminated), static_cast<bool*>(truncated), static_cast<float*>(target),
      static_cast<float*>(lidar), static_cast<float*>(odometry));
  return static_cast<int>(cudaGetLastError());
}

// words (N, H) int64 row words and flat (N,) int64 the spawn cells'
// row-major indices; or, with bank_pos, the bank's words (rows, H) and free
// cells flat (rows, max_free), the draws bank_pos and k (N,) int64 and the
// bank's dataset indices (rows,) int64, with map_idx (N,) int64 an output
// (ResetSource). mask (N,) bool or null: the envs to compute (null: all);
// counter (2,) int64 or null: adds N and the envs computed. Outputs occ
// (N, H, W) bool, pos (N, 2) f32, odo_pending (N,) bool, lidar (N, B) f32,
// odometry (N, 2) f32. `typed`: the GEOS-typed scan, else the untyped one.
extern "C" int lidar_fused_reset_launch(const void* words, const void* flat,
                                        const void* bank_pos, const void* k,
                                        const void* indices, int rows, int max_free,
                                        const void* mask, void* counter,
                                        const void* beam_offsets, int beams, float range,
                                        const void* inv_map_size, float eps, int typed, int n,
                                        int h, int w, void* occ, void* pos_out, void* odo_out,
                                        void* lidar, void* odometry, void* map_idx,
                                        void* stream) {
  if (bad_shape(n, h, w, beams)) return static_cast<int>(cudaErrorInvalidValue);
  if (bank_pos != nullptr && (rows < 1 || max_free < 1 || k == nullptr || indices == nullptr ||
                              map_idx == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const ResetSource src{static_cast<const int64_t*>(words), static_cast<const int64_t*>(flat),
                        static_cast<const int64_t*>(bank_pos), static_cast<const int64_t*>(k),
                        static_cast<const int64_t*>(indices), static_cast<int64_t*>(map_idx),
                        rows, max_free};
  const auto st = static_cast<cudaStream_t>(stream);
  if (typed) {
    launch_reset<true>(blocks_for(n), st, src, mask, counter, beam_offsets, beams, range,
                       inv_map_size, eps, n, h, w, occ, pos_out, odo_out, lidar, odometry);
  } else {
    launch_reset<false>(blocks_for(n), st, src, mask, counter, beam_offsets, beams, range,
                        inv_map_size, eps, n, h, w, occ, pos_out, odo_out, lidar, odometry);
  }
  return static_cast<int>(cudaGetLastError());
}
