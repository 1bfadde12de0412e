// F2: the NEXT_STEP merge with the MSE loss and reward, hand-written for
// Hopper (sm_90a). The port's own kernel: apx has no Pallas twin, because
// XLA fuses the same work of apx's jitted vector step
// (apx/core/env.py:254-387) into a few fusions. Op by op in PyTorch it is
// ~25 launches a step (a where per leaf, the masks, the time limit's
// counter, the loss through N1/N2, the map obs); here it is one launch
// (apx_torch/ops/merge.py has the plain form):
//
//   * select segments, one per leaf of (obs, state, info): out = mask ?
//     reset : step per env, copied in the widest words (16, 8, 4, 2 or 1
//     bytes) that the leaf's bytes per env and pointers allow;
//   * a map segment: a bool leaf selected the same way, which also writes
//     the derived obs leaf[..., None] / divisor (LIDAR's map: {0, 1/255}),
//     four cells a thread where the cells per env allow;
//   * the env segment, one thread per env: the base reward and the dones
//     masked, the TimeLimit's counter (t + 1, out of time, the time obs
//     fma(2 t, f32(1 / T), -1) of the merged count), the MSE loss and the
//     reward, rounded as core/losses.py rounds them, masked to 0.
//
// Segments are ranges of one 1-D grid, found by block index. All
// arguments are passed by value (the leaf table too), so the launch does
// no host-to-device copy and can be captured in a CUDA graph.
//
// What bounds it: bytes. At N = 4096 on 32x32 maps it moves ~26 MB (one
// side's map read per env, the merged map and its 16 MB float obs
// written), ~7.8 us at 3.35 TB/s; the env segment is a few float32
// operations per env.
// Built with -fmad=false: every rounding site is written out.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxLeaves = 32;

// The launch's arguments, passed by value. They are declared outside the
// anonymous namespace: a parameter type of internal linkage would give the
// extern "C" entry point internal linkage too, and it would not be exported.
struct MergeLeaf {
  const void* step;
  const void* reset;
  void* out;
  int64_t words;        // words per env
  int32_t width;        // bytes per word: 1, 2, 4, 8 or 16
  int32_t first_block;  // the segment's first block
};

struct MergeLeaves {
  MergeLeaf leaf[kMaxLeaves];
  int32_t count;
  int32_t pad;
};

struct MergeMap {
  const uint8_t* step;  // (N, cells) bool; null: no map segment
  const uint8_t* reset;
  uint8_t* out_leaf;
  float* out_obs;
  int64_t cells;  // per env
  float divisor;
  int32_t vec4;  // four cells a thread (cells % 4 == 0, pointers aligned)
  int32_t first_block;
  int32_t pad;
};

struct MergeTerms {
  const bool* mask;
  const float* base_reward;
  const bool* terminated;
  const bool* truncated;
  const float* prediction;  // (N, d)
  const float* target;      // (N, d)
  const int32_t* t;         // (N,) or null: no counter
  float* base_out;
  bool* terminated_out;
  bool* truncated_out;
  bool* done_out;
  float* loss_out;
  float* reward_out;
  int32_t* t_out;
  float* time_out;  // null: no time obs
  int32_t n;
  int32_t d;
  int32_t limit;
  int32_t issue_termination;
  int32_t fused_sum;
  int32_t affine;
  int32_t contract;
  int32_t first_block;
  float inv_limit;
  float scale;
  float offset;
  float k;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFeatures = 8;

template <typename Word>
__device__ __forceinline__ void select_words(const MergeLeaf& l, bool m, int64_t i) {
  const Word* src = static_cast<const Word*>(m ? l.reset : l.step);
  static_cast<Word*>(l.out)[i] = src[i];
}

__device__ void select_segment(const MergeLeaf& l, const bool* mask, int n, int64_t i) {
  if (i >= static_cast<int64_t>(n) * l.words) return;
  const bool m = mask[i / l.words];
  switch (l.width) {
    case 16: select_words<uint4>(l, m, i); break;
    case 8: select_words<uint2>(l, m, i); break;
    case 4: select_words<uint32_t>(l, m, i); break;
    case 2: select_words<uint16_t>(l, m, i); break;
    default: select_words<uint8_t>(l, m, i); break;
  }
}

__device__ __forceinline__ float scaled(uint32_t byte, float divisor) {
  // bool -> float32 (nonzero is 1), then a true division, as
  // leaf.to(float32) / divisor rounds.
  return __fdiv_rn(byte != 0u ? 1.0f : 0.0f, divisor);
}

__device__ void map_segment(const MergeMap& p, const bool* mask, int n, int64_t i) {
  if (p.vec4) {
    if (i >= static_cast<int64_t>(n) * (p.cells / 4)) return;
    const bool m = mask[(4 * i) / p.cells];
    const uint32_t v = reinterpret_cast<const uint32_t*>(m ? p.reset : p.step)[i];
    reinterpret_cast<uint32_t*>(p.out_leaf)[i] = v;
    reinterpret_cast<float4*>(p.out_obs)[i] =
        make_float4(scaled(v & 0xffu, p.divisor), scaled((v >> 8) & 0xffu, p.divisor),
                    scaled((v >> 16) & 0xffu, p.divisor), scaled(v >> 24, p.divisor));
  } else {
    if (i >= static_cast<int64_t>(n) * p.cells) return;
    const bool m = mask[i / p.cells];
    const uint8_t v = (m ? p.reset : p.step)[i];
    p.out_leaf[i] = v;
    p.out_obs[i] = scaled(v, p.divisor);
  }
}

__device__ void env_segment(const MergeTerms& e, int i) {
  if (i >= e.n) return;
  const bool m = e.mask[i];
  bool term = e.terminated[i], trunc = e.truncated[i];
  if (e.t != nullptr) {
    const int32_t t1 = e.t[i] + 1;
    const bool out_of_time = t1 >= e.limit;
    if (e.issue_termination) term = term || out_of_time;
    else trunc = trunc || out_of_time;
    const int32_t t = m ? 0 : t1;
    e.t_out[i] = t;
    if (e.time_out != nullptr)  // time_obs: fma(2 * float(t), f32(1 / T), -1)
      e.time_out[i] = __fmaf_rn(__fmul_rn(2.0f, __int2float_rn(t)), e.inv_limit, -1.0f);
  }
  term = !m && term;
  trunc = !m && trunc;
  e.terminated_out[i] = term;
  e.truncated_out[i] = trunc;
  e.done_out[i] = term || trunc;
  const float base = e.base_reward[i];
  e.base_out[i] = m ? 0.0f : base;
  // The sum of squares of p - t: x0 * x0, then an FMA per further element
  // (fused_sum), or the rounded squares summed left to right (d <= 2).
  const float* p = e.prediction + static_cast<size_t>(e.d) * i;
  const float* q = e.target + static_cast<size_t>(e.d) * i;
  float x = __fsub_rn(p[0], q[0]);
  float s = __fmul_rn(x, x);
  for (int j = 1; j < e.d; ++j) {
    x = __fsub_rn(p[j], q[j]);
    s = e.fused_sum ? __fmaf_rn(x, x, s) : __fadd_rn(s, __fmul_rn(x, x));
  }
  float loss = __fdiv_rn(s, static_cast<float>(e.d));
  if (e.affine) loss = __fadd_rn(__fmul_rn(loss, e.scale), e.offset);
  const float reward = e.contract ? __fmaf_rn(s, -e.k, base) : __fsub_rn(base, loss);
  e.loss_out[i] = m ? 0.0f : loss;
  e.reward_out[i] = m ? 0.0f : reward;
}

__global__ void __launch_bounds__(kThreads)
apx_merge_next_step(MergeLeaves leaves, MergeMap map, MergeTerms terms) {
  const int block = blockIdx.x;
  if (block >= terms.first_block) {
    env_segment(terms, (block - terms.first_block) * kThreads + threadIdx.x);
    return;
  }
  if (map.step != nullptr && block >= map.first_block) {
    map_segment(map, terms.mask, terms.n,
                static_cast<int64_t>(block - map.first_block) * kThreads + threadIdx.x);
    return;
  }
  int l = 0;
  while (l + 1 < leaves.count && block >= leaves.leaf[l + 1].first_block) ++l;
  const MergeLeaf& leaf = leaves.leaf[l];
  select_segment(leaf, terms.mask, terms.n,
                 static_cast<int64_t>(block - leaf.first_block) * kThreads + threadIdx.x);
}

int64_t blocks(int64_t work) { return (work + kThreads - 1) / kThreads; }

}  // namespace

// Plain C interface, bound with ctypes (apx_torch/ops/merge_cuda.py). The
// three structs are passed by value; their pointers are device pointers to
// contiguous tensors. Segments take consecutive blocks in the order
// leaves, map, env; the host sets each first_block, and this function
// checks them against the work before it launches on `stream`. Returns the
// CUDA error of the launch (0 on success).
extern "C" int merge_next_step_launch(MergeLeaves leaves, MergeMap map, MergeTerms terms,
                                      void* stream) {
  if (terms.n < 0 || terms.d < 1 || terms.d > kMaxFeatures || leaves.count < 0 ||
      leaves.count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  if (terms.n == 0) return 0;
  int64_t next = 0;
  for (int l = 0; l < leaves.count; ++l) {
    const MergeLeaf& leaf = leaves.leaf[l];
    if (leaf.first_block != next || leaf.words < 1) return static_cast<int>(cudaErrorInvalidValue);
    next += blocks(static_cast<int64_t>(terms.n) * leaf.words);
  }
  if (map.step != nullptr) {
    if (map.first_block != next || map.cells < 1 || (map.vec4 && map.cells % 4 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    next += blocks(static_cast<int64_t>(terms.n) * (map.vec4 ? map.cells / 4 : map.cells));
  }
  if (terms.first_block != next) return static_cast<int>(cudaErrorInvalidValue);
  next += blocks(terms.n);
  if (next > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  apx_merge_next_step<<<static_cast<unsigned>(next), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(leaves, map, terms);
  return static_cast<int>(cudaGetLastError());
}
