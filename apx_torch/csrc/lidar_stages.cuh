// The LIDAR step's arithmetic per env, as device functions shared by F1
// (lidar_step.cu: one launch per stage, a thread per env) and S
// (lidar_fused.cu: the whole step in one launch, a warp per env). Each
// stage is the plain stage of the same name in apx_torch/ops/lidar_step.py,
// with every rounding site an instruction: __fmaf_rn where the plain code
// calls fma, __fsqrt_rn for roots, __fdiv_rn for true divisions,
// __fmul_rn / __fadd_rn / __fsub_rn for each rounded operator (the library
// is built with -fmad=false, so nvcc contracts nothing on its own).
// PyTorch's CUDA clamp, clamp_min and minimum are copied with their NaN
// tests before fminf / fmaxf, so signed zeros and NaNs come out as
// PyTorch's.

#pragma once

#include <cuda_runtime.h>

namespace {

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

// Stage A, before the move cast: the base reward, the action moved into
// the unit ball, its length and direction, the move's target and, where
// `unfused`, the move cast's |d| rounded unfused, in the frame of (b0, b1)
// when `framed` (a window's base).
struct StageA {
  float base_reward, total, dir0, dir1, move0, move1, seg;
};

__device__ __forceinline__ StageA lidar_stage_a(float x0, float x1, float p0, float p1,
                                                bool unfused, bool framed, float b0, float b1) {
  StageA s;
  // sum_squares(action): x0 * x0, then fma(x1, x1, acc).
  const float ss = __fmaf_rn(x1, x1, __fmul_rn(x0, x0));
  s.base_reward = __fmaf_rn(-1e-3f, ss, 0.1f);
  // normalize_into_unit_ball: |x| = sqrt(ss), a true division where |x| > 1.
  const float mag = __fsqrt_rn(ss);
  const float den = mag == 0.0f ? 1.0f : mag;
  const bool scale = mag > 1.0f;
  const float a0 = scale ? __fdiv_rn(x0, den) : x0;
  const float a1 = scale ? __fdiv_rn(x1, den) : x1;
  // seg_length(a) = sqrt(fma(dy, dy, dx * dx)).
  s.total = __fsqrt_rn(__fmaf_rn(a1, a1, __fmul_rn(a0, a0)));
  const float t = s.total == 0.0f ? 1.0f : s.total;
  s.dir0 = __fdiv_rn(a0, t);
  s.dir1 = __fdiv_rn(a1, t);
  s.move0 = __fadd_rn(p0, a0);
  s.move1 = __fadd_rn(p1, a1);
  s.seg = 0.0f;
  if (unfused) {
    float o0 = p0, o1 = p1, q0 = s.move0, q1 = s.move1;
    if (framed) {
      o0 = __fsub_rn(p0, b0);
      o1 = __fsub_rn(p1, b1);
      q0 = __fsub_rn(s.move0, b0);
      q1 = __fsub_rn(s.move1, b1);
    }
    const float d0 = __fsub_rn(q0, o0), d1 = __fsub_rn(q1, o1);
    s.seg = __fsqrt_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)));
  }
  return s;
}

// Stage B, after the move cast's distance to the wall d2w: the position at
// the wall and the wall-slide candidates (cand row-major (2, 2)) with their
// targets.
struct StageB {
  float pos0, pos1, rem;
  int n_keep;
  float diag0, diag1;
  float cand[4], targets[4];
};

__device__ __forceinline__ StageB lidar_stage_b(float p0, float p1, float dir0, float dir1,
                                                float total, float d2w) {
  StageB s;
  s.pos0 = __fmaf_rn(dir0, d2w, p0);
  s.pos1 = __fmaf_rn(dir1, d2w, p1);
  s.rem = __fsub_rn(total, d2w);
  const float r0 = __fmul_rn(dir0, s.rem), r1 = __fmul_rn(dir1, s.rem);
  const bool k0 = r0 > kSlideEps, k1 = r1 > kSlideEps;
  s.n_keep = static_cast<int>(k0) + static_cast<int>(k1);
  // amax over where(keep, rem_vec, +0): the kept values are > 0 and never
  // NaN, so the order of the reduction cannot show.
  const float v0 = k0 ? r0 : 0.0f, v1 = k1 ? r1 : 0.0f;
  const float v = v0 > v1 ? v0 : v1;
  s.diag0 = s.n_keep == 2 ? r0 : v;
  s.diag1 = s.n_keep == 2 ? r1 : v;
  // eye(2) * cand_diag: the off-diagonal products are signed zeros.
  s.cand[0] = __fmul_rn(1.0f, s.diag0);
  s.cand[1] = __fmul_rn(0.0f, s.diag1);
  s.cand[2] = __fmul_rn(0.0f, s.diag0);
  s.cand[3] = __fmul_rn(1.0f, s.diag1);
  s.targets[0] = __fadd_rn(s.pos0, s.cand[0]);
  s.targets[1] = __fadd_rn(s.pos1, s.cand[1]);
  s.targets[2] = __fadd_rn(s.pos0, s.cand[2]);
  s.targets[3] = __fadd_rn(s.pos1, s.cand[3]);
  return s;
}

// Stage C, after the candidates' distances (dist0, dist1): the slide,
// termination, the odometry origin, the clip and the prediction target of
// the pre-step position (p0, p1). The beam targets are lidar_beam_end of
// the returned position.
struct StageC {
  float x, y, init0, init1, target0, target1;
  bool terminated;
};

__device__ __forceinline__ StageC lidar_stage_c(float p0, float p1, float q0, float q1,
                                                float total, float rem, int n_keep,
                                                const float cand[4], float diag0, float diag1,
                                                float dist0, float dist1, bool pending,
                                                float i0, float i1, float w, float h,
                                                float inv_w, float inv_h) {
  StageC s;
  const bool use0 = dist0 > 0.0f;
  const float c0 = use0 ? cand[0] : cand[2], c1 = use0 ? cand[1] : cand[3];
  const float sel_diag = use0 ? diag0 : diag1;
  const float sel_dist = use0 ? dist0 : dist1;
  const float den = sel_diag == 0.0f ? 1.0f : sel_diag;
  const bool moved = total > 0.0f;
  const bool slide = moved && rem > kSlideEps && n_keep > 0;
  float x = slide ? __fmaf_rn(__fdiv_rn(c0, den), sel_dist, q0) : q0;
  float y = slide ? __fmaf_rn(__fdiv_rn(c1, den), sel_dist, q1) : q1;
  x = moved ? x : p0;
  y = moved ? y : p1;
  s.terminated = (x < 0.0f || y < 0.0f) || (x >= w || y >= h);
  s.init0 = pending ? x : i0;
  s.init1 = pending ? y : i1;
  s.x = torch_minimum(torch_clamp_min(x, 0.0f), w);
  s.y = torch_minimum(torch_clamp_min(y, 0.0f), h);
  // fma(pos, 2.0 * inv_map_size, -1): the doubling is exact.
  s.target0 = __fmaf_rn(p0, __fmul_rn(2.0f, inv_w), -1.0f);
  s.target1 = __fmaf_rn(p1, __fmul_rn(2.0f, inv_h), -1.0f);
  return s;
}

// A beam's end on one axis: the position plus the beam's offset.
__device__ __forceinline__ float lidar_beam_end(float p, float offset) {
  return __fadd_rn(p, offset);
}

// Stage D, after the beam scan: a lidar value clamp(dist * inv_range, -1, 1)
// and an odometry component (pos - initial_pos) * inv_size.
__device__ __forceinline__ float lidar_value(float dist, float inv_range) {
  return torch_clamp(__fmul_rn(dist, inv_range), -1.0f, 1.0f);
}

__device__ __forceinline__ float odometry_value(float p, float initial, float inv_size) {
  return __fmul_rn(__fsub_rn(p, initial), inv_size);
}

}  // namespace
