// The MSE loss of one env and its reward, rounded as core/losses.py rounds
// them (its MSETerms): F2's env segment (merge.cu) and P's MSE function
// (loss.cu) both compute it. Built with -fmad=false: every rounding site is
// written out.

#pragma once

// p, q: the env's d features of prediction and target. The sum of squares
// of p - q: x0 * x0, then an FMA per further element (fused_sum), or the
// rounded squares summed left to right (d <= 2); the loss is that sum / d,
// then * scale + offset where affine; the reward fma(S, -k, base) where
// contract, else base - loss.
__device__ __forceinline__ void mse_loss_reward(const float* p, const float* q, int d,
                                                bool fused_sum, bool affine, float scale,
                                                float offset, bool contract, float k,
                                                float base, float& loss, float& reward) {
  float x = __fsub_rn(p[0], q[0]);
  float s = __fmul_rn(x, x);
  for (int j = 1; j < d; ++j) {
    x = __fsub_rn(p[j], q[j]);
    s = fused_sum ? __fmaf_rn(x, x, s) : __fadd_rn(s, __fmul_rn(x, x));
  }
  loss = __fdiv_rn(s, static_cast<float>(d));
  if (affine) loss = __fadd_rn(__fmul_rn(loss, scale), offset);
  reward = contract ? __fmaf_rn(s, -k, base) : __fsub_rn(base, loss);
}
