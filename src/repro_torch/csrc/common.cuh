// Shared helpers of the attention kernels: element conversion, the
// position mask, the online-softmax constants and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 128;           // 4 warps per block
constexpr int kPadHalf = 1 << 29;       // PAD_POS // 2: keys at or above are padding
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Key visibility: padding, causal, sliding window (the Pallas `_tile_mask`).
__device__ __forceinline__ bool visible(int qp, int kp, bool causal, bool has_window,
                                        int window) {
  bool m = kp < kPadHalf;
  if (causal) m = m && (qp >= kp);
  if (has_window) m = m && (qp - kp < window);
  return m;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One online-softmax step for one query row, run by a whole warp over the
// `n` scores at `p` (already masked to kNegInf): rewrites them as
// probabilities and updates the row's running max `m`, denominator `l` and
// the rescale factor `alpha` for its accumulator.  Written exactly as the
// Pallas body: safe_m guards rows that are still fully masked, and alpha is
// 0 while the previous max is still kNegInf.
template <typename MaskFn>
__device__ __forceinline__ void softmax_row(float* p, int n, MaskFn mask, float* m,
                                            float* l, float* alpha) {
  const int lane = threadIdx.x & 31;
  float mcur = kNegInf;
  for (int j = lane; j < n; j += 32) mcur = fmaxf(mcur, p[j]);
  mcur = warp_max(mcur);
  const float mprev = *m;
  const float mnew = fmaxf(mprev, mcur);
  const float safe = (mnew <= kNegInf / 2) ? 0.f : mnew;
  float psum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = mask(j) ? expf(p[j] - safe) : 0.f;
    p[j] = e;
    psum += e;
  }
  psum = warp_sum(psum);
  if (lane == 0) {
    const float a = (mprev <= kNegInf / 2) ? 0.f : expf(fminf(mprev - safe, 0.f));
    *alpha = a;
    *l = a * (*l) + psum;
    *m = mnew;
  }
}

}  // namespace rt
