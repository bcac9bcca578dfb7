// Shared helpers of the attention kernels: element conversion, the
// position mask, the whole-tile flag and the list of live tiles, the
// online-softmax constants, warp reductions, cp.async copies and the
// vector loads and stores of the CUDA-core instances.
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

__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The flag of one (q-tile, KV tile) pair from the position ranges of its
// real queries [qmin, qmax] and of its keys [kmin, kmax] (a missing key
// counts as padding): 0 dead (the Pallas `_tile_skip`: every key padding,
// causally after every query, or left of every query's window), 1 every
// key visible to every query, 2 masked element by element.
__device__ __forceinline__ int tile_flag(int qmin, int qmax, int kmin, int kmax, bool causal,
                                         bool windowed, int window) {
  bool skip = kmin >= kPadHalf;
  if (causal) skip = skip || qmax < kmin;
  if (windowed) skip = skip || kmax <= qmin - window;
  bool whole = kmax < kPadHalf;
  if (causal) whole = whole && qmin >= kmax;
  if (windowed) whole = whole && qmax - kmin < window;
  return skip ? 0 : (whole ? 1 : 2);
}

// Max and sum over the 16 lanes of one half-warp (the threads of the
// CUDA-core instances that share a tile row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Asynchronous copies from global to shared memory (cp.async): 16 bytes
// (bypassing L1) or 4; a false `pred` fills the destination with zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N = 4 or 2 consecutive elements (one vector load) widened to float32, and
// N float32 values stored as N elements of T (one vector store).
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[2]) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  x[0] = r.x, x[1] = r.y;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  x[0] = bf16_lo(r.x), x[1] = bf16_hi(r.x), x[2] = bf16_lo(r.y), x[3] = bf16_hi(r.y);
}
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&x)[2]) {
  const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
  x[0] = bf16_lo(r), x[1] = bf16_hi(r);
}
__device__ __forceinline__ void st_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st_vec(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(x[0], x[1]), bf16x2(x[2], x[3]));
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&x)[2]) {
  *reinterpret_cast<uint32_t*>(p) = bf16x2(x[0], x[1]);
}

// A live tile of a walk as one int: its index, and its `tile_flag` (1 or 2)
// at bit kFlagShift.
constexpr int kFlagShift = 28;
constexpr int kTileMask = (1 << kFlagShift) - 1;

// Run by one warp: the tiles of `flags[0, n)` that are not dead, in order,
// as entries (first + t) | flag << kFlagShift in `live`; their count in
// `*count`.
__device__ __forceinline__ void list_live(const uint8_t* flags, int n, int first, int* live,
                                          int* count) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    const int f = t < n ? flags[t] : 0;
    const unsigned ball = __ballot_sync(0xffffffffu, f != 0);
    if (f) live[total + __popc(ball & ((1u << lane) - 1))] = (first + t) | (f << kFlagShift);
    total += __popc(ball);
  }
  if (lane == 0) *count = total;
}

__device__ __forceinline__ bool is_neg_inf(float x) { return isinf(x) && x < 0.f; }

// The CUDA-core instances of kernels A, B1 and B2 (`core::Fwd`, `core::Dq`,
// `core::Dkv`).
namespace core {
constexpr int kThreads = 256;    // a 16 x 16 grid of threads over every tile
constexpr int kFlagChunk = 256;  // tiles of a walk whose flags one pass lists

// Run by one warp: the least and the greatest of p[0, n) into out[0] and
// out[1].
__device__ __forceinline__ void warp_range(const int* p, int n, int* out) {
  const int lane = threadIdx.x & 31;
  int lo = INT32_MAX, hi = INT32_MIN;
  for (int r = lane; r < n; r += 32) lo = min(lo, p[r]), hi = max(hi, p[r]);
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (lane == 0) out[0] = lo, out[1] = hi;
}

// A walk of a q-tile over KV tiles of BK keys (kernels A and B1): the flags
// of tiles c0 .. c0 + cn - 1 into flags[0, cn), one warp a tile, from the
// tile's key range (a key past Sk counts as padding) and the q-tile's
// position range [qmin, qmax].
template <int BK>
__device__ __forceinline__ void flag_kv_tiles(uint8_t* flags, const int* kpb, int Sk, int c0,
                                              int cn, int qmin, int qmax, bool causal,
                                              bool windowed, int window) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < cn; t += kThreads / 32) {
    const int base = (c0 + t) * BK;
    int lo = INT32_MAX, hi = INT32_MIN;
    for (int j = lane; j < BK; j += 32) {
      const int p = base + j < Sk ? kpb[base + j] : 2 * kPadHalf;
      lo = min(lo, p);
      hi = max(hi, p);
    }
    lo = warp_min_i(lo);
    hi = warp_max_i(hi);
    if (lane == 0) flags[t] = (uint8_t)tile_flag(qmin, qmax, lo, hi, causal, windowed, window);
  }
}

// The K and V rows of the KV tile at key k0 into a ring stage `dst` (BK rows
// of K, then BK of V, each of KS elements), 16 bytes a copy, rows past Sk
// zero; the keys' positions into kp[0, BK), 4 bytes a copy (past Sk: read
// nothing; the walk masks them by index).  kb, vb and kpb point at the
// batch row's (and KV head's) first key.
template <typename T, int D, int BK, int KS>
__device__ __forceinline__ void load_kv_tile(T* dst, int* kp, const T* kb, const T* vb,
                                             const int* kpb, size_t key_stride, int k0,
                                             int Sk) {
  constexpr int C = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T);
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * BK * C; i += kThreads) {
    const int which = i / (BK * C), r = (i / C) % BK, c = i % C;
    const bool ok = k0 + r < Sk;
    const T* src = (which ? vb : kb) + (size_t)(ok ? k0 + r : k0) * key_stride + c * E;
    cp_async16(dst + (which * BK + r) * KS + c * E, src, ok);
  }
  if (tid < BK) {
    const bool ok = k0 + tid < Sk;
    cp_async4(kp + tid, kpb + (ok ? k0 + tid : k0), ok);
  }
}
}  // namespace core

}  // namespace rt
