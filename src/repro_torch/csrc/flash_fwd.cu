// Kernel A: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd_pallas` (body
// `_fwd_kernel`) of src/repro/kernels/flash_attention.py.  Computes the
// mergeable TokenRing partial (out, lse) of position-masked attention:
//   q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in float32 or bfloat16, q_pos (B,Sq),
//   k_pos (B,Sk) int32 -> out (B,Sq,Hq,D) in q's type, lse (B,Sq,Hq) float32.
// Keys at PAD_POS//2 or above are padding; causal keeps q_pos >= k_pos;
// a window keeps q_pos - k_pos < window.  Query head h reads KV head
// h / (Hq/Hkv) (GQA without repeating KV).  A row that sees no key gives
// out = 0 and lse = -inf exactly.
//
// Design.  One block of 128 threads per (q-tile of BQ rows, query head,
// batch row) walks the KV tiles of BK = 32 keys in order, with the online
// softmax state (m, l) in shared memory and the f32 accumulator in
// registers.  A tile whose every key is padding, causally after every
// query or out of every query's window is skipped whole (the Pallas
// `_tile_skip` predicate), before its K/V are read.  Ragged edges (Sq or
// Sk not a multiple of the tile) are masked in the kernel: missing keys
// carry PAD_POS, missing rows are never stored.
//
// What bounds it: the products run on the CUDA cores in float32, one
// multiply-add per shared-memory read, so at the serving shapes this kernel
// is bound by shared-memory bandwidth and far from the tensor-core rate
// (989 TFLOP/s bf16).  It is the simple, exact first version: wgmma, TMA
// and a pipelined ring of tiles are later work.  Decode (Sq = 1) uses a
// 4-row q-tile, so three of the four rows are idle.
#include "common.cuh"

namespace rt {

constexpr int kBK = 32;  // keys per tile: one per lane in the softmax pass

template <int D, int BQ>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (BQ * D + kBK * (D + 1) + kBK * D + BQ * kBK + 3 * BQ) +
         sizeof(int) * (BQ + kBK);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                     int has_window, int window, float scale) {
  static_assert(kThreads % D == 0, "D must divide the block");
  static_assert((BQ * D) % kThreads == 0 && (BQ * kBK) % kThreads == 0, "tile split");
  constexpr int RPT = BQ * D / kThreads;  // accumulator rows per thread
  constexpr int RSTEP = kThreads / D;
  constexpr int SPT = BQ * kBK / kThreads;  // scores per thread
  constexpr int SSTEP = kThreads / kBK;
  constexpr int KS = D + 1;  // padded K row: lanes on distinct keys hit distinct banks

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * D;
  float* sV = sK + kBK * KS;
  float* sP = sV + kBK * D;
  float* sM = sP + BQ * kBK;
  float* sL = sM + BQ;
  float* sA = sL + BQ;
  int* sQp = reinterpret_cast<int*>(sA + BQ);
  int* sKp = sQp + BQ;
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0, windowed = has_window != 0;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, s = q0 + r;
    sQ[i] = s < Sq ? to_f(q[(((size_t)b * Sq + s) * Hq + h) * D + i % D]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    const int s = q0 + r;
    sQp[r] = s < Sq ? q_pos[(size_t)b * Sq + s] : 0;
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = INT32_MAX, hi = INT32_MIN;
    for (int r = 0; r < BQ && q0 + r < Sq; ++r) {
      lo = min(lo, sQp[r]);
      hi = max(hi, sQp[r]);
    }
    s_qmin = lo;
    s_qmax = hi;
  }

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % D;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    if (tid < kBK) {
      const int j = k0 + tid;
      sKp[tid] = j < Sk ? k_pos[(size_t)b * Sk + j] : (2 * kPadHalf);
    }
    __syncthreads();
    // Whole-tile skip: the Pallas `_tile_skip` predicate on this tile's
    // positions (uniform across the block, so the branch is too).
    int kmin = INT32_MAX, kmax = INT32_MIN;
    for (int j = 0; j < kBK; ++j) {
      kmin = min(kmin, sKp[j]);
      kmax = max(kmax, sKp[j]);
    }
    bool skip = kmin >= kPadHalf;
    if (is_causal) skip = skip || s_qmax < kmin;
    if (windowed) skip = skip || kmax <= s_qmin - window;
    if (skip) {
      __syncthreads();
      continue;
    }
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, dd = i % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = (((size_t)b * Sk + kj) * Hkv + hk) * D + dd;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      sK[j * KS + dd] = kv;
      sV[j * D + dd] = vv;
    }
    __syncthreads();
    {
      const int j = tid % kBK;
      const int kp = sKp[j];
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int r = tid / kBK + i * SSTEP;
        const float* qr = sQ + r * D;
        const float* kr = sK + j * KS;
        float s = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) s = fmaf(qr[e], kr[e], s);
        sP[r * kBK + j] = visible(sQp[r], kp, is_causal, windowed, window) ? s : kNegInf;
      }
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qp = sQp[r];
      softmax_row(
          sP + r * kBK, kBK,
          [&](int j) { return visible(qp, sKp[j], is_causal, windowed, window); },
          sM + r, sL + r, sA + r);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] *= sA[tid / D + i * RSTEP];
    for (int j = 0; j < kBK; ++j) {
      const float vv = sV[j * D + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(sP[(tid / D + i * RSTEP) * kBK + j], vv, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tid / D + i * RSTEP, s = q0 + r;
    if (s < Sq) {
      const float l = sL[r];
      const float o = l > 0.f ? acc[i] / l : 0.f;
      out[(((size_t)b * Sq + s) * Hq + h) * D + d] = from_f<T>(o);
    }
  }
  for (int r = tid; r < BQ; r += kThreads) {
    const int s = q0 + r;
    if (s < Sq) {
      const float l = sL[r];
      lse[((size_t)b * Sq + s) * Hq + h] = l > 0.f ? sM[r] + logf(l) : -INFINITY;
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* qp,
                       const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                       int Hkv, int causal, int has_window, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, BQ>();
  auto kern = flash_fwd_kernel<T, D, BQ>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qp, kp,
      static_cast<T*>(out), lse, Sq, Sk, Hq, Hkv, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t pick_rows(const void* q, const void* k, const void* v, const int* qp,
                      const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                      int Hkv, int causal, int has_window, int window, float scale,
                      cudaStream_t stream) {
  if (Sq <= 4)
    return launch_fwd<T, D, 4>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                               has_window, window, scale, stream);
  return launch_fwd<T, D, 32>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                              has_window, window, scale, stream);
}

template <typename T>
cudaError_t pick_dim(int D, const void* q, const void* k, const void* v, const int* qp,
                     const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                     int Hkv, int causal, int has_window, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return pick_rows<T, 32>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                              has_window, window, scale, stream);
    case 64:
      return pick_rows<T, 64>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                              has_window, window, scale, stream);
    case 128:
      return pick_rows<T, 128>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                               has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// C entry: returns the cudaError_t of the launch (0 on success).
// `bf16` selects __nv_bfloat16 inputs/outputs, else float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* q_pos,
                         const void* k_pos, void* out, void* lse, int B, int Sq, int Sk,
                         int Hq, int Hkv, int D, int bf16, int causal, int has_window,
                         int window, float scale, void* stream) {
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)rt::pick_dim<__nv_bfloat16>(D, q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv,
                                            causal, has_window, window, scale, s);
  return (int)rt::pick_dim<float>(D, q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv, causal,
                                  has_window, window, scale, s);
}
