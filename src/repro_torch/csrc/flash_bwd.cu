// Kernels B1 and B2: flash-attention backward for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of `flash_attention_bwd_pallas` in
// src/repro/kernels/flash_attention.py: B1 `_bwd_dq_kernel` (dq) and B2
// `_bwd_dkv_kernel` (dk, dv), both built on the shared recompute
// `_bwd_p_ds`.  Per (query, key) pair of a live tile, with s = (q.k) * scale:
//   p  = exp(s - lse)                       (0 exactly where the key is masked)
//   dp = dout . v
//   ds = p * (dp - delta + dlse) * scale    delta = rowsum(dout * out)
//   dq = sum_k ds * k,  dk = sum_q ds * q,  dv = sum_q p * dout
// The `+ dlse` term carries the cotangent of the TokenRing partial's lse.
// Rows whose lse is -inf saw no key: their lse is taken as 0 and their dlse
// as 0, so every p of the row is 0 and its gradients are exactly 0.
// Inputs: q/dout (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) in float32 or bfloat16,
// lse/delta/dlse (B,Sq,Hq) float32, q_pos (B,Sq) / k_pos (B,Sk) int32.
// Outputs are float32: dq (B,Sq,Hq,D), dk/dv (B,Sk,Hkv,D).  Masks as kernel
// A: padding keys (PAD_POS//2 or above), causal, sliding window; query head
// h reads KV head h / (Hq/Hkv).
//
// Design.  Blocks of 128 threads, tiles of BQ = 32 queries by BK = 32 keys.
//  * B1 (dq): one block per (q-tile, query head, batch row) holds the q and
//    dout tiles and the tile's lse/delta/dlse in shared memory and walks the
//    KV tiles in order, accumulating dq in float32 registers.
//  * B2 (dk, dv): one block per (KV tile, KV head, batch row) holds the K/V
//    tile and walks every query head of its GQA group and every q-tile in a
//    fixed order, accumulating dk and dv in float32 registers.  The group
//    sum stays in the block: no atomics, so the gradients are bitwise the
//    same from run to run.  This is the card's form of the Pallas kernel's
//    sequential (group, q-tile) tail.
// Both kernels test a tile with the Pallas `_tile_skip` predicate (every key
// padding, causally after every query, or left of every query's window)
// before reading its K/V (B1) or its q/dout (B2), and skip it whole.  Sizes
// that are no multiple of the tiles are masked here: missing keys carry
// PAD_POS, missing query rows are masked out of B2's sums and never stored
// by B1.
//
// What bounds them: as kernel A, the products run on the CUDA cores in
// float32 out of shared memory (about 14*D flops per visible pair per head
// between the two kernels, against A's 4*D), so at the training shape they
// are bound by shared-memory bandwidth and the CUDA-core rate, far from the
// tensor-core rate (989 TFLOP/s bf16).  The score loops keep one key's K/V
// value (B1) or one query's q/dout value (B2) in a register across eight
// rows, and the accumulation loops read four scores per 16-byte load, to
// cut shared-memory reads per multiply-add.  wgmma, TMA and a pipelined
// ring of tiles are later work.
#include "common.cuh"

namespace rt {

constexpr int kBQ = 32;  // queries per tile
constexpr int kBKb = 32;  // keys per tile

// float32 words of B1's shared memory: q and dout tiles, padded K and V
// tiles, the ds tile and three per-row vectors.
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kBQ * D + 2 * kBKb * (D + 1) + kBQ * kBKb + 3 * kBQ) +
         sizeof(int) * (kBQ + kBKb);
}

// B2: K and V tiles, padded q and dout tiles, the transposed p and ds tiles
// and three per-row vectors.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kBKb * D + 2 * kBQ * (D + 1) + 2 * kBKb * kBQ + 3 * kBQ) +
         sizeof(int) * (kBQ + kBKb);
}

__device__ __forceinline__ bool is_neg_inf(float x) { return isinf(x) && x < 0.f; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ dlse, const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, float* __restrict__ dq, int Sq, int Sk,
                        int Hq, int Hkv, int causal, int has_window, int window, float scale) {
  static_assert(kThreads % D == 0 || D % kThreads == 0, "D must tile the block");
  static_assert(kBKb == 32 && (kBQ * kBKb) % kThreads == 0, "one key per lane");
  constexpr int RPT = kBQ * D / kThreads;    // dq rows per thread
  constexpr int RSTEP = kThreads / D;
  constexpr int SPT = kBQ * kBKb / kThreads;  // score rows per thread
  constexpr int SSTEP = kThreads / kBKb;
  constexpr int KS = D + 1;  // padded K/V row: lanes on distinct keys hit distinct banks

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + kBQ * D;
  float* sK = sDO + kBQ * D;
  float* sV = sK + kBKb * KS;
  float* sDS = sV + kBKb * KS;  // (BQ, BK), 16-byte aligned rows
  float* sL = sDS + kBQ * kBKb;
  float* sDelta = sL + kBQ;
  float* sDlse = sDelta + kBQ;
  int* sQp = reinterpret_cast<int*>(sDlse + kBQ);
  int* sKp = sQp + kBQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0, windowed = has_window != 0;
  const int nrows = min(kBQ, Sq - q0);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, s = q0 + r;
    const size_t off = (((size_t)b * Sq + s) * Hq + h) * D + i % D;
    sQ[i] = r < nrows ? to_f(q[off]) : 0.f;
    sDO[i] = r < nrows ? to_f(dout[off]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int s = q0 + r;
    float l = 0.f, dl = 0.f, de = 0.f;
    int qp = 0;
    if (r < nrows) {
      const size_t row = ((size_t)b * Sq + s) * Hq + h;
      l = lse[row];
      dl = dlse[row];
      de = delta[row];
      if (is_neg_inf(l)) l = dl = 0.f;
      qp = q_pos[(size_t)b * Sq + s];
    }
    sL[r] = l;
    sDlse[r] = dl;
    sDelta[r] = de;
    sQp[r] = qp;
  }
  __syncthreads();
  int qmin = INT32_MAX, qmax = INT32_MIN;
  for (int r = 0; r < nrows; ++r) {
    qmin = min(qmin, sQp[r]);
    qmax = max(qmax, sQp[r]);
  }

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % D;

  for (int k0 = 0; k0 < Sk; k0 += kBKb) {
    if (tid < kBKb) {
      const int j = k0 + tid;
      sKp[tid] = j < Sk ? k_pos[(size_t)b * Sk + j] : (2 * kPadHalf);
    }
    __syncthreads();
    int kmin = INT32_MAX, kmax = INT32_MIN;
    for (int j = 0; j < kBKb; ++j) {
      kmin = min(kmin, sKp[j]);
      kmax = max(kmax, sKp[j]);
    }
    bool skip = kmin >= kPadHalf;
    if (is_causal) skip = skip || qmax < kmin;
    if (windowed) skip = skip || kmax <= qmin - window;
    if (skip) {
      __syncthreads();
      continue;
    }
    for (int i = tid; i < kBKb * D; i += kThreads) {
      const int j = i / D, dd = i % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = (((size_t)b * Sk + kj) * Hkv + hk) * D + dd;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      sK[j * KS + dd] = kv;
      sV[j * KS + dd] = vv;
    }
    __syncthreads();
    {
      // Lane j owns key j; rows r = warp + SSTEP*i share its K/V value.
      const int j = lane;
      float s[SPT], dp[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int e = 0; e < D; ++e) {
        const float ke = sK[j * KS + e], ve = sV[j * KS + e];
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const int r = tid / kBKb + i * SSTEP;
          s[i] = fmaf(sQ[r * D + e], ke, s[i]);
          dp[i] = fmaf(sDO[r * D + e], ve, dp[i]);
        }
      }
      const int kp = sKp[j];
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int r = tid / kBKb + i * SSTEP;
        const float p = visible(sQp[r], kp, is_causal, windowed, window)
                            ? expf(s[i] * scale - sL[r])
                            : 0.f;
        sDS[r * kBKb + j] = p * (dp[i] - sDelta[r] + sDlse[r]) * scale;
      }
    }
    __syncthreads();
    // dq[r, d] += sum_j ds[r, j] * k[j, d], four keys per 16-byte load of ds.
#pragma unroll 2
    for (int j = 0; j < kBKb; j += 4) {
      const float k0v = sK[j * KS + d], k1v = sK[(j + 1) * KS + d];
      const float k2v = sK[(j + 2) * KS + d], k3v = sK[(j + 3) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tid / D + i * RSTEP;
        const float4 ds = *reinterpret_cast<const float4*>(sDS + r * kBKb + j);
        acc[i] = fmaf(ds.x, k0v, acc[i]);
        acc[i] = fmaf(ds.y, k1v, acc[i]);
        acc[i] = fmaf(ds.z, k2v, acc[i]);
        acc[i] = fmaf(ds.w, k3v, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tid / D + i * RSTEP;
    if (r < nrows) dq[(((size_t)b * Sq + q0 + r) * Hq + h) * D + d] = acc[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ dlse, const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos, float* __restrict__ dk,
                         float* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int causal,
                         int has_window, int window, float scale) {
  static_assert(kThreads % D == 0 || D % kThreads == 0, "D must tile the block");
  static_assert(kBQ == 32 && (kBQ * kBKb) % kThreads == 0, "one query per lane");
  constexpr int RPT = kBKb * D / kThreads;    // dk/dv rows per thread
  constexpr int RSTEP = kThreads / D;
  constexpr int SPT = kBQ * kBKb / kThreads;  // score keys per thread
  constexpr int SSTEP = kThreads / kBQ;
  constexpr int QS = D + 1;  // padded q/dout row: lanes on distinct queries hit distinct banks

  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kBKb * D;
  float* sPT = sV + kBKb * D;   // p transposed, (BK, BQ), 16-byte aligned rows
  float* sDST = sPT + kBKb * kBQ;  // ds transposed
  float* sQ = sDST + kBKb * kBQ;
  float* sDO = sQ + kBQ * QS;
  float* sL = sDO + kBQ * QS;
  float* sDelta = sL + kBQ;
  float* sDlse = sDelta + kBQ;
  int* sQp = reinterpret_cast<int*>(sDlse + kBQ);
  int* sKp = sQp + kBQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kBKb;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const bool is_causal = causal != 0, windowed = has_window != 0;
  const int nkeys = min(kBKb, Sk - k0);

  for (int i = tid; i < kBKb * D; i += kThreads) {
    const int j = i / D;
    float kv = 0.f, vv = 0.f;
    if (j < nkeys) {
      const size_t off = (((size_t)b * Sk + k0 + j) * Hkv + hk) * D + i % D;
      kv = to_f(k[off]);
      vv = to_f(v[off]);
    }
    sK[i] = kv;
    sV[i] = vv;
  }
  if (tid < kBKb) sKp[tid] = tid < nkeys ? k_pos[(size_t)b * Sk + k0 + tid] : (2 * kPadHalf);
  __syncthreads();
  int kmin = INT32_MAX, kmax = INT32_MIN;
  for (int j = 0; j < kBKb; ++j) {
    kmin = min(kmin, sKp[j]);
    kmax = max(kmax, sKp[j]);
  }

  float dk_acc[RPT], dv_acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int d = tid % D;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int t = 0; t < n_qtiles; ++t) {
      const int q0 = t * kBQ;
      const int nrows = min(kBQ, Sq - q0);
      if (tid < kBQ) sQp[tid] = tid < nrows ? q_pos[(size_t)b * Sq + q0 + tid] : 0;
      __syncthreads();
      int qmin = INT32_MAX, qmax = INT32_MIN;
      for (int r = 0; r < nrows; ++r) {
        qmin = min(qmin, sQp[r]);
        qmax = max(qmax, sQp[r]);
      }
      bool skip = kmin >= kPadHalf;
      if (is_causal) skip = skip || qmax < kmin;
      if (windowed) skip = skip || kmax <= qmin - window;
      __syncthreads();  // every thread has read sQp's range before it is rewritten
      if (skip) continue;
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, e = i % D;
        float qv = 0.f, dov = 0.f;
        if (r < nrows) {
          const size_t off = (((size_t)b * Sq + q0 + r) * Hq + h) * D + e;
          qv = to_f(q[off]);
          dov = to_f(dout[off]);
        }
        sQ[r * QS + e] = qv;
        sDO[r * QS + e] = dov;
      }
      if (tid < kBQ) {
        float l = 0.f, dl = 0.f, de = 0.f;
        if (tid < nrows) {
          const size_t row = ((size_t)b * Sq + q0 + tid) * Hq + h;
          l = lse[row];
          dl = dlse[row];
          de = delta[row];
          if (is_neg_inf(l)) l = dl = 0.f;
        }
        sL[tid] = l;
        sDlse[tid] = dl;
        sDelta[tid] = de;
      }
      __syncthreads();
      {
        // Lane r owns query r; keys j = warp + SSTEP*i share its q/dout value.
        const int r = lane;
        float s[SPT], dp[SPT];
#pragma unroll
        for (int i = 0; i < SPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
        for (int e = 0; e < D; ++e) {
          const float qe = sQ[r * QS + e], de = sDO[r * QS + e];
#pragma unroll
          for (int i = 0; i < SPT; ++i) {
            const int j = tid / kBQ + i * SSTEP;
            s[i] = fmaf(qe, sK[j * D + e], s[i]);
            dp[i] = fmaf(de, sV[j * D + e], dp[i]);
          }
        }
        const int qp = sQp[r];
        const bool row_ok = r < nrows;
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const int j = tid / kBQ + i * SSTEP;
          const float p = row_ok && visible(qp, sKp[j], is_causal, windowed, window)
                              ? expf(s[i] * scale - sL[r])
                              : 0.f;
          sPT[j * kBQ + r] = p;
          sDST[j * kBQ + r] = p * (dp[i] - sDelta[r] + sDlse[r]) * scale;
        }
      }
      __syncthreads();
      // dv[j, d] += sum_r p[r, j] * dout[r, d]; dk[j, d] += sum_r ds[r, j] * q[r, d].
#pragma unroll 2
      for (int r = 0; r < kBQ; r += 4) {
        float dov[4], qv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dov[u] = sDO[(r + u) * QS + d];
          qv[u] = sQ[(r + u) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int j = tid / D + i * RSTEP;
          const float4 p = *reinterpret_cast<const float4*>(sPT + j * kBQ + r);
          const float4 ds = *reinterpret_cast<const float4*>(sDST + j * kBQ + r);
          dv_acc[i] = fmaf(p.x, dov[0], dv_acc[i]);
          dv_acc[i] = fmaf(p.y, dov[1], dv_acc[i]);
          dv_acc[i] = fmaf(p.z, dov[2], dv_acc[i]);
          dv_acc[i] = fmaf(p.w, dov[3], dv_acc[i]);
          dk_acc[i] = fmaf(ds.x, qv[0], dk_acc[i]);
          dk_acc[i] = fmaf(ds.y, qv[1], dk_acc[i]);
          dk_acc[i] = fmaf(ds.z, qv[2], dk_acc[i]);
          dk_acc[i] = fmaf(ds.w, qv[3], dk_acc[i]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int j = tid / D + i * RSTEP;
    if (j < nkeys) {
      const size_t off = (((size_t)b * Sk + k0 + j) * Hkv + hk) * D + d;
      dk[off] = dk_acc[i];
      dv[off] = dv_acc[i];
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  const int *q_pos, *k_pos;
  int B, Sq, Sk, Hq, Hkv, causal, has_window, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, float* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dq, a.Sq, a.Sk,
      a.Hq, a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, float* dk, float* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((a.Sk + kBKb - 1) / kBKb, a.Hkv, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dk, dv, a.Sq,
      a.Sk, a.Hq, a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_dim(int D, const BwdArgs& a, float* dq) {
  switch (D) {
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: return launch_dq<T, 64>(a, dq);
    case 128: return launch_dq<T, 128>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_dim(int D, const BwdArgs& a, float* dk, float* dv) {
  switch (D) {
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: return launch_dkv<T, 64>(a, dk, dv);
    case 128: return launch_dkv<T, 128>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// C entries: each returns the cudaError_t of its launch (0 on success).
// `bf16` selects __nv_bfloat16 q/k/v/dout, else float32.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* dlse,
                            const void* q_pos, const void* k_pos, void* dq, int B, int Sq,
                            int Sk, int Hq, int Hkv, int D, int bf16, int causal,
                            int has_window, int window, float scale, void* stream) {
  const rt::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<const float*>(dlse),
                      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                      B, Sq, Sk, Hq, Hkv, causal, has_window, window, scale,
                      static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(dq);
  return bf16 ? (int)rt::dq_dim<__nv_bfloat16>(D, a, out) : (int)rt::dq_dim<float>(D, a, out);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* dlse,
                             const void* q_pos, const void* k_pos, void* dk, void* dv, int B,
                             int Sq, int Sk, int Hq, int Hkv, int D, int bf16, int causal,
                             int has_window, int window, float scale, void* stream) {
  const rt::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), static_cast<const float*>(dlse),
                      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
                      B, Sq, Sk, Hq, Hkv, causal, has_window, window, scale,
                      static_cast<cudaStream_t>(stream)};
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  return bf16 ? (int)rt::dkv_dim<__nv_bfloat16>(D, a, k_out, v_out)
              : (int)rt::dkv_dim<float>(D, a, k_out, v_out);
}
