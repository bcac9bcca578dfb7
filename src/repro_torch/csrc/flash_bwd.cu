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
// h reads KV head h / (Hq/Hkv).  B1 owns dq and B2 owns dk and dv: each
// block writes its own rows once, with sums in a fixed order and no
// atomics, so the gradients are bitwise the same from run to run.  Both
// test each tile pair with the Pallas `_tile_skip` predicate and skip it
// whole; ragged Sq and Sk are masked in the kernel.  One C entry per
// kernel picks the instance (`takes_wgmma_bwd`):
//
// * The wgmma instances (bf16, D 64 or 128: the training calls).  384
//   threads a block: warpgroup 0 is the producer, whose one thread keeps
//   TMA loads in flight (4-D tensor maps (D, H, S, B), 128-byte swizzle,
//   rows past S read as zero); warpgroups 1 and 2 are consumers.  Before
//   the roles split, the block writes one flag per tile of its walk (dead,
//   wholly visible, masked) to shared memory, so producer and consumers
//   walk the same live tiles and the mbarrier phases agree.  setmaxnreg
//   gives the consumers 240 registers and the producer 24.
//   - B1: one block per (128-row q-tile, query head, batch row); causal
//     grids start with the q-tiles that have the most live KV tiles.  The
//     producer loads the Q and dout tiles once, then 64-key K and V tiles
//     into a ring of 2 stages guarded by full/empty mbarriers.  Each
//     consumer owns 64 rows, holds their lse, delta and dlse in registers
//     and, per live KV tile: S = Q K^T and dP = dout V^T (wgmma m64n64k16,
//     every operand K-major from shared memory), P = exp(S*scale - lse)
//     (masked only on masked tiles), dS = P (dP - delta + dlse) scale in
//     place, then dQ += dS K with dS converted in place to bf16 as wgmma's
//     register A operand and K read as an MN-major B operand.  Shared
//     memory at D = 128: 2 x 32 KB of Q/dout and 2 x 32 KB of K/V.
//   - B2: one block per (64-key tile, KV head, batch row), key tiles in
//     index order (under the causal mask the first has the most live
//     q-tiles).  The producer loads the K and V tiles once, then walks
//     (group head, q-tile) in a fixed order, loading 64-row Q and dout
//     tiles into a 2-stage ring.  Both consumers hold the same 64 keys:
//     warpgroup 1 computes S^T = K Q^T and P^T (the row values along the
//     accumulator's columns: each lane loads two queries' lse, shuffled to
//     the lanes that hold them), hands P^T to warpgroup 2 through shared
//     memory (float32, fragment order, a third mbarrier per stage) and
//     accumulates dV += P^T dout; warpgroup 2 computes dP^T = V dout^T,
//     dS^T = P^T (dP^T - delta + dlse) scale and dK += dS^T Q.  P^T and
//     dS^T are bf16 register A operands, dout and Q MN-major B operands.
//     dK and dV stay in float32 registers across the whole walk, so the
//     GQA group sum stays in the block; each block stores them once.
//     Shared memory at D = 128: 32 KB of K/V, 2 x 32 KB of Q/dout and 2 x
//     16 KB of P^T.
//   Why these tiles: a consumer whose live accumulators pass about 128
//   floats a thread (S and dP of 64 x 128, or dK and dV of 64 x 128 with
//   S^T and dP^T) is held by ptxas to about 184 registers in spite of
//   setmaxnreg 240, spills and has every wgmma serialised (C7512), as B1
//   with 128-key tiles and B2 with one warpgroup owning dK and dV of its
//   64 keys did on an H100.
//   P and dS are rounded to bf16 for the dq, dk and dv products (the
//   float32 sums of S and dP are exact products of the bf16 inputs).
//   What bounds them: the tensor-core rate (989 TFLOP/s bf16) at the
//   training shape, 6*D (B1) and 8*D (B2) flops per visible (query, key,
//   head) pair.  What keeps them from it: within a warpgroup the
//   exponentials and dS run between products, with nothing in flight on
//   the tensor cores but the other warpgroup's work; in B2 the dK
//   warpgroup waits for the dV warpgroup's P^T on every tile, and every
//   64-key block streams the group's Q and dout again; each B1 block
//   recomputes S and dP that B2 computes again.
//
// * The CUDA-core instances (float32 inputs, and D = 32): the reference.
//   Blocks of 128 threads, tiles of BQ = 32 queries by BK = 32 keys, with
//   float32 products on the CUDA cores out of shared memory.
//   - B1 (dq): one block per (q-tile, query head, batch row) holds the q and
//     dout tiles and the tile's lse/delta/dlse in shared memory and walks
//     the KV tiles in order, accumulating dq in float32 registers.
//   - B2 (dk, dv): one block per (KV tile, KV head, batch row) holds the K/V
//     tile and walks every query head of its GQA group and every q-tile in
//     a fixed order, accumulating dk and dv in float32 registers.
//   The score loops keep one key's K/V value (B1) or one query's q/dout
//   value (B2) in a register across eight rows, and the accumulation loops
//   read four scores per 16-byte load.  Bound by shared-memory bandwidth
//   and the CUDA-core rate, far from the tensor-core rate; exact to
//   float32.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// bf16 calls with D 64/128 go to the wgmma instances: only float32
// instantiates the CUDA-core kernels at those widths.
template <typename T>
cudaError_t dq_dim(int D, const BwdArgs& a, float* dq) {
  constexpr bool f32 = std::is_same_v<T, float>;
  switch (D) {
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: if constexpr (f32) return launch_dq<T, 64>(a, dq);
      break;
    case 128: if constexpr (f32) return launch_dq<T, 128>(a, dq);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_dim(int D, const BwdArgs& a, float* dk, float* dv) {
  constexpr bool f32 = std::is_same_v<T, float>;
  switch (D) {
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: if constexpr (f32) return launch_dkv<T, 64>(a, dk, dv);
      break;
    case 128: if constexpr (f32) return launch_dkv<T, 128>(a, dk, dv);
      break;
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The wgmma instances: bf16, D in {64, 128}.
// ---------------------------------------------------------------------------

namespace wgb {

constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;         // depth of the ring
constexpr int kRowBytes = 128;     // one swizzled row: 64 bf16 columns
constexpr int kProducerRegs = 24;  // 128 * 24 + 256 * 240 = 384 * 168, the launch budget
constexpr int kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;   // the opt-in maximum of one block
constexpr int kDqRows = 128;       // B1: q rows per block
constexpr int kDqKeys = 64;        // B1: keys per KV tile
constexpr int kDkvKeys = 64;       // B2: keys per block
constexpr int kDkvRows = 64;       // B2: q rows per tile
constexpr float kLog2e = 1.4426950408889634f;

// A bf16 tile of ROWS rows by D columns in shared memory: D/64 swizzled
// regions of ROWS x 128 bytes, as D/64 TMA boxes write it.
template <int D, int ROWS>
struct Tile {
  static constexpr int kRegion = ROWS * kRowBytes;
  static constexpr int kBytes = (D / 64) * kRegion;
};

// Descriptor offsets, in the 16-byte units of the start-address field (no
// carry: shared addresses are < 2^18).  A K-major operand moves along the
// reduction dim (D) by 16 columns: 32 bytes within a 64-column region, then
// to the next region.  An MN-major operand moves along it by 16 rows.
__device__ __forceinline__ uint32_t kmajor_step(int kk, int region) {
  return static_cast<uint32_t>(((kk / 4) * region + (kk % 4) * 32) >> 4);
}
__device__ __forceinline__ uint32_t mnmajor_step(int kk) {
  return static_cast<uint32_t>((kk * 16 * kRowBytes) >> 4);
}

// B1's shared memory, from a 1024-byte aligned base: Q and dout, then per
// stage K and V, the mbarriers, the q-position range and one flag byte per
// KV tile.
template <int D>
struct DqSmem {
  using QT = Tile<D, kDqRows>;
  using KT = Tile<D, kDqKeys>;
  static constexpr int kQ = 0;
  static constexpr int kDO = QT::kBytes;
  static constexpr int kKV = 2 * QT::kBytes;  // stage s: K at kKV + 2*s*KT::kBytes, V after it
  static constexpr int kBars = kKV + 2 * kStages * KT::kBytes;  // full[], empty[], q
  static constexpr int kRange = kBars + 8 * (2 * kStages + 1);
  static constexpr int kFlags = kRange + 8;
  static size_t bytes(int n_tiles) { return 1024 + kFlags + static_cast<size_t>(n_tiles); }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ dlse, const int* __restrict__ q_pos,
                              const int* __restrict__ k_pos, float* __restrict__ dq, int B,
                              int Sq, int Sk, int Hq, int Hkv, int causal, int has_window,
                              int window, float scale) {
  using L = DqSmem<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  constexpr int BK = kDqKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;
  int* q_range = reinterpret_cast<int*>(smem + L::kRange);
  uint8_t* flags = smem + L::kFlags;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Sq + kDqRows - 1) / kDqRows, nk = (Sk + BK - 1) / BK;
  // Blocks in tile-major order; causal grids start with the q-tiles that
  // have the most live KV tiles.
  const int rank = blockIdx.x / (Hq * B), hb = blockIdx.x % (Hq * B);
  const int qt = causal ? nq - 1 - rank : rank;
  const int q0 = qt * kDqRows, h = hb % Hq, b = hb / Hq, hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0, windowed = has_window != 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);         // the producer's arrive + the TMA bytes
      mbar_init(empty0 + 8 * s, 2 * 128);  // every consumer thread
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
    q_range[0] = INT32_MAX;
    q_range[1] = INT32_MIN;
  }
  __syncthreads();
  if (tid < kDqRows) {
    const int s = q0 + tid;
    int lo = INT32_MAX, hi = INT32_MIN;
    if (s < Sq) lo = hi = q_pos[(size_t)b * Sq + s];
    lo = warp_min_i(lo);
    hi = warp_max_i(hi);
    if (lane == 0) {
      atomicMin(q_range, lo);
      atomicMax(q_range + 1, hi);
    }
  }
  __syncthreads();
  {
    const int qmin = q_range[0], qmax = q_range[1];
    for (int t = warp; t < nk; t += kThreads / 32) {
      int lo = INT32_MAX, hi = INT32_MIN;
      for (int j = t * BK + lane; j < (t + 1) * BK; j += 32) {
        const int kp = j < Sk ? k_pos[(size_t)b * Sk + j] : 2 * kPadHalf;
        lo = min(lo, kp);
        hi = max(hi, kp);
      }
      lo = warp_min_i(lo);
      hi = warp_max_i(hi);
      if (lane == 0) flags[t] = tile_flag(qmin, qmax, lo, hi, is_causal, windowed, window);
    }
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(qbar, 2 * QT::kBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sbase + L::kQ + c * QT::kRegion, &tm_q, qbar, 64 * c, h, q0, b);
        tma_load_4d(sbase + L::kDO + c * QT::kRegion, &tm_do, qbar, 64 * c, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < nk; ++t) {
        if (flags[t] == 0) continue;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t kdst = sbase + L::kKV + 2 * stage * KT::kBytes;
        mbar_arrive_expect_tx(full, 2 * KT::kBytes);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(kdst + c * KT::kRegion, &tm_k, full, 64 * c, hk, t * BK, b);
          tma_load_4d(kdst + KT::kBytes + c * KT::kRegion, &tm_v, full, 64 * c, hk, t * BK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each -------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wgi = (warp >> 2) - 1;
    const int c4 = lane & 3;
    // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
    // its warpgroup's 64, and columns 8i + 2*c4 + {0, 1} of every n8 chunk i.
    const int r0 = 64 * wgi + 16 * (warp & 3) + (lane >> 2);
    const float sl2 = scale * kLog2e;
    int qp[2];
    float nl[2], cc[2];  // -lse*log2(e) and dlse - delta of the two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + r0 + 8 * r;
      qp[r] = 0;
      nl[r] = cc[r] = 0.f;
      if (s < Sq) {
        const size_t row = ((size_t)b * Sq + s) * Hq + h;
        float l = lse[row], dl = dlse[row];
        if (is_neg_inf(l)) l = dl = 0.f;
        nl[r] = -l * kLog2e;
        cc[r] = dl - delta[row];
        qp[r] = q_pos[(size_t)b * Sq + s];
      }
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint64_t q_desc = sw128_desc(sbase + L::kQ + 64 * kRowBytes * wgi, 16, 1024);
    const uint64_t do_desc = sw128_desc(sbase + L::kDO + 64 * kRowBytes * wgi, 16, 1024);
    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nk; ++t) {
      const int flag = flags[t];
      if (flag == 0) continue;
      const uint32_t k_addr = sbase + L::kKV + 2 * stage * KT::kBytes;
      const uint32_t v_addr = k_addr + KT::kBytes;
      mbar_wait(full0 + 8 * stage, phase);

      // S = Q K^T and dP = dout V^T: every operand K-major, 16 columns of D
      // per product.  The opaque copies keep the compiler from holding all
      // of the descriptors' offsets in registers across the loop.
      uint64_t dqa = q_desc, doa = do_desc;
      asm volatile("" : "+l"(dqa), "+l"(doa));
      const uint64_t kb = sw128_desc(k_addr, 16, 1024), vb = sw128_desc(v_addr, 16, 1024);
      // This tile's fragments only: nothing of the last tile's stays live.
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, dqa + kmajor_step(kk, QT::kRegion), kb + kmajor_step(kk, KT::kRegion),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, doa + kmajor_step(kk, QT::kRegion), vb + kmajor_step(kk, KT::kRegion),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);

      // A masked score becomes kNegInf, so its exp2 underflows to exactly 0.
      if (flag == 2) {
        const int* kpt = k_pos + (size_t)b * Sk;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const int j = t * BK + 8 * i + 2 * c4;
          const int kp0 = j < Sk ? kpt[j] : 2 * kPadHalf;
          const int kp1 = j + 1 < Sk ? kpt[j + 1] : 2 * kPadHalf;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (!visible(qp[r], kp0, is_causal, windowed, window)) sc[4 * i + 2 * r] = kNegInf;
            if (!visible(qp[r], kp1, is_causal, windowed, window)) sc[4 * i + 2 * r + 1] = kNegInf;
          }
        }
      }
      // P = exp(S*scale - lse), dS = P (dP - delta + dlse) scale, and dS as
      // the A operand from registers: the f32 accumulator fragment, in bf16
      // pairs, is wgmma's A fragment of eight k16 steps over the keys.
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = 8 * kk + e, r = (e >> 1) & 1;
          const float p = exp2f(fmaf(sc[idx], sl2, nl[r]));
          sc[idx] = p * (dp[idx] + cc[r]) * scale;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) da[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      }

      // dQ += dS K: K is the MN-major B operand (rows of D along N).
      fence_regs<D / 2>(acc);
      wgmma_fence();
      const uint64_t kn = sw128_desc(k_addr, KT::kRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, da[kk], kn + mnmajor_step(kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + r0 + 8 * r;
      if (s >= Sq) continue;
      float* row = dq + (((size_t)b * Sq + s) * Hq + h) * D + 2 * c4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// B2's shared memory, from a 1024-byte aligned base: K and V, then per
// stage Q and dout, per stage the P tile that the dV warpgroup hands to
// the dK warpgroup (float32, in accumulator-fragment order: 16-byte slot i
// of thread t at (i * 128 + t) * 16), the mbarriers, the key-position
// range and one flag byte per q-tile.
template <int D>
struct DkvSmem {
  using KT = Tile<D, kDkvKeys>;
  using QT = Tile<D, kDkvRows>;
  static constexpr int kPBytes = kDkvKeys * kDkvRows * 4;
  static constexpr int kK = 0;
  static constexpr int kV = KT::kBytes;
  static constexpr int kQD = 2 * KT::kBytes;  // stage s: Q at kQD + 2*s*QT::kBytes, dout after it
  static constexpr int kP = kQD + 2 * kStages * QT::kBytes;  // stage s: P at kP + s*kPBytes
  static constexpr int kBars = kP + kStages * kPBytes;  // full[], empty[], p_ready[], kv
  static constexpr int kRange = kBars + 8 * (3 * kStages + 1);
  static constexpr int kFlags = kRange + 8;
  static size_t bytes(int n_tiles) { return 1024 + kFlags + static_cast<size_t>(n_tiles); }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ dlse, const int* __restrict__ q_pos,
                               const int* __restrict__ k_pos, float* __restrict__ dk,
                               float* __restrict__ dv, int B, int Sq, int Sk, int Hq, int Hkv,
                               int causal, int has_window, int window, float scale) {
  using L = DkvSmem<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  constexpr int BQ = kDkvRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t ready0 = full0 + 16 * kStages, kvbar = full0 + 24 * kStages;
  int* k_range = reinterpret_cast<int*>(smem + L::kRange);
  uint8_t* flags = smem + L::kFlags;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Sq + BQ - 1) / BQ, group = Hq / Hkv;
  // Blocks in tile-major order: under the causal mask key tile 0 has the
  // most live q-tiles, so index order starts with the heaviest.
  const int kt = blockIdx.x / (Hkv * B), hb = blockIdx.x % (Hkv * B);
  const int k0 = kt * kDkvKeys, hk = hb % Hkv, b = hb / Hkv;
  const bool is_causal = causal != 0, windowed = has_window != 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);
      mbar_init(ready0 + 8 * s, 128);  // every thread of the dV warpgroup
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
    k_range[0] = INT32_MAX;
    k_range[1] = INT32_MIN;
  }
  __syncthreads();
  if (tid < kDkvKeys) {
    const int j = k0 + tid;
    int kp = j < Sk ? k_pos[(size_t)b * Sk + j] : 2 * kPadHalf;
    const int lo = warp_min_i(kp), hi = warp_max_i(kp);
    if (lane == 0) {
      atomicMin(k_range, lo);
      atomicMax(k_range + 1, hi);
    }
  }
  __syncthreads();
  {
    const int kmin = k_range[0], kmax = k_range[1];
    for (int t = warp; t < nq; t += kThreads / 32) {
      int lo = INT32_MAX, hi = INT32_MIN;
      for (int s = t * BQ + lane; s < min((t + 1) * BQ, Sq); s += 32) {
        const int qp = q_pos[(size_t)b * Sq + s];
        lo = min(lo, qp);
        hi = max(hi, qp);
      }
      lo = warp_min_i(lo);
      hi = warp_max_i(hi);
      if (lane == 0) {
        int f = tile_flag(lo, hi, kmin, kmax, is_causal, windowed, window);
        // rows past Sq are masked by index
        if (f == 1 && (t + 1) * BQ > Sq) f = 2;
        flags[t] = static_cast<uint8_t>(f);
      }
    }
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * KT::kBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sbase + L::kK + c * KT::kRegion, &tm_k, kvbar, 64 * c, hk, k0, b);
        tma_load_4d(sbase + L::kV + c * KT::kRegion, &tm_v, kvbar, 64 * c, hk, k0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        for (int t = 0; t < nq; ++t) {
          if (flags[t] == 0) continue;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t qdst = sbase + L::kQD + 2 * stage * QT::kBytes;
          mbar_arrive_expect_tx(full, 2 * QT::kBytes);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(qdst + c * QT::kRegion, &tm_q, full, 64 * c, h, t * BQ, b);
            tma_load_4d(qdst + QT::kBytes + c * QT::kRegion, &tm_do, full, 64 * c, h, t * BQ, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups over the same 64 keys: warpgroup 1
    // computes P and dV, warpgroup 2 dP, dS and dK -------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wgi = (warp >> 2) - 1, wtid = tid & 127;
    const int c4 = lane & 3;
    // Accumulator rows are keys (r0 and r0 + 8 of the block's 64), columns
    // are queries: 8i + 2*c4 + {0, 1} of every n8 chunk i.  Both warpgroups
    // hold the same (key, query) elements in the same threads.
    const int r0 = 16 * (warp & 3) + (lane >> 2);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);

    // The walk of one warpgroup: DK false gives P^T and dV += P^T dout,
    // true gives dP^T, dS^T (from the other warpgroup's P^T) and
    // dK += dS^T Q.
    auto walk = [&](auto dk_tag) {
      constexpr bool DK = decltype(dk_tag)::value;
      const float sl2 = scale * kLog2e;
      int kp[2];
      if constexpr (!DK) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = k0 + r0 + 8 * r;
          kp[r] = j < Sk ? k_pos[(size_t)b * Sk + j] : 2 * kPadHalf;
        }
      }
      // S^T = K Q^T (dV warpgroup) or dP^T = V dout^T (dK warpgroup): both
      // operands K-major.
      const uint64_t a_desc = sw128_desc(sbase + (DK ? L::kV : L::kK), 16, 1024);
      int stage = 0;
      uint32_t phase = 0;
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        for (int t = 0; t < nq; ++t) {
          const int flag = flags[t];
          if (flag == 0) continue;
          const int q0 = t * BQ;
          // This lane loads a row value of queries q0 + 64*u + 2*lane + {0, 1}
          // (-lse*log2(e) for P, dlse - delta for dS); the lanes whose
          // accumulator columns they are read them by shuffle.
          float rv[BQ / 32];
          int qpv[BQ / 32];
#pragma unroll
          for (int e = 0; e < BQ / 32; ++e) {
            const int s = q0 + 64 * (e >> 1) + 2 * lane + (e & 1);
            rv[e] = 0.f;
            qpv[e] = 0;
            if (s < Sq) {
              const size_t row = ((size_t)b * Sq + s) * Hq + h;
              const float l = lse[row];
              if constexpr (DK) {
                rv[e] = is_neg_inf(l) ? 0.f : dlse[row] - delta[row];
              } else {
                rv[e] = is_neg_inf(l) ? 0.f : -l * kLog2e;
                qpv[e] = q_pos[(size_t)b * Sq + s];
              }
            }
          }
          const uint32_t q_addr = sbase + L::kQD + 2 * stage * QT::kBytes;
          const uint32_t do_addr = q_addr + QT::kBytes;
          float4* pbuf = reinterpret_cast<float4*>(smem + L::kP + stage * L::kPBytes) + wtid;
          mbar_wait(full0 + 8 * stage, phase);

          uint64_t ad = a_desc;
          asm volatile("" : "+l"(ad));
          const uint64_t bd = sw128_desc(DK ? do_addr : q_addr, 16, 1024);
          float sc[BQ / 2];
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) sc[i] = 0.f;
          fence_regs<BQ / 2>(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(sc, ad + kmajor_step(kk, KT::kRegion), bd + kmajor_step(kk, QT::kRegion),
                         kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs<BQ / 2>(sc);

          if constexpr (!DK) {
            // P^T in place of S^T.  A masked score becomes kNegInf (exp2
            // gives 0).
#pragma unroll
            for (int i = 0; i < BQ / 8; ++i) {
              const int src = 4 * (i % 8) + c4, u = 2 * (i / 8);
              const float nl0 = __shfl_sync(0xffffffffu, rv[u], src);
              const float nl1 = __shfl_sync(0xffffffffu, rv[u + 1], src);
              if (flag == 2) {
                const int qa = __shfl_sync(0xffffffffu, qpv[u], src);
                const int qb = __shfl_sync(0xffffffffu, qpv[u + 1], src);
                const int col = q0 + 8 * i + 2 * c4;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  if (!(col < Sq && visible(qa, kp[r], is_causal, windowed, window)))
                    sc[4 * i + 2 * r] = kNegInf;
                  if (!(col + 1 < Sq && visible(qb, kp[r], is_causal, windowed, window)))
                    sc[4 * i + 2 * r + 1] = kNegInf;
                }
              }
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sc[4 * i + e] = exp2f(fmaf(sc[4 * i + e], sl2, (e & 1) ? nl1 : nl0));
              pbuf[i * 128] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
            }
            mbar_arrive(ready0 + 8 * stage);
          } else {
            // dS^T = P^T (dP^T - delta + dlse) scale in place of dP^T, with
            // P^T from the dV warpgroup.
            mbar_wait(ready0 + 8 * stage, phase);
#pragma unroll
            for (int i = 0; i < BQ / 8; ++i) {
              const int src = 4 * (i % 8) + c4, u = 2 * (i / 8);
              const float cc0 = __shfl_sync(0xffffffffu, rv[u], src);
              const float cc1 = __shfl_sync(0xffffffffu, rv[u + 1], src);
              const float4 p = pbuf[i * 128];
              sc[4 * i] = p.x * (sc[4 * i] + cc0) * scale;
              sc[4 * i + 1] = p.y * (sc[4 * i + 1] + cc1) * scale;
              sc[4 * i + 2] = p.z * (sc[4 * i + 2] + cc0) * scale;
              sc[4 * i + 3] = p.w * (sc[4 * i + 3] + cc1) * scale;
            }
          }
          // P^T or dS^T as the bf16 A operand (k16 steps over the tile's queries).
          uint32_t a[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

          // dV += P^T dout or dK += dS^T Q: dout and Q are MN-major B operands.
          fence_regs<D / 2>(acc);
          wgmma_fence();
          const uint64_t bn = sw128_desc(DK ? q_addr : do_addr, QT::kRegion, 1024);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(acc, a[kk], bn + mnmajor_step(kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs<D / 2>(acc);
          mbar_arrive(empty0 + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    };
    if (wgi == 1)
      walk(std::true_type{});
    else
      walk(std::false_type{});

    float* grad = wgi == 1 ? dk : dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + r0 + 8 * r;
      if (j >= Sk) continue;
      float* row = grad + (((size_t)b * Sk + j) * Hkv + hk) * D + 2 * c4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

// The four tensor maps of a call: q and dout with boxes of `q_rows` rows,
// k and v with boxes of `k_rows`.  A side with no rows has no tile to load,
// but a map needs a nonzero extent and an address: it is built over one
// row of the other side and never read.
inline cudaError_t make_maps(const BwdArgs& a, int D, int q_rows, int k_rows, CUtensorMap* tq,
                             CUtensorMap* tk, CUtensorMap* tv, CUtensorMap* tdo) {
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) & 15)
    return cudaErrorMisalignedAddress;
  cudaError_t err;
  const bool has_q = a.Sq > 0, has_k = a.Sk > 0;
  if ((err = make_bf16_map(tq, has_q ? a.q : a.k, D, has_q ? a.Hq : a.Hkv, has_q ? a.Sq : 1, a.B,
                           q_rows)) != cudaSuccess)
    return err;
  if ((err = make_bf16_map(tdo, has_q ? a.dout : a.k, D, has_q ? a.Hq : a.Hkv, has_q ? a.Sq : 1,
                           a.B, q_rows)) != cudaSuccess)
    return err;
  if ((err = make_bf16_map(tk, has_k ? a.k : a.q, D, has_k ? a.Hkv : a.Hq, has_k ? a.Sk : 1, a.B,
                           k_rows)) != cudaSuccess)
    return err;
  return make_bf16_map(tv, has_k ? a.v : a.q, D, has_k ? a.Hkv : a.Hq, has_k ? a.Sk : 1, a.B,
                       k_rows);
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, float* dq) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_maps(a, D, kDqRows, kDqKeys, &tq, &tk, &tv, &tdo);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::bytes((a.Sk + kDqKeys - 1) / kDqKeys);
  const long long blocks = (long long)((a.Sq + kDqRows - 1) / kDqRows) * a.Hq * a.B;
  if (smem > (size_t)kMaxSmem || blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kern<<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dq, a.B, a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, float* dk, float* dv) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_maps(a, D, kDkvRows, kDkvKeys, &tq, &tk, &tv, &tdo);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvSmem<D>::bytes((a.Sq + kDkvRows - 1) / kDkvRows);
  const long long blocks = (long long)((a.Sk + kDkvKeys - 1) / kDkvKeys) * a.Hkv * a.B;
  if (smem > (size_t)kMaxSmem || blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kern<<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dk, dv, a.B, a.Sq, a.Sk, a.Hq,
      a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace wgb

// Which instance takes a call (mirrored by `flash_bwd_instance` in
// kernels/flash_attention.py, checked against it by `flash_bwd_takes_wgmma`).
inline bool takes_wgmma_bwd(int bf16, int D) { return bf16 && (D == 64 || D == 128); }

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
  if (rt::takes_wgmma_bwd(bf16, D))
    return D == 128 ? (int)rt::wgb::launch_dq<128>(a, out) : (int)rt::wgb::launch_dq<64>(a, out);
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
  if (rt::takes_wgmma_bwd(bf16, D))
    return D == 128 ? (int)rt::wgb::launch_dkv<128>(a, k_out, v_out)
                    : (int)rt::wgb::launch_dkv<64>(a, k_out, v_out);
  return bf16 ? (int)rt::dkv_dim<__nv_bfloat16>(D, a, k_out, v_out)
              : (int)rt::dkv_dim<float>(D, a, k_out, v_out);
}

// 1 if the wgmma instances take a call of this dtype and D, else 0: lets
// the host check its copy of the rule (`flash_bwd_instance`) on the card.
extern "C" int flash_bwd_takes_wgmma(int bf16, int D) { return rt::takes_wgmma_bwd(bf16, D); }
