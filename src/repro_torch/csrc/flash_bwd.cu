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
// * The wgmma instances (bf16, D 64, 128 or 256: the training calls).  384
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
//   - D 256 (recurrentgemma-2b's local attention: 10/1 heads, causal,
//     window 2048) splits the work by columns, so that every consumer
//     keeps the D-128 register budget: dQ, dK or dV of 64 rows x 128
//     columns (64 floats a thread) beside one 64 x 64 score tile or two.
//     The D-128 layout cannot take D 256 as it is: B1's 128-row Q and dout
//     tiles with two K/V stages would need 256 KB of shared memory, and a
//     consumer holding 64 x 256 of dQ, dK or dV (128 floats) beside S and
//     dP would spill as above.  B1 (DqSplit) takes 64-row q-tiles; both
//     consumers hold the same 64 rows, each forms S and dP over the whole
//     D itself and accumulates its half of dQ's columns: 192 KB of Q,
//     dout and two K/V stages, no hand-over between the warpgroups, at
//     10*D flops a pair in place of 6*D.  B2 (DkvSplit) runs two blocks
//     per 64-key tile, each owning half of dK's and dV's columns and
//     forming S^T and dP^T over the whole D: the D-128 block's structure
//     with 224 KB of K, V, two Q/dout stages and two P stages (so Sq up to
//     126,976, the flags' room), at 12*D flops a pair in place of 8*D, and
//     256 blocks over the card's 132 SMs at the training shape in place of
//     128.  Each block still writes its own rows and columns once, in a
//     fixed order: the gradients stay bitwise repeatable.  The two copies
//     of a score tile are the same products of the same operands in the
//     same order, so both halves of a row or key see the same P and dS.
//   P and dS are rounded to bf16 for the dq, dk and dv products (the
//   float32 sums of S and dP are exact products of the bf16 inputs).
//   What bounds them: the tensor-core rate (989 TFLOP/s bf16) at the
//   training shape, 6*D (B1) and 8*D (B2) flops per visible (query, key,
//   head) pair (at D 256 the kernels do 10*D and 12*D: the recomputed S,
//   dP, S^T and dP^T).  What keeps them from it: within a warpgroup the
//   exponentials and dS run between products, with nothing in flight on
//   the tensor cores but the other warpgroup's work; in B2 the dK
//   warpgroup waits for the dV warpgroup's P^T on every tile, and every
//   64-key block streams the group's Q and dout again; each B1 block
//   recomputes S and dP that B2 computes again.
//
// * The CUDA-core instances (float32, and bf16 at D 32, widened to float32
//   on load): exact float32 (FFMA on the CUDA cores, no TF32), the port's
//   precision reference.  What bounds them: the FP32 rate, 67 TFLOP/s (6*D
//   and 8*D flops a visible pair).
//   - B1 (dq), `core::flash_bwd_dq_core_kernel<T, D>` (`core::Dq`),
//     replacing `_bwd_dq_kernel`: 256 threads a block over a 64-row
//     q-tile, one block per (q-tile, query head, batch row), tile-major,
//     causal grids heaviest first.  The block loads Q and dout of its rows
//     once, in float32, and the rows' lse, delta, dlse and positions (a
//     row whose lse is -inf as lse = dlse = 0).  It flags every KV tile of
//     64 keys once (dead, wholly visible, masked; a missing key counts as
//     padding), lists the live ones 256 at a time, and walks them in index
//     order through a 2-stage cp.async ring of K and V in their stored
//     type (rows past Sk zero) and the keys' positions.  A 16 x 16 grid of
//     threads: thread (ty, tx) forms S = Q K^T and then dP = dout V^T for
//     rows ty + 16 i and keys tx + 16 j (4 x 4) from 16-byte loads of four
//     columns (8 loads feed 64 FFMAs), P and dS in registers (the mask only
//     on masked tiles), writes only dS to shared memory, and then dQ += dS
//     K for its rows and D/16 columns (12 loads feed 128 FFMAs at D 128).
//     dQ stays in float32 registers across the walk and each block stores
//     its rows once, summed over the keys in one fixed order: no atomics.
//     Rows past Sq are computed on zeros and never stored (a row of dS
//     feeds only its own row of dQ).  Two block barriers a tile.  At D 128
//     the block holds 226,064 B of shared memory (Q and dout 67,584, two
//     K/V stages 135,168, dS 20,480), within the 232,448 B opt-in.  D 256
//     takes 32-row q-tiles over 32-key tiles (2 x 2 register tiles, 4
//     loads feed 16 FFMAs in S and dP; 207,888 B): 64 rows there would
//     need 266 KB for Q, dout and two stages, and 64-row tiles over 16
//     keys would give each key one thread and fewer FFMAs a load still.
//     What keeps it from the FP32 rate: one block of 8 warps an SM, S and
//     dP recomputed here and again in B2, the diagonal tiles' masked half,
//     the causal grid's imbalance, and at D 256 the 2 x 2 tiles' 4 FFMAs a
//     shared load.
//   - B2 (dk, dv), `core::flash_bwd_dkv_core_kernel<T, D>` (`core::Dkv`):
//     256 threads a block over a 32-key tile (twice the blocks of a 64-key
//     tile: 256 at phase 8's call and at recurrentgemma's D-256 call, where
//     a 64-key tile gives 128 blocks on 132 SMs, and the causal grid's
//     heaviest block half as long) holding K and V in float32.  It walks
//     every query head of the GQA group and then every live 64-row q-tile
//     (32 at D 256, so that two stages fit: 214,416 B), in that fixed
//     order; Q, dout and the rows' lse, delta, dlse and positions of each
//     item stream through a 2-stage cp.async ring (16-byte and 4-byte
//     copies, rows past Sq zero).  A 16 x 16 grid of threads: thread (ty,
//     tx) computes S^T = K Q^T and dP^T = V dout^T for keys ty + 16 i and
//     queries tx + 16 j (2 x 4; 2 x 2 at D 256) from 16-byte loads of four
//     columns (12 loads feed 64 FFMAs), forms P^T and dS^T in registers and
//     hands them over through shared memory; then dV += P^T dout and dK +=
//     dS^T Q for its keys and D/16 columns (20 loads feed 128 FFMAs).  Rows
//     are padded by 16 bytes (conflict-free reads), and dK and dV stay in
//     registers across the walk, so the group sum stays in the block, with
//     no atomics, and each block stores its rows once.  The q-tiles' flags
//     are computed once and listed 256 at a time, as in A; a ragged last
//     q-tile is masked element by element.  Two block barriers an item.
//     What keeps it from the FP32 rate: one block of 8 warps an SM, 5.3 and
//     6.4 FFMAs a shared load, the hand-over of P^T and dS^T, and the
//     causal grid's imbalance.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  const int *q_pos, *k_pos;
  int B, Sq, Sk, Hq, Hkv, causal, has_window, window;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// B1's and B2's CUDA-core instances: float32, and bf16 at D 32.
// ---------------------------------------------------------------------------

namespace core {

// B1's tiling and shared-memory layout (bytes) of one block at head dim D
// with K and V staged in T (mirrored by `core_dq_tiling` and the kernel
// lint's closed form).  Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i of the q-tile: keys tx + 16 j of S, dP and dS, and columns
// VW tx + 16 VW c (c < NV) of dQ.
template <typename T, int D>
struct Dq {
  static constexpr int BQ = D == 256 ? 32 : 64;  // q rows a block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys a KV tile
  static constexpr int kStages = 2;              // depth of the K/V ring
  static constexpr int TR = BQ / 16, TK = BK / 16;  // rows and keys of a thread's S
  static constexpr int VW = D >= 64 ? 4 : 2;     // dQ columns a vector
  static constexpr int NV = D / 16 / VW;         // dQ vectors a row of a thread
  static constexpr int QS = D + 4;               // float32 row of Q and dout: 16 bytes of padding
  static constexpr int KS = D + 16 / (int)sizeof(T);  // row of K and V in T: 16 bytes too
  static constexpr int PS = BK + 16;             // row of dS
  static constexpr int kStage = 2 * BK * KS * (int)sizeof(T);  // K, then V
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + 4 * BQ * QS;
  static constexpr int kKV = kDO + 4 * BQ * QS;
  static constexpr int kDS = kKV + kStages * kStage;
  static constexpr int kKp = kDS + 4 * BQ * PS;  // key positions, a stage each
  static constexpr int kRows = kKp + 4 * kStages * BK;  // lse, delta, dlse, positions
  static constexpr int kLive = kRows + 4 * 4 * BQ;
  static constexpr int kFlags = kLive + 4 * kFlagChunk;
  static constexpr int kMisc = kFlags + kFlagChunk;  // q range, live count
  static constexpr int kBytes = kMisc + 16;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ dlse, const int* __restrict__ q_pos,
                             const int* __restrict__ k_pos, float* __restrict__ dq, int B,
                             int Sq, int Sk, int Hq, int Hkv, int causal, int has_window,
                             int window, float scale) {
  using L = Dq<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDO = reinterpret_cast<float*>(smem + L::kDO);
  T* sKV = reinterpret_cast<T*>(smem + L::kKV);
  float* sDS = reinterpret_cast<float*>(smem + L::kDS);
  int* sKp = reinterpret_cast<int*>(smem + L::kKp);
  float* sL = reinterpret_cast<float*>(smem + L::kRows);
  float* sDelta = sL + L::BQ;
  float* sDlse = sDelta + L::BQ;
  int* sQp = reinterpret_cast<int*>(sDlse + L::BQ);
  int* sLive = reinterpret_cast<int*>(smem + L::kLive);
  uint8_t* sFlags = smem + L::kFlags;
  int* sMisc = reinterpret_cast<int*>(smem + L::kMisc);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  // Blocks in tile-major order; causal grids start with the q-tiles that
  // have the most live KV tiles.
  const int nq = (Sq + L::BQ - 1) / L::BQ;
  const int rank = blockIdx.x / (Hq * B), hb = blockIdx.x % (Hq * B);
  const int qt = causal ? nq - 1 - rank : rank;
  const int q0 = qt * L::BQ, h = hb % Hq, b = hb / Hq, hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0, windowed = has_window != 0;
  const size_t key_stride = (size_t)Hkv * D;  // elements from one key to the next
  const T* kb = k + (size_t)b * Sk * key_stride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Sk * key_stride + (size_t)hk * D;
  const int* kpb = k_pos + (size_t)b * Sk;

  // Q and dout in float32 (rows past Sq are zero); the rows' lse, delta,
  // dlse and positions, with a row that saw no key (lse -inf) taken as lse
  // = dlse = 0, as the Pallas `_bwd_p_ds` does.
  constexpr int QC = D / 4;
  for (int i = tid; i < 2 * L::BQ * QC; i += kThreads) {
    const int which = i / (L::BQ * QC), r = (i / QC) % L::BQ, c = 4 * (i % QC);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) ld_vec((which ? dout : q) + (((size_t)b * Sq + q0 + r) * Hq + h) * D + c, x);
    st_vec((which ? sDO : sQ) + r * L::QS + c, x);
  }
  if (tid < L::BQ) {
    float l = 0.f, de = 0.f, dl = 0.f;
    int qp = 0;
    if (q0 + tid < Sq) {
      const size_t s = (size_t)b * Sq + q0 + tid, row = s * Hq + h;
      l = lse[row];
      de = delta[row];
      dl = dlse[row];
      if (is_neg_inf(l)) l = dl = 0.f;
      qp = q_pos[s];
    }
    sL[tid] = l;
    sDelta[tid] = de;
    sDlse[tid] = dl;
    sQp[tid] = qp;
  }
  __syncthreads();
  if (warp == 0) warp_range(sQp, min(L::BQ, Sq - q0), sMisc);  // the real rows' range

  auto load_tile = [&](int stage, int entry) {
    load_kv_tile<T, D, L::BK, L::KS>(sKV + stage * (L::kStage / (int)sizeof(T)),
                                     sKp + stage * L::BK, kb, vb, kpb, key_stride,
                                     (entry & kTileMask) * L::BK, Sk);
  };

  float acc[L::TR][L::NV][L::VW];
#pragma unroll
  for (int i = 0; i < L::TR; ++i)
#pragma unroll
    for (int c = 0; c < L::NV; ++c)
#pragma unroll
      for (int w = 0; w < L::VW; ++w) acc[i][c][w] = 0.f;

  const int nk = (Sk + L::BK - 1) / L::BK;
  for (int c0 = 0; c0 < nk; c0 += kFlagChunk) {
    const int cn = min(kFlagChunk, nk - c0);
    __syncthreads();  // the q range is written; the last chunk's tiles are read
    const int qmin = sMisc[0], qmax = sMisc[1];
    flag_kv_tiles<L::BK>(sFlags, kpb, Sk, c0, cn, qmin, qmax, is_causal, windowed, window);
    __syncthreads();
    if (warp == 0) list_live(sFlags, cn, c0, sLive, sMisc + 2);
    __syncthreads();
    const int n_live = sMisc[2];
#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      if (s < n_live) load_tile(s, sLive[s]);
      cp_async_commit();
    }
    for (int it = 0; it < n_live; ++it) {
      cp_async_wait<L::kStages - 2>();
      __syncthreads();  // tile `it` has landed; every thread is done with tile it - 1
      if (it + L::kStages - 1 < n_live)
        load_tile((it + L::kStages - 1) % L::kStages, sLive[it + L::kStages - 1]);
      cp_async_commit();
      const int entry = sLive[it], stage = it % L::kStages;
      const int k0 = (entry & kTileMask) * L::BK;
      const T* sK = sKV + stage * (L::kStage / (int)sizeof(T));
      const T* sV = sK + L::BK * L::KS;
      const int* kp = sKp + stage * L::BK;

      // S = Q K^T, then dP = dout V^T: four columns of a row and of each key
      // a step.
      float s[L::TR][L::TK], dp[L::TR][L::TK];
#pragma unroll
      for (int i = 0; i < L::TR; ++i)
#pragma unroll
        for (int j = 0; j < L::TK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float qa[L::TR][4], ka[L::TK][4];
#pragma unroll
        for (int i = 0; i < L::TR; ++i) ld_vec(sQ + (ty + 16 * i) * L::QS + d, qa[i]);
#pragma unroll
        for (int j = 0; j < L::TK; ++j) ld_vec(sK + (tx + 16 * j) * L::KS + d, ka[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < L::TR; ++i)
#pragma unroll
            for (int j = 0; j < L::TK; ++j) s[i][j] = fmaf(qa[i][e], ka[j][e], s[i][j]);
      }
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float da[L::TR][4], va[L::TK][4];
#pragma unroll
        for (int i = 0; i < L::TR; ++i) ld_vec(sDO + (ty + 16 * i) * L::QS + d, da[i]);
#pragma unroll
        for (int j = 0; j < L::TK; ++j) ld_vec(sV + (tx + 16 * j) * L::KS + d, va[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < L::TR; ++i)
#pragma unroll
            for (int j = 0; j < L::TK; ++j) dp[i][j] = fmaf(da[i][e], va[j][e], dp[i][j]);
      }
      // P = exp(S scale - lse) and dS = P (dP - delta + dlse) scale; the
      // elementwise mask only on masked tiles.  Rows past Sq are computed
      // on zeros and never stored: a row of dS feeds only its own row of dQ.
      const bool masked = (entry >> kFlagShift) == 2;
#pragma unroll
      for (int i = 0; i < L::TR; ++i) {
        const int r = ty + 16 * i;
        const float lr = sL[r], de = sDelta[r], dl = sDlse[r];
#pragma unroll
        for (int j = 0; j < L::TK; ++j) {
          const int key = tx + 16 * j;
          const bool vis = !masked || (k0 + key < Sk && visible(sQp[r], kp[key], is_causal,
                                                                windowed, window));
          const float p = vis ? expf(s[i][j] * scale - lr) : 0.f;
          sDS[r * L::PS + key] = p * (dp[i][j] - de + dl) * scale;
        }
      }
      __syncthreads();  // dS is whole
      // dQ += dS K: four keys of dS's rows a step, one row of K at a time.
#pragma unroll
      for (int n = 0; n < L::BK; n += 4) {
        float sa[L::TR][4];
#pragma unroll
        for (int i = 0; i < L::TR; ++i) ld_vec(sDS + (ty + 16 * i) * L::PS + n, sa[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float kv[L::NV][L::VW];
#pragma unroll
          for (int c = 0; c < L::NV; ++c)
            ld_vec(sK + (n + u) * L::KS + L::VW * (tx + 16 * c), kv[c]);
#pragma unroll
          for (int i = 0; i < L::TR; ++i)
#pragma unroll
            for (int c = 0; c < L::NV; ++c)
#pragma unroll
              for (int w = 0; w < L::VW; ++w)
                acc[i][c][w] = fmaf(sa[i][u], kv[c][w], acc[i][c][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int sq = q0 + ty + 16 * i;
    if (sq >= Sq) continue;
    float* row = dq + (((size_t)b * Sq + sq) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < L::NV; ++c) st_vec(row + L::VW * (tx + 16 * c), acc[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, float* dq) {
  using L = Dq<T, D>;
  auto kern = flash_bwd_dq_core_kernel<T, D>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  // Vector loads of q and dout, 16-byte cp.async copies of k and v.
  if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout) & 15)
    return cudaErrorMisalignedAddress;
  const long long blocks = (long long)((a.Sq + L::BQ - 1) / L::BQ) * a.Hq * a.B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dq, a.B, a.Sq,
      a.Sk, a.Hq, a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

// B2's tiling and shared-memory layout (bytes) of one block at head dim D
// with Q and dout staged in T (mirrored by `core_dkv_tiling` and the kernel
// lint's closed form).  Thread (ty, tx) = (tid / 16, tid % 16) owns keys
// ty + 16 i of the block: queries tx + 16 j of S^T and dP^T, and columns
// VW tx + 16 VW c (c < NV) of dK and dV.
template <typename T, int D>
struct Dkv {
  static constexpr int BK = 32;                  // keys a block
  static constexpr int BQ = D == 256 ? 32 : 64;  // q rows a tile of the walk
  static constexpr int kStages = 2;              // depth of the Q/dout ring
  static constexpr int TK = BK / 16, TQ = BQ / 16;  // keys and queries of a thread's S^T
  static constexpr int VW = D >= 64 ? 4 : 2;     // dK/dV columns a vector
  static constexpr int NV = D / 16 / VW;         // vectors a key of a thread
  static constexpr int KS = D + 4;               // float32 row of K and V: 16 bytes of padding
  static constexpr int QS = D + 16 / (int)sizeof(T);  // row of Q and dout in T: 16 bytes too
  static constexpr int PS = BQ + 16;             // row of P^T and dS^T
  // A stage: Q, dout, then the rows' lse, delta, dlse and positions.
  static constexpr int kRows = 2 * BQ * QS * (int)sizeof(T);
  static constexpr int kStage = kRows + 4 * 4 * BQ;
  static constexpr int kK = 0;
  static constexpr int kV = kK + 4 * BK * KS;
  static constexpr int kRing = kV + 4 * BK * KS;
  static constexpr int kPT = kRing + kStages * kStage;
  static constexpr int kDST = kPT + 4 * BK * PS;
  static constexpr int kKp = kDST + 4 * BK * PS;
  static constexpr int kLive = kKp + 4 * BK;
  static constexpr int kFlags = kLive + 4 * kFlagChunk;
  static constexpr int kMisc = kFlags + kFlagChunk;  // key range, live count
  static constexpr int kBytes = kMisc + 16;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const float* __restrict__ dlse, const int* __restrict__ q_pos,
                              const int* __restrict__ k_pos, float* __restrict__ dk,
                              float* __restrict__ dv, int B, int Sq, int Sk, int Hq, int Hkv,
                              int causal, int has_window, int window, float scale) {
  using L = Dkv<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  unsigned char* ring = smem + L::kRing;
  float* sPT = reinterpret_cast<float*>(smem + L::kPT);
  float* sDST = reinterpret_cast<float*>(smem + L::kDST);
  int* sKp = reinterpret_cast<int*>(smem + L::kKp);
  int* sLive = reinterpret_cast<int*>(smem + L::kLive);
  uint8_t* sFlags = smem + L::kFlags;
  int* sMisc = reinterpret_cast<int*>(smem + L::kMisc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  // Blocks in tile-major order: under the causal mask key tile 0 has the
  // most live q-tiles, so index order starts with the heaviest.
  const int kt = blockIdx.x / (Hkv * B), hb = blockIdx.x % (Hkv * B);
  const int k0 = kt * L::BK, hk = hb % Hkv, b = hb / Hkv, group = Hq / Hkv;
  const int nkeys = min(L::BK, Sk - k0);
  const bool is_causal = causal != 0, windowed = has_window != 0;
  const int* qpb = q_pos + (size_t)b * Sq;

  // K and V of the block's keys in float32 (keys past Sk are zero) and the
  // keys' positions (past Sk: padding).
  constexpr int QC = D / 4;
  for (int i = tid; i < L::BK * QC; i += kThreads) {
    const int j = i / QC, c = 4 * (i % QC);
    float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < nkeys) {
      const size_t off = (((size_t)b * Sk + k0 + j) * Hkv + hk) * D + c;
      ld_vec(k + off, x);
      ld_vec(v + off, y);
    }
    st_vec(sK + j * L::KS + c, x);
    st_vec(sV + j * L::KS + c, y);
  }
  if (tid < L::BK) sKp[tid] = tid < nkeys ? k_pos[(size_t)b * Sk + k0 + tid] : 2 * kPadHalf;
  __syncthreads();
  if (warp == 0) warp_range(sKp, L::BK, sMisc);  // the keys' range

  // Item n of the walk: query head hk * group + n / n_live of the group, the
  // live q-tile sLive[n % n_live]: its Q and dout rows (16 bytes a copy,
  // rows past Sq zero) and its rows' lse, delta, dlse and positions (4
  // bytes a copy, past Sq zero).
  auto load_item = [&](int stage, int n, int n_live) {
    constexpr int C = D * (int)sizeof(T) / 16, E = 16 / (int)sizeof(T);
    const int q0 = (sLive[n % n_live] & kTileMask) * L::BQ, h = hk * group + n / n_live;
    unsigned char* st = ring + stage * L::kStage;
    T* dst = reinterpret_cast<T*>(st);
    for (int i = tid; i < 2 * L::BQ * C; i += kThreads) {
      const int which = i / (L::BQ * C), r = (i / C) % L::BQ, c = i % C;
      const bool ok = q0 + r < Sq;
      const T* src = (which ? dout : q) + (((size_t)b * Sq + (ok ? q0 + r : q0)) * Hq + h) * D +
                     c * E;
      cp_async16(dst + (which * L::BQ + r) * L::QS + c * E, src, ok);
    }
    if (tid < 4 * L::BQ) {
      const int which = tid / L::BQ, r = tid % L::BQ;
      const bool ok = q0 + r < Sq;
      const size_t s = (size_t)b * Sq + (ok ? q0 + r : q0), row = s * Hq + h;
      const void* src = which == 0   ? static_cast<const void*>(lse + row)
                        : which == 1 ? static_cast<const void*>(delta + row)
                        : which == 2 ? static_cast<const void*>(dlse + row)
                                     : static_cast<const void*>(q_pos + s);
      cp_async4(st + L::kRows + 4 * (which * L::BQ + r), src, ok);
    }
  };

  float ak[L::TK][L::NV][L::VW], av[L::TK][L::NV][L::VW];
#pragma unroll
  for (int i = 0; i < L::TK; ++i)
#pragma unroll
    for (int c = 0; c < L::NV; ++c)
#pragma unroll
      for (int w = 0; w < L::VW; ++w) ak[i][c][w] = av[i][c][w] = 0.f;

  const int nq = (Sq + L::BQ - 1) / L::BQ;
  for (int c0 = 0; c0 < nq; c0 += kFlagChunk) {
    const int cn = min(kFlagChunk, nq - c0);
    __syncthreads();  // the key range is written; the last chunk's items are read
    const int kmin = sMisc[0], kmax = sMisc[1];
    // Each q-tile's flag from its real rows' positions; a ragged last tile
    // is masked element by element (its missing rows must give P = 0).
    for (int t = warp; t < cn; t += kThreads / 32) {
      const int base = (c0 + t) * L::BQ;
      int lo = INT32_MAX, hi = INT32_MIN;
      for (int r = lane; r < L::BQ; r += 32)
        if (base + r < Sq) lo = min(lo, qpb[base + r]), hi = max(hi, qpb[base + r]);
      lo = warp_min_i(lo);
      hi = warp_max_i(hi);
      if (lane == 0) {
        const int f = tile_flag(lo, hi, kmin, kmax, is_causal, windowed, window);
        sFlags[t] = (uint8_t)(f == 1 && base + L::BQ > Sq ? 2 : f);
      }
    }
    __syncthreads();
    if (warp == 0) list_live(sFlags, cn, c0, sLive, sMisc + 2);
    __syncthreads();
    const int n_live = sMisc[2], n_items = group * n_live;
#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      if (s < n_items) load_item(s, s, n_live);
      cp_async_commit();
    }
    // The walk: every head of the group, then every live q-tile, in order.
    for (int it = 0; it < n_items; ++it) {
      cp_async_wait<L::kStages - 2>();
      __syncthreads();  // item `it` has landed; every thread is done with item it - 1
      if (it + L::kStages - 1 < n_items)
        load_item((it + L::kStages - 1) % L::kStages, it + L::kStages - 1, n_live);
      cp_async_commit();
      const int entry = sLive[it % n_live];
      const int q0 = (entry & kTileMask) * L::BQ;
      const unsigned char* st = ring + (it % L::kStages) * L::kStage;
      const T* sQ = reinterpret_cast<const T*>(st);
      const T* sDO = sQ + L::BQ * L::QS;
      const float* sL = reinterpret_cast<const float*>(st + L::kRows);
      const float* sDelta = sL + L::BQ;
      const float* sDlse = sDelta + L::BQ;
      const int* sQp = reinterpret_cast<const int*>(sDlse + L::BQ);

      // S^T = K Q^T and dP^T = V dout^T: four columns a step.
      float s[L::TK][L::TQ], dp[L::TK][L::TQ];
#pragma unroll
      for (int i = 0; i < L::TK; ++i)
#pragma unroll
        for (int j = 0; j < L::TQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float ka[L::TK][4], va[L::TK][4], qa[L::TQ][4], da[L::TQ][4];
#pragma unroll
        for (int i = 0; i < L::TK; ++i) {
          ld_vec(sK + (ty + 16 * i) * L::KS + d, ka[i]);
          ld_vec(sV + (ty + 16 * i) * L::KS + d, va[i]);
        }
#pragma unroll
        for (int j = 0; j < L::TQ; ++j) {
          ld_vec(sQ + (tx + 16 * j) * L::QS + d, qa[j]);
          ld_vec(sDO + (tx + 16 * j) * L::QS + d, da[j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < L::TK; ++i)
#pragma unroll
            for (int j = 0; j < L::TQ; ++j) {
              s[i][j] = fmaf(qa[j][e], ka[i][e], s[i][j]);
              dp[i][j] = fmaf(da[j][e], va[i][e], dp[i][j]);
            }
      }
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta + dlse) scale.
      const bool masked = (entry >> kFlagShift) == 2;
#pragma unroll
      for (int j = 0; j < L::TQ; ++j) {
        const int r = tx + 16 * j;
        float lr = sL[r], dl = sDlse[r];
        if (is_neg_inf(lr)) lr = dl = 0.f;
        const float de = sDelta[r];
#pragma unroll
        for (int i = 0; i < L::TK; ++i) {
          const int key = ty + 16 * i;
          const bool vis = !masked || (q0 + r < Sq && visible(sQp[r], sKp[key], is_causal,
                                                              windowed, window));
          const float p = vis ? expf(s[i][j] * scale - lr) : 0.f;
          sPT[key * L::PS + r] = p;
          sDST[key * L::PS + r] = p * (dp[i][j] - de + dl) * scale;
        }
      }
      __syncthreads();  // P^T and dS^T are whole
      // dV += P^T dout and dK += dS^T Q: four queries a step.
#pragma unroll
      for (int r = 0; r < L::BQ; r += 4) {
        float pa[L::TK][4], sa[L::TK][4];
#pragma unroll
        for (int i = 0; i < L::TK; ++i) {
          ld_vec(sPT + (ty + 16 * i) * L::PS + r, pa[i]);
          ld_vec(sDST + (ty + 16 * i) * L::PS + r, sa[i]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float dov[L::NV][L::VW], qv[L::NV][L::VW];
#pragma unroll
          for (int c = 0; c < L::NV; ++c) {
            ld_vec(sDO + (r + u) * L::QS + L::VW * (tx + 16 * c), dov[c]);
            ld_vec(sQ + (r + u) * L::QS + L::VW * (tx + 16 * c), qv[c]);
          }
#pragma unroll
          for (int i = 0; i < L::TK; ++i)
#pragma unroll
            for (int c = 0; c < L::NV; ++c)
#pragma unroll
              for (int w = 0; w < L::VW; ++w) {
                av[i][c][w] = fmaf(pa[i][u], dov[c][w], av[i][c][w]);
                ak[i][c][w] = fmaf(sa[i][u], qv[c][w], ak[i][c][w]);
              }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::TK; ++i) {
    const int key = ty + 16 * i;
    if (key >= nkeys) continue;
    const size_t off = (((size_t)b * Sk + k0 + key) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < L::NV; ++c) {
      st_vec(dk + off + L::VW * (tx + 16 * c), ak[i][c]);
      st_vec(dv + off + L::VW * (tx + 16 * c), av[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, float* dk, float* dv) {
  using L = Dkv<T, D>;
  auto kern = flash_bwd_dkv_core_kernel<T, D>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  // 16-byte cp.async copies of q and dout, vector loads of k and v.
  if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout) & 15)
    return cudaErrorMisalignedAddress;
  const long long blocks = (long long)((a.Sk + L::BK - 1) / L::BK) * a.Hkv * a.B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, L::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.dlse, a.q_pos, a.k_pos, dk, dv, a.B,
      a.Sq, a.Sk, a.Hq, a.Hkv, a.causal, a.has_window, a.window, a.scale);
  return cudaGetLastError();
}

// Dynamic shared memory of one block of layout L (`Dq` or `Dkv`, bytes) at
// head dim D and type (`bf16` 1: D 32 only), or 0 where no instance exists.
template <template <typename, int> class L>
inline size_t smem_bytes(int D, int bf16) {
  if (bf16) return D == 32 ? L<__nv_bfloat16, 32>::kBytes : 0;
  switch (D) {
    case 32: return L<float, 32>::kBytes;
    case 64: return L<float, 64>::kBytes;
    case 128: return L<float, 128>::kBytes;
    case 256: return L<float, 256>::kBytes;
  }
  return 0;
}

}  // namespace core

// bf16 calls with D 64/128/256 go to the wgmma instances: only float32
// instantiates the CUDA-core kernels at those widths.
template <typename T>
cudaError_t dq_dim(int D, const BwdArgs& a, float* dq) {
  constexpr bool f32 = std::is_same_v<T, float>;
  switch (D) {
    case 32: return core::launch_dq<T, 32>(a, dq);
    case 64: if constexpr (f32) return core::launch_dq<T, 64>(a, dq);
      break;
    case 128: if constexpr (f32) return core::launch_dq<T, 128>(a, dq);
      break;
    case 256: if constexpr (f32) return core::launch_dq<T, 256>(a, dq);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_dim(int D, const BwdArgs& a, float* dk, float* dv) {
  constexpr bool f32 = std::is_same_v<T, float>;
  switch (D) {
    case 32: return core::launch_dkv<T, 32>(a, dk, dv);
    case 64: if constexpr (f32) return core::launch_dkv<T, 64>(a, dk, dv);
      break;
    case 128: if constexpr (f32) return core::launch_dkv<T, 128>(a, dk, dv);
      break;
    case 256: if constexpr (f32) return core::launch_dkv<T, 256>(a, dk, dv);
      break;
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The wgmma instances: bf16, D in {64, 128, 256}.
// ---------------------------------------------------------------------------

namespace wgb {

constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;         // depth of the ring
constexpr int kProducerRegs = 24;  // 128 * 24 + 256 * 240 = 384 * 168, the launch budget
constexpr int kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;   // the opt-in maximum of one block
constexpr int kDqKeys = 64;        // B1: keys per KV tile
constexpr int kDkvKeys = 64;       // B2: keys per block
constexpr int kDkvRows = 64;       // B2: q rows per tile
constexpr float kLog2e = 1.4426950408889634f;

// How B1 shares a block's work between its two consumer warpgroups: by
// rows (64 of a 128-row q-tile each, every column of dQ) up to D 128; at D
// 256 by columns (both take the same 64-row q-tile, each half of dQ's
// columns, each forming S and dP itself).
template <int D>
struct DqSplit {
  static constexpr bool kByCols = D > 128;
  static constexpr int kRows = kByCols ? 64 : 128;  // q rows per block
  static constexpr int kCols = kByCols ? D / 2 : D;  // dQ columns per consumer
};

// How many blocks share one 64-key tile of B2, each owning kCols of dK's
// and dV's columns: one up to D 128, two at D 256 (each forms S^T and dP^T
// over the whole D itself).
template <int D>
struct DkvSplit {
  static constexpr int kBlocks = D > 128 ? 2 : 1;
  static constexpr int kCols = D / kBlocks;
};

// B1's shared memory, from a 1024-byte aligned base: Q and dout, then per
// stage K and V, the mbarriers, the q-position range and one flag byte per
// KV tile.
template <int D>
struct DqSmem {
  using QT = Tile<D, DqSplit<D>::kRows>;
  using KT = Tile<D, kDqKeys>;
  static constexpr int kQ = 0;
  static constexpr int kDO = QT::kBytes;
  static constexpr int kKV = 2 * QT::kBytes;  // stage s: K at kKV + 2*s*KT::kBytes, V after it
  static constexpr int kBars = kKV + 2 * kStages * KT::kBytes;  // full[], empty[], q
  static constexpr int kRange = kBars + 8 * (2 * kStages + 1);
  static constexpr int kFlags = kRange + 8;
  static constexpr int kMaxTiles = kMaxSmem - 1024 - kFlags;  // KV tiles a block can flag
  static size_t bytes(int n_tiles) { return 1024 + kFlags + static_cast<size_t>(n_tiles); }
};
// D 256: 192 KB of Q, dout and two K/V stages; flags for Sk up to 2.2M.
static_assert(DqSmem<256>::kMaxTiles >= 32768 && DqSmem<128>::kMaxTiles >= 32768,
              "B1's layout leaves room for the flags of 32768 KV tiles");

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
  using C = DqSplit<D>;
  constexpr int BK = kDqKeys, BQ = C::kRows, NC = C::kCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;
  int* q_range = reinterpret_cast<int*>(smem + L::kRange);
  uint8_t* flags = smem + L::kFlags;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Sq + BQ - 1) / BQ, nk = (Sk + BK - 1) / BK;
  // Blocks in tile-major order; causal grids start with the q-tiles that
  // have the most live KV tiles.
  const int rank = blockIdx.x / (Hq * B), hb = blockIdx.x % (Hq * B);
  const int qt = causal ? nq - 1 - rank : rank;
  const int q0 = qt * BQ, h = hb % Hq, b = hb / Hq, hk = h / (Hq / Hkv);
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
  if (tid < BQ) {
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
    // ---- two consumer warpgroups: 64 q rows each, or (D 256) the same 64
    // rows and NC of dQ's columns each --------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wgi = (warp >> 2) - 1;
    const int c4 = lane & 3;
    const int row_off = C::kByCols ? 0 : 64 * wgi, col_off = C::kByCols ? NC * wgi : 0;
    // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
    // its warpgroup's 64, and columns 8i + 2*c4 + {0, 1} of every n8 chunk i.
    const int r0 = row_off + 16 * (warp & 3) + (lane >> 2);
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
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    const uint64_t q_desc = sw128_desc(sbase + L::kQ + row_off * kRowBytes, 16, 1024);
    const uint64_t do_desc = sw128_desc(sbase + L::kDO + row_off * kRowBytes, 16, 1024);
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

      // dQ += dS K over this warpgroup's columns: K is the MN-major B
      // operand (rows of D along N), from the 64-column region of col_off.
      fence_regs<NC / 2>(acc);
      wgmma_fence();
      const uint64_t kn = sw128_desc(k_addr + (col_off / 64) * KT::kRegion, KT::kRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<NC>(acc, da[kk], kn + mnmajor_step(kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NC / 2>(acc);
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
      float* row = dq + (((size_t)b * Sq + s) * Hq + h) * D + col_off + 2 * c4;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
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
  static constexpr int kMaxTiles = kMaxSmem - 1024 - kFlags;  // q-tiles a block can flag
  static size_t bytes(int n_tiles) { return 1024 + kFlags + static_cast<size_t>(n_tiles); }
};
// D 256: 224 KB of K, V, two Q/dout stages and two P stages; flags for
// 1984 q-tiles, so Sq up to 126,976 (longer calls are refused at launch).
static_assert(DkvSmem<256>::kMaxTiles >= 1024 && DkvSmem<128>::kMaxTiles >= 32768,
              "B2's layout leaves room for the flags of 1024 q-tiles (Sq 65536) at D 256");

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
  using C = DkvSplit<D>;
  constexpr int BQ = kDkvRows, NC = C::kCols;
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
  // most live q-tiles, so index order starts with the heaviest; at D 256 the
  // two column blocks of one key tile are neighbours and stream the same Q
  // and dout tiles at about the same time.
  const int per_tile = C::kBlocks * Hkv * B;
  const int kt = blockIdx.x / per_tile, rest = blockIdx.x % per_tile;
  const int col_off = NC * (rest % C::kBlocks), hb = rest / C::kBlocks;
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
    // computes P and dV, warpgroup 2 dP, dS and dK, each over the block's
    // NC columns -----------------------------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wgi = (warp >> 2) - 1, wtid = tid & 127;
    const int c4 = lane & 3;
    // Accumulator rows are keys (r0 and r0 + 8 of the block's 64), columns
    // are queries: 8i + 2*c4 + {0, 1} of every n8 chunk i.  Both warpgroups
    // hold the same (key, query) elements in the same threads.
    const int r0 = 16 * (warp & 3) + (lane >> 2);
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
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

          // dV += P^T dout or dK += dS^T Q over the block's columns: dout
          // and Q are MN-major B operands, from the region of col_off.
          fence_regs<NC / 2>(acc);
          wgmma_fence();
          const uint64_t bn =
              sw128_desc((DK ? q_addr : do_addr) + (col_off / 64) * QT::kRegion, QT::kRegion, 1024);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<NC>(acc, a[kk], bn + mnmajor_step(kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_regs<NC / 2>(acc);
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
      float* row = grad + (((size_t)b * Sk + j) * Hkv + hk) * D + col_off + 2 * c4;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
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
  constexpr int BQ = DqSplit<D>::kRows;
  cudaError_t err = make_maps(a, D, BQ, kDqKeys, &tq, &tk, &tv, &tdo);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::bytes((a.Sk + kDqKeys - 1) / kDqKeys);
  const long long blocks = (long long)((a.Sq + BQ - 1) / BQ) * a.Hq * a.B;
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
  const long long blocks =
      (long long)((a.Sk + kDkvKeys - 1) / kDkvKeys) * DkvSplit<D>::kBlocks * a.Hkv * a.B;
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
inline bool takes_wgmma_bwd(int bf16, int D) { return bf16 && (D == 64 || D == 128 || D == 256); }

namespace wgb {

inline cudaError_t dq_dim(int D, const BwdArgs& a, float* dq) {
  switch (D) {
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    case 256: return launch_dq<256>(a, dq);
  }
  return cudaErrorInvalidValue;
}

inline cudaError_t dkv_dim(int D, const BwdArgs& a, float* dk, float* dv) {
  switch (D) {
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    case 256: return launch_dkv<256>(a, dk, dv);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at a call of length S (Sk for B1, Sq
// for B2), or 0 for a width with no wgmma instance.
inline size_t smem_bytes(int dkv, int D, int S) {
  const int tiles = (S + 63) / 64;  // B1's KV tiles and B2's q-tiles are both 64 rows
  switch (D) {
    case 64: return dkv ? DkvSmem<64>::bytes(tiles) : DqSmem<64>::bytes(tiles);
    case 128: return dkv ? DkvSmem<128>::bytes(tiles) : DqSmem<128>::bytes(tiles);
    case 256: return dkv ? DkvSmem<256>::bytes(tiles) : DqSmem<256>::bytes(tiles);
  }
  return 0;
}

}  // namespace wgb

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
  if (rt::takes_wgmma_bwd(bf16, D)) return (int)rt::wgb::dq_dim(D, a, out);
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
  if (rt::takes_wgmma_bwd(bf16, D)) return (int)rt::wgb::dkv_dim(D, a, k_out, v_out);
  return bf16 ? (int)rt::dkv_dim<__nv_bfloat16>(D, a, k_out, v_out)
              : (int)rt::dkv_dim<float>(D, a, k_out, v_out);
}

// 1 if the wgmma instances take a call of this dtype and D, else 0: lets
// the host check its copy of the rule (`flash_bwd_instance`) on the card.
extern "C" int flash_bwd_takes_wgmma(int bf16, int D) { return rt::takes_wgmma_bwd(bf16, D); }

// Dynamic shared memory of one block of B1's or B2's CUDA-core instance
// (bytes) at head dim D and type (`bf16` 1: D 32 only), or -1 where none
// exists.
extern "C" int flash_bwd_dq_core_smem(int D, int bf16) {
  const size_t bytes = rt::core::smem_bytes<rt::core::Dq>(D, bf16);
  return bytes ? (int)bytes : -1;
}
extern "C" int flash_bwd_dkv_core_smem(int D, int bf16) {
  const size_t bytes = rt::core::smem_bytes<rt::core::Dkv>(D, bf16);
  return bytes ? (int)bytes : -1;
}

// Dynamic shared memory of one wgmma-instance block (bytes): B1 (`dkv` 0)
// at Sk = `S`, or B2 (`dkv` 1) at Sq = `S`; -1 where no wgmma instance has
// this D.
extern "C" int flash_bwd_wgmma_smem(int dkv, int D, int S) {
  const size_t bytes = rt::wgb::smem_bytes(dkv, D, S);
  return bytes ? (int)bytes : -1;
}
