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
// out = 0 and lse = -inf exactly.  A KV tile whose every key is padding,
// causally after every query or out of every query's window is skipped
// whole (the Pallas `_tile_skip` predicate).  Ragged Sq and Sk are masked
// in the kernel.  One C entry, `flash_fwd`, picks the instance:
//
// * The decode instance (every call with Sq <= 4: the dense decode step;
//   float32 and bf16, D 32/64/128, and float32 D 256 at 1 to 16 rows a KV
//   head, the GQA group x Sq of recurrentgemma's local attention, group 10
//   at Sq 1; bf16 at D 256 runs on the cluster instance of decode_d256.cuh,
//   see there): the dense instance of the split-KV decode
//   core in decode.cuh, shared with kernel C.  One block of 128 threads per
//   (KV head, batch row, split of the KV range) holds the whole GQA group x
//   Sq rows, so K and V are read once per group; the split count comes from
//   the SM count and Sk (`decode_split_rule`); the split's key positions are
//   read once and dead 32-key tiles dropped by warp reductions; live tiles
//   (rows of (B,Sk,Hkv,D) at stride Hkv*D) stream through a 3-stage cp.async
//   ring in their stored type; scores are shuffle-reduced dot products of
//   16-byte lane vectors, the online softmax and P V stay in registers; the
//   last block of each (KV head, batch row) merges the splits in split order
//   (bitwise repeatable).  What bounds it: the bytes of the live keys over
//   the memory rate.  One launch of `rt::dec::decode_kernel<T, D, WR, RW,
//   false>`.
//
// * The wgmma instance (bf16, D 64, 128 or 256, Sq > 4: the training
//   calls and the serving prefill calls).  One block of 384 threads per
//   (q-tile, query head, batch row).  Warpgroup 0 is the producer:
//   one thread loads the Q tile and then K and V tiles by TMA into a ring
//   of 2 shared-memory stages, guarded by full/empty mbarriers.  q, k and v
//   are 4-D tensor maps (D, H, S, B) with 128-byte swizzle and boxes of 64
//   columns (D/64 per tile) by the tile's rows; rows past Sq or Sk read as
//   zero, and such keys are masked by index as well.  Warpgroups 1 and 2
//   are consumers of 64 q rows: S = Q K^T with wgmma (both operands
//   K-major from shared memory), the online softmax in registers (row max
//   and sum over the 4 threads of a quad; the Pallas `safe_m` and `alpha`
//   guards), then O += P V with P converted in place to bf16 as wgmma's
//   register A operand and V read as an MN-major B operand.  The
//   elementwise mask runs only on tiles not visible to every row of the
//   q-tile.  Before the roles split, the block computes each KV tile's flag
//   (dead, wholly visible, masked) once into shared memory, so producer and
//   consumers walk the same tiles and the mbarrier phases agree.  Causal
//   grids start with the q-tiles that have the most live tiles.  The
//   tiling (`Tiling<D>`):
//   - D 64/128: 128-row q-tiles, 64 rows and all of O's columns a
//     consumer, 128-key tiles, S by m64n128k16, O += P V by one product of
//     N = D a 16-key step; setmaxnreg gives the consumers 232 registers and
//     the producer 40.  Shared memory: 32 KB of Q and 2 x 64 KB of K/V at
//     D = 128 (half at D = 64).
//   - D 256 (recurrentgemma-2b's local attention: 10/1 heads, causal,
//     window 2048) splits O by columns.  The D-128 tiling cannot take D
//     256: Q (64 KB) and two stages of 128-key K and V (2 x 128 KB) pass
//     the 227 KB a block may have, and a consumer would hold 128 floats of
//     O beside 64 of S.  Even with 64-key tiles, a consumer that holds all
//     64 x 256 of O (128 floats) beside a 64 x 64 tile of S (32 floats)
//     spilled 404 B and had every wgmma serialised (C7512) on an H100: the
//     phase-2 gate refuses that.  So a block takes a 64-row q-tile that
//     both consumers hold; each forms S over the whole D itself (m64n64k16,
//     16 steps) and accumulates its half of O's columns (m64n128k16 over
//     its half of V, 4 steps a 64-key tile): 64 floats of O and 32 of S,
//     the D-128 budget.  The two copies of S are the same products of the
//     same operands in the same order, so both halves of a row see the
//     same P, m and l; the first writes lse.  setmaxnreg gives the
//     consumers 240 registers and the producer 24.  Shared memory: 32 KB
//     of Q and 2 x (32 + 32) KB of K/V, 160 KB, with room for the flags of
//     Sk up to 1,080,576 (longer calls are refused at launch).  6*D flops
//     a visible pair in place of 4*D: S is formed twice.
//   What bounds it: the tensor-core rate (989 TFLOP/s bf16) at the training
//   and prefill shapes.  What keeps it from that bound: a warpgroup's
//   softmax does not overlap its own products, and the two consumer
//   warpgroups are not scheduled against each other (no ping-pong), so
//   the tensor cores idle while exponentials run; at D 256 a 64-key tile
//   also gives each wait for the products half the work of a 128-key one.
//
// * The CUDA-core instance (float32, and bf16 at D 32, Sq > 4: every
//   float32 check of the port, and the `--reduced` training path):
//   `core::flash_fwd_core_kernel<T, D>`, exact float32 (FFMA on the CUDA
//   cores, no TF32), the port's precision reference.  What bounds it: the
//   FP32 rate, 67 TFLOP/s (4*D flops a visible pair), once shared memory
//   feeds the FFMAs fast enough.  The design, in `core::Fwd<T, D>`:
//   - 256 threads a block over a 64-row q-tile; KV tiles of 64 keys (32 at
//     D 256, so that Q and two stages of K and V fit the block's 227 KB:
//     213,776 B; 191,504 B at D 128).  A 16 x 16 grid of threads: thread
//     (ty, tx) holds S for rows ty + 16 i and keys tx + 16 j (4 x 4, 4 x 2
//     at D 256) and O for the same rows and D/16 columns, so the softmax's
//     row state is the thread's own.
//   - S = (Q scale) K^T reads four columns of each row as one 16-byte
//     load: 8 loads feed 64 FFMAs (8 a load).  Q is held scaled in float32;
//     K and V in their stored type (bf16 is widened as it is read).  Rows
//     are padded by 16 bytes, so the 8 rows a quarter-warp reads fall in
//     distinct banks; Q's reads are broadcasts (two rows a warp).
//   - K and V tiles stream through a ring of 2 stages by 16-byte cp.async
//     (rows past Sk zero-filled), with the keys' positions by 4-byte
//     copies: tile t + 1 loads while tile t computes.
//   - The online softmax runs in registers: a row's max and sum by
//     shuffles over its 16 threads (a half-warp), m and l in registers, the
//     alpha rescale applied to O's registers (the Pallas `safe_m` and
//     `alpha` guards); only P goes through shared memory for O += P V
//     (four keys of P as one load, V's rows as 16-byte loads).  Two block
//     barriers a tile.
//   - Before the walk the block flags every KV tile once (dead, wholly
//     visible, masked; a missing key counts as padding) and lists the live
//     ones, 256 tiles at a time (so shared memory does not grow with Sk);
//     the ring walks the list, the elementwise mask runs only on masked
//     tiles.  Blocks are tile-major; causal grids start with the q-tiles
//     that have the most live tiles.
//   What keeps it from the FP32 rate: one block of 8 warps an SM (its
//   shared memory), two barriers and a half-warp's shuffles a tile, the
//   diagonal tiles' masked half and the causal grid's imbalance.
#include <type_traits>

#include "common.cuh"
#include "decode.cuh"
#include "hopper.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// The CUDA-core instance: float32, and bf16 at D 32, Sq > 4.
// ---------------------------------------------------------------------------

namespace core {

// The tiling and shared-memory layout (bytes) of one block at head dim D
// with K and V staged in T (mirrored by `core_fwd_tiling` and the kernel
// lint's closed form).  Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i of the q-tile: keys tx + 16 j of S, and columns VW tx + 16 VW c
// (c < NV) of O.
template <typename T, int D>
struct Fwd {
  static constexpr int BQ = 64;                // q rows a block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys a KV tile
  static constexpr int kStages = 2;             // depth of the K/V ring
  static constexpr int TR = BQ / 16, TK = BK / 16;  // rows and keys of a thread's S
  static constexpr int VW = D >= 64 ? 4 : 2;    // O columns a vector
  static constexpr int NV = D / 16 / VW;        // O vectors a row of a thread
  static constexpr int QS = D + 4;              // float32 row of Q: 16 bytes of padding
  static constexpr int KS = D + 16 / (int)sizeof(T);  // row of K and V in T: 16 bytes too
  static constexpr int PS = BK + 16;            // row of P
  static constexpr int kStage = 2 * BK * KS * (int)sizeof(T);  // K, then V
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + 4 * BQ * QS;
  static constexpr int kP = kKV + kStages * kStage;
  static constexpr int kKp = kP + 4 * BQ * PS;    // key positions, a stage each
  static constexpr int kQp = kKp + 4 * kStages * BK;
  static constexpr int kLive = kQp + 4 * BQ;
  static constexpr int kFlags = kLive + 4 * kFlagChunk;
  static constexpr int kMisc = kFlags + kFlagChunk;  // q range, live count
  static constexpr int kBytes = kMisc + 16;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos, T* __restrict__ out,
                          float* __restrict__ lse, int B, int Sq, int Sk, int Hq, int Hkv,
                          int causal, int has_window, int window, float scale) {
  using L = Fwd<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  T* sKV = reinterpret_cast<T*>(smem + L::kKV);
  float* sP = reinterpret_cast<float*>(smem + L::kP);
  int* sKp = reinterpret_cast<int*>(smem + L::kKp);
  int* sQp = reinterpret_cast<int*>(smem + L::kQp);
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

  // Q, scaled, in float32 (rows past Sq are zero), and the q positions.
  constexpr int QC = D / 4;
  for (int i = tid; i < L::BQ * QC; i += kThreads) {
    const int r = i / QC, c = 4 * (i % QC);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) ld_vec(q + (((size_t)b * Sq + q0 + r) * Hq + h) * D + c, x);
    const float y[4] = {x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale};
    st_vec(sQ + r * L::QS + c, y);
  }
  if (tid < L::BQ) sQp[tid] = q0 + tid < Sq ? q_pos[(size_t)b * Sq + q0 + tid] : 0;
  __syncthreads();
  if (warp == 0) warp_range(sQp, min(L::BQ, Sq - q0), sMisc);  // the real rows' range

  auto load_tile = [&](int stage, int entry) {
    load_kv_tile<T, D, L::BK, L::KS>(sKV + stage * (L::kStage / (int)sizeof(T)),
                                     sKp + stage * L::BK, kb, vb, kpb, key_stride,
                                     (entry & kTileMask) * L::BK, Sk);
  };

  float o[L::TR][L::NV][L::VW], m[L::TR], l[L::TR];
#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::NV; ++c)
#pragma unroll
      for (int w = 0; w < L::VW; ++w) o[i][c][w] = 0.f;
  }

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

      // S = (Q scale) K^T: four columns of a row of Q and of each key a step.
      float s[L::TR][L::TK];
#pragma unroll
      for (int i = 0; i < L::TR; ++i)
#pragma unroll
        for (int j = 0; j < L::TK; ++j) s[i][j] = 0.f;
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
      if ((entry >> kFlagShift) == 2) {  // masked element by element
#pragma unroll
        for (int i = 0; i < L::TR; ++i)
#pragma unroll
          for (int j = 0; j < L::TK; ++j) {
            const int key = tx + 16 * j;
            if (!(k0 + key < Sk &&
                  visible(sQp[ty + 16 * i], kp[key], is_causal, windowed, window)))
              s[i][j] = kNegInf;
          }
      }
      // The online softmax in registers (the Pallas body's safe_m and
      // alpha guards); a row's max and sum over its 16 threads.
#pragma unroll
      for (int i = 0; i < L::TR; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < L::TK; ++j) mx = fmaxf(mx, s[i][j]);
        const float mnew = fmaxf(m[i], half_warp_max(mx));
        const float safe = mnew <= kNegInf / 2 ? 0.f : mnew;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < L::TK; ++j) {
          const float p = s[i][j] > kNegInf ? expf(s[i][j] - safe) : 0.f;
          sP[(ty + 16 * i) * L::PS + tx + 16 * j] = p;
          ps += p;
        }
        const float a = m[i] <= kNegInf / 2 ? 0.f : expf(fminf(m[i] - safe, 0.f));
        l[i] = a * l[i] + half_warp_sum(ps);
        m[i] = mnew;
#pragma unroll
        for (int c = 0; c < L::NV; ++c)
#pragma unroll
          for (int w = 0; w < L::VW; ++w) o[i][c][w] *= a;
      }
      __syncthreads();  // P is whole
      // O += P V: four keys of P's rows a step, one row of V at a time.
#pragma unroll
      for (int n = 0; n < L::BK; n += 4) {
        float pa[L::TR][4];
#pragma unroll
        for (int i = 0; i < L::TR; ++i) ld_vec(sP + (ty + 16 * i) * L::PS + n, pa[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[L::NV][L::VW];
#pragma unroll
          for (int c = 0; c < L::NV; ++c)
            ld_vec(sV + (n + u) * L::KS + L::VW * (tx + 16 * c), vv[c]);
#pragma unroll
          for (int i = 0; i < L::TR; ++i)
#pragma unroll
            for (int c = 0; c < L::NV; ++c)
#pragma unroll
              for (int w = 0; w < L::VW; ++w) o[i][c][w] = fmaf(pa[i][u], vv[c][w], o[i][c][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < L::TR; ++i) {
    const int sq = q0 + ty + 16 * i;
    if (sq >= Sq) continue;
    const size_t row = ((size_t)b * Sq + sq) * Hq + h;
    const float li = l[i];
#pragma unroll
    for (int c = 0; c < L::NV; ++c) {
      float x[L::VW];
#pragma unroll
      for (int w = 0; w < L::VW; ++w) x[w] = li > 0.f ? o[i][c][w] / li : 0.f;
      st_vec(out + row * D + L::VW * (tx + 16 * c), x);
    }
    if (tx == 0) lse[row] = li > 0.f ? m[i] + logf(li) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qp, const int* kp,
                   void* out, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int has_window, int window, float scale, cudaStream_t stream) {
  using L = Fwd<T, D>;
  auto kern = flash_fwd_core_kernel<T, D>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  // Vector loads of q and 16-byte cp.async copies of k and v.
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return cudaErrorMisalignedAddress;
  const long long blocks = (long long)((Sq + L::BQ - 1) / L::BQ) * Hq * B;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qp, kp,
      static_cast<T*>(out), lse, B, Sq, Sk, Hq, Hkv, causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace core

// bf16 calls with D 64/128/256 are the wgmma instance's (Sq > 4) or the
// decode instance's (Sq <= 4): only float32 instantiates the CUDA-core
// kernel at those widths.
template <typename T>
cudaError_t pick_dim(int D, const void* q, const void* k, const void* v, const int* qp,
                     const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                     int Hkv, int causal, int has_window, int window, float scale,
                     cudaStream_t stream) {
  constexpr bool f32 = std::is_same_v<T, float>;
  switch (D) {
    case 32:
      return core::launch<T, 32>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                 has_window, window, scale, stream);
    case 64:
      if constexpr (f32)
        return core::launch<T, 64>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                   has_window, window, scale, stream);
      break;
    case 128:
      if constexpr (f32)
        return core::launch<T, 128>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                    has_window, window, scale, stream);
      break;
    case 256:
      if constexpr (f32)
        return core::launch<T, 256>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                    has_window, window, scale, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one CUDA-core block at head dim D (bytes), or 0
// where no instance exists (bf16 is instantiated at D 32 only).
inline size_t core_smem_bytes(int D, int bf16) {
  if (bf16) return D == 32 ? core::Fwd<__nv_bfloat16, 32>::kBytes : 0;
  switch (D) {
    case 32: return core::Fwd<float, 32>::kBytes;
    case 64: return core::Fwd<float, 64>::kBytes;
    case 128: return core::Fwd<float, 128>::kBytes;
    case 256: return core::Fwd<float, 256>::kBytes;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The wgmma instance: bf16, D in {64, 128, 256}, Sq > 4.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kMaxSmem = 232448;  // the opt-in maximum of one block
constexpr float kLog2e = 1.4426950408889634f;

// The instance's tiling at head dim D: how a block's two consumer
// warpgroups share its work, keys a KV tile, and the registers of the two
// roles (128 * producer + 256 * consumer <= 65536).  Up to D 128 by rows:
// a 128-row q-tile, 64 rows and every column of O a consumer, 128-key
// tiles (64 x D of O and 64 x 128 of S: at most 128 floats), 232
// registers.  At D 256 by columns: a 64-row q-tile that both consumers
// hold, each forming S over the whole D and accumulating its half of O's
// columns (64 x 128 of O and 64 x 64 of S: 96 floats), 64-key tiles, 240
// registers.  A consumer holding all 256 of O's columns (128 floats beside
// 32 of S) spilled 404 B and serialised its wgmma (C7512) on an H100.
template <int D>
struct Tiling {
  static constexpr bool kByCols = D > 128;
  static constexpr int kBQ = kByCols ? 64 : 128;  // q rows per block
  static constexpr int kCols = kByCols ? D / 2 : D;  // O columns a consumer
  static constexpr int kBK = kByCols ? 64 : 128;
  static constexpr int kProducerRegs = kByCols ? 24 : 40;
  static constexpr int kConsumerRegs = kByCols ? 240 : 232;
};

// Shared memory, from a 1024-byte aligned base: Q, then per stage K and V,
// the mbarriers, the q-position range and one flag per KV tile (0 dead, 1
// visible to every row, 2 masked).
template <int D>
struct Smem {
  using QT = Tile<D, Tiling<D>::kBQ>;
  using KT = Tile<D, Tiling<D>::kBK>;
  static constexpr int kQ = 0;
  static constexpr int kKV = QT::kBytes;  // stage s: K at kKV + 2*s*KT::kBytes, V after it
  static constexpr int kBars = kKV + 2 * kStages * KT::kBytes;  // full[], empty[], q
  static constexpr int kQRange = kBars + 8 * (2 * kStages + 1);
  static constexpr int kFlags = kQRange + 8;
  static constexpr int kMaxTiles = (kMaxSmem - 1024 - kFlags) / 4;  // KV tiles a block can flag
  static size_t bytes(int nk) { return 1024 + kFlags + 4 * static_cast<size_t>(nk); }
};
// D 256: 160 KB of Q and two K/V stages; flags for Sk up to 1,080,576.
static_assert(Smem<256>::kMaxTiles * Tiling<256>::kBK >= 500000 &&
                  Smem<128>::kMaxTiles * Tiling<128>::kBK >= 500000,
              "the layout leaves room for the flags of 500,000 keys");

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                           int Sk, int Hq, int Hkv, int causal, int has_window, int window,
                           float scale) {
  using L = Smem<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  using TL = Tiling<D>;
  constexpr int BQ = TL::kBQ, BK = TL::kBK, NC = TL::kCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + L::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = full0 + 16 * kStages;
  int* q_range = reinterpret_cast<int*>(smem + L::kQRange);
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Causal: the q-tiles with the most live KV tiles start first.
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int nk = (Sk + BK - 1) / BK;
  const bool is_causal = causal != 0, windowed = has_window != 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);             // the producer's arrive + the TMA bytes
      mbar_init(empty0 + 8 * s, 2 * 128);      // every consumer thread
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
  // The tile list, computed once for producer and consumers alike: both
  // walk the live tiles in the same order, so the mbarrier phases agree.
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
    setmaxnreg_dec<TL::kProducerRegs>();
    if (tid == 0) {
      mbar_arrive_expect_tx(qbar, QT::kBytes);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sbase + L::kQ + c * QT::kRegion, &tm_q, qbar, 64 * c, h, q0, b);
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
    // rows and NC of O's columns each ---------------------------------------
    setmaxnreg_inc<TL::kConsumerRegs>();
    const int wgi = (warp >> 2) - 1;
    const int c4 = lane & 3;
    const int row_off = TL::kByCols ? 0 : 64 * wgi, col_off = TL::kByCols ? NC * wgi : 0;
    // wgmma's accumulator layout: this thread holds rows r0 and r0 + 8 of
    // its warpgroup's 64, and columns 8i + 2*c4 + {0, 1} of every n8 chunk i.
    const int r0 = row_off + 16 * (warp & 3) + (lane >> 2);
    int qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + r0 + 8 * r;
      qp[r] = s < Sq ? q_pos[(size_t)b * Sq + s] : 0;
    }
    float o[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint64_t q_desc = sw128_desc(sbase + L::kQ + row_off * kRowBytes, 16, 1024);
    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nk; ++t) {
      const int flag = flags[t];
      if (flag == 0) continue;
      const uint32_t k_addr = sbase + L::kKV + 2 * stage * KT::kBytes;
      const uint32_t v_addr = k_addr + KT::kBytes;
      mbar_wait(full0 + 8 * stage, phase);

      // S = Q K^T: both K-major, 16 columns of D per product (at D 256 both
      // consumers form the same S: the same products in the same order, so
      // both halves of a row see the same P, m and l).  The opaque copy of
      // q_desc keeps the compiler from holding all of its offsets in
      // registers across the loop.
      uint64_t dq = q_desc;
      asm volatile("" : "+l"(dq));
      const uint64_t dk = sw128_desc(k_addr, 16, 1024);
      // Scores of this tile only: nothing of the last tile's P stays live.
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs<BK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, dq + kmajor_step(kk, QT::kRegion), dk + kmajor_step(kk, KT::kRegion),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);

      // Online softmax in registers, written as the Pallas body.
      if (flag == 2) {
        const int* kpt = k_pos + (size_t)b * Sk;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const int j = t * BK + 8 * i + 2 * c4;
          const int kp0 = j < Sk ? kpt[j] : 2 * kPadHalf;
          const int kp1 = j + 1 < Sk ? kpt[j + 1] : 2 * kPadHalf;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& s0 = sc[4 * i + 2 * r];
            float& s1 = sc[4 * i + 2 * r + 1];
            s0 = visible(qp[r], kp0, is_causal, windowed, window) ? s0 * scale : kNegInf;
            s1 = visible(qp[r], kp1, is_causal, windowed, window) ? s1 * scale : kNegInf;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;
      }
      float alpha[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
        const float mnew = fmaxf(m[r], quad_max(mx));
        const float safe = mnew <= kNegInf / 2 ? 0.f : mnew;
        alpha[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f(fminf(m[r] - safe, 0.f) * kLog2e);
        m[r] = mnew;
        neg[r] = -safe * kLog2e;
      }
      // A masked score is kNegInf, so its exp2 underflows to exactly 0.
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = sc[4 * i + e];
          s = exp2f(fmaf(s, kLog2e, neg[e >> 1]));
          psum[e >> 1] += s;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];  // quad-summed at the end
#pragma unroll
      for (int i = 0; i < NC / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      // P as the A operand from registers: the f32 accumulator fragment of
      // S, converted to bf16 pairs in place, is wgmma's A fragment of P.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      // O += P V over this warpgroup's columns: V is the MN-major B operand
      // (rows of D along N), from the 64-column region of col_off.
      fence_regs<NC / 2>(o);
      wgmma_fence();
      const uint64_t dv = sw128_desc(v_addr + (col_off / 64) * KT::kRegion, KT::kRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<NC>(o, pa[kk], dv + mnmajor_step(kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NC / 2>(o);
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // out = acc / l where l > 0, else exactly 0; lse = m + log(l) or -inf.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      const int s = q0 + r0 + 8 * r;
      if (s >= Sq) continue;
      const bool valid = lr > 0.f;
      // One reciprocal (rcp.approx, within 1 ulp of 1/l for l >= 1) per row,
      // with no division subroutine call while the accumulator is live.
      const float inv = valid ? __fdividef(1.f, lr) : 0.f;
      __nv_bfloat16* orow = out + (((size_t)b * Sq + s) * Hq + h) * D + col_off + 2 * c4;
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16x2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (c4 == 0 && col_off == 0)
        lse[((size_t)b * Sq + s) * Hq + h] = valid ? m[r] + logf(lr) : -INFINITY;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qp, const int* kp,
                   void* out, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int has_window, int window, float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  constexpr int BQ = Tiling<D>::kBQ, BK = Tiling<D>::kBK;
  if ((err = make_bf16_map(&tq, q, D, Hq, Sq, B, BQ)) != cudaSuccess) return err;
  // With no keys there is no KV tile to load, but a map needs a nonzero
  // extent and an address: it is built over one row of q and never read.
  if ((err = make_bf16_map(&tk, Sk ? k : q, D, Hkv, Sk ? Sk : 1, B, BK)) != cudaSuccess)
    return err;
  if ((err = make_bf16_map(&tv, Sk ? v : q, D, Hkv, Sk ? Sk : 1, B, BK)) != cudaSuccess)
    return err;
  const size_t smem = Smem<D>::bytes((Sk + BK - 1) / BK);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, qp, kp, static_cast<__nv_bfloat16*>(out), lse,
                                         Sq, Sk, Hq, Hkv, causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace wg

// Which instance takes a call (mirrored by `flash_fwd_instance` in
// kernels/flash_attention.py): every call with Sq <= 4 goes to the decode
// instance, bf16 calls with D 64/128/256 and Sq > 4 to the wgmma instance,
// the rest (float32, and D = 32) to the CUDA-core instance.
inline bool takes_decode(int Sq) { return Sq <= 4; }
inline bool takes_wgmma(int bf16, int D, int Sq) {
  return bf16 && (D == 64 || D == 128 || D == 256) && Sq > 4;
}

}  // namespace rt

// C entry: returns the cudaError_t of the launch (0 on success).
// `bf16` selects __nv_bfloat16 inputs/outputs, else float32.  The decode
// instance (Sq <= 4) splits the KV range into ceil(ceil(Sk/32) /
// tiles_per_split) splits; with more than one it needs the float32 scratch
// `part_out` (splits, B*Sq*Hq, D), `part_lse` (splits, B*Sq*Hq) and the int32
// `counters` (B*Hkv*ceil(group*Sq/64)), zero at rest and left zero.  On the
// cluster instance (bf16, D 256) the splits are the blocks of one cluster,
// which merge in shared memory: it needs no scratch.  The other instances
// ignore those four arguments.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* q_pos,
                         const void* k_pos, void* out, void* lse, void* part_out,
                         void* part_lse, void* counters, int B, int Sq, int Sk, int Hq, int Hkv,
                         int D, int bf16, int causal, int has_window, int window, float scale,
                         int tiles_per_split, void* stream) {
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rt::takes_decode(Sq)) {
    rt::dec::Args a{};
    a.q = q;
    a.k = k;
    a.v = v;
    a.q_pos = qp;
    a.k_pos = kp;
    a.out = out;
    a.lse = l;
    a.part_out = static_cast<float*>(part_out);
    a.part_lse = static_cast<float*>(part_lse);
    a.counters = static_cast<int*>(counters);
    a.B = B;
    a.Sq = Sq;
    a.Sk = Sk;
    a.Hq = Hq;
    a.Hkv = Hkv;
    a.causal = causal;
    a.has_window = has_window;
    a.window = window;
    a.scale = scale;
    a.tiles_per_split = tiles_per_split;
    return (int)rt::dec::run<false>(a, D, bf16, s);
  }
  if (rt::takes_wgmma(bf16, D, Sq)) {
    if (D == 256)
      return (int)rt::wg::launch<256>(q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv, causal,
                                      has_window, window, scale, s);
    if (D == 128)
      return (int)rt::wg::launch<128>(q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv, causal,
                                      has_window, window, scale, s);
    return (int)rt::wg::launch<64>(q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv, causal,
                                   has_window, window, scale, s);
  }
  if (bf16)
    return (int)rt::pick_dim<__nv_bfloat16>(D, q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv,
                                            causal, has_window, window, scale, s);
  return (int)rt::pick_dim<float>(D, q, k, v, qp, kp, out, l, B, Sq, Sk, Hq, Hkv, causal,
                                  has_window, window, scale, s);
}

// 1 if a call of this type, head dim and Sq goes to the wgmma instance.
extern "C" int flash_fwd_takes_wgmma(int bf16, int D, int Sq) {
  return rt::takes_wgmma(bf16, D, Sq) ? 1 : 0;
}

// Dynamic shared memory of one wgmma-instance block (bytes), or -1.
template <int D>
static int wgmma_smem(int Sk) {
  constexpr int BK = rt::wg::Tiling<D>::kBK;
  return (int)rt::wg::Smem<D>::bytes((Sk + BK - 1) / BK);
}
extern "C" int flash_fwd_wgmma_smem(int D, int Sk) {
  if (D == 256) return wgmma_smem<256>(Sk);
  if (D == 128) return wgmma_smem<128>(Sk);
  if (D == 64) return wgmma_smem<64>(Sk);
  return -1;
}

// Dynamic shared memory of one CUDA-core block (bytes) at head dim D and
// type (`bf16` 1: D 32 only), or -1 where no CUDA-core instance exists.
extern "C" int flash_fwd_core_smem(int D, int bf16) {
  const size_t bytes = rt::core_smem_bytes(D, bf16);
  return bytes ? (int)bytes : -1;
}

// 1 if a decode call of this type and head dim runs on the cluster
// instance of decode_d256.cuh (mirrored by `decode_core_instance`).
extern "C" int decode_takes_cluster(int bf16, int D) {
  return rt::dec::takes_cluster(bf16, D) ? 1 : 0;
}

// Clusters of `cluster` blocks of the cluster instance that the card holds
// at once at the block's shared memory (cudaOccupancyMaxActiveClusters), or
// minus the cudaError_t of the query.
extern "C" int decode_cluster_max_active(int cluster) {
  int n = 0;
  const cudaError_t err = rt::dcl::max_active_clusters<false>(cluster, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Dynamic shared memory of one block of the cluster instance (bytes).
extern "C" int decode_cluster_smem() { return (int)rt::dcl::Smem::bytes(); }

// Dynamic shared memory of one block of the split decode kernel (bytes), at
// `rows` (GQA group x Sq) a KV head and `tiles_per_split`, dense (`paged`
// 0, kernel A) or paged (1, kernel C); -1 where the split kernel takes no
// such call (bf16 D 256 runs on the cluster instance).
template <typename T, bool kPaged>
static size_t split_smem(int D, int rows, int tps) {
  switch (D) {
    case 32: return rt::dec::split_smem_bytes<T, 32, kPaged>(rows, tps);
    case 64: return rt::dec::split_smem_bytes<T, 64, kPaged>(rows, tps);
    case 128: return rt::dec::split_smem_bytes<T, 128, kPaged>(rows, tps);
    case 256:
      if constexpr (std::is_same_v<T, float>)
        return rt::dec::split_smem_bytes<T, 256, kPaged>(rows, tps);
      break;
  }
  return 0;
}
extern "C" int decode_split_smem(int bf16, int D, int rows, int paged, int tiles_per_split) {
  const size_t bytes =
      bf16 ? (paged ? split_smem<__nv_bfloat16, true>(D, rows, tiles_per_split)
                    : split_smem<__nv_bfloat16, false>(D, rows, tiles_per_split))
           : (paged ? split_smem<float, true>(D, rows, tiles_per_split)
                    : split_smem<float, false>(D, rows, tiles_per_split));
  return bytes ? (int)bytes : -1;
}
