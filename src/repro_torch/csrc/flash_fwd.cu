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
//   float32 and bf16, D 32/64/128, and D 256 at 9 to 16 rows a KV head, the
//   GQA group x Sq of recurrentgemma's local attention, group 10 at Sq 1):
//   the dense instance of the split-KV decode
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
// * The wgmma instance (bf16, D 64 or 128, Sq > 4: the training
//   calls and the serving prefill calls).  One block of 384 threads per
//   (128-row q-tile, query head, batch row).  Warpgroup 0 is the producer:
//   one thread loads the Q tile and then 128-key K and V tiles by TMA into
//   a ring of 2 shared-memory stages, guarded by full/empty mbarriers.
//   q, k and v are 4-D tensor maps (D, H, S, B) with 128-byte swizzle and
//   boxes of 64 columns x 128 rows (two per tile at D = 128); rows past Sq
//   or Sk read as zero, and such keys are masked by index as well.
//   Warpgroups 1 and 2 are consumers of 64 q rows each: S = Q K^T with
//   wgmma (m64n128k16, both operands K-major from shared memory), the
//   online softmax in registers (row max and sum over the 4 threads of a
//   quad; the Pallas `safe_m` and `alpha` guards), then O += P V with P
//   converted in place to bf16 as wgmma's register A operand and V read
//   as an MN-major B operand.  The elementwise mask runs only on tiles not
//   visible to every row of the q-tile.  Before the roles split, the block
//   computes each KV tile's flag (dead, wholly visible, masked) once into
//   shared memory, so producer and consumers walk the same tiles and the
//   mbarrier phases agree.  setmaxnreg gives the consumers 232 registers
//   and the producer 40.  Causal grids start with the q-tiles that have
//   the most live tiles.  Shared memory: 32 KB of Q and 2 x 64 KB of K/V
//   at D = 128 (half at D = 64).
//   What bounds it: the tensor-core rate (989 TFLOP/s bf16) at the training
//   and prefill shapes.  What keeps it from that bound: a warpgroup's
//   softmax does not overlap its own products, and the two consumer
//   warpgroups are not scheduled against each other (no ping-pong), so
//   the tensor cores idle while exponentials run.
//
// * The CUDA-core instance (float32 inputs, D = 32, and D = 256 in both
//   types, Sq > 4): one block of 128 threads per (q-tile of 32 rows, head,
//   batch row) walks KV tiles of 32 keys with the softmax state in shared
//   memory and float32 products on the CUDA cores, one multiply-add per
//   shared-memory read: bound by shared-memory bandwidth, far from the
//   tensor-core rate.  It is exact to float32 and stays as the reference
//   instance.  At D = 256 a thread owns two columns of every row of the
//   q-tile (64 accumulators) and the block's shared memory is 101 KB (bf16
//   is widened to float32 on load).  It is recurrentgemma's bf16 training
//   instance until a wgmma instance is tiled for D = 256, whose O
//   accumulator would double past the ~128 floats a thread that keep the
//   D 64/128 instances free of spills.
#include <type_traits>

#include "common.cuh"
#include "decode.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int kBK = 32;  // keys per tile: one per lane in the softmax pass
constexpr int kBQ = 32;  // q rows per block

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                     int has_window, int window, float scale) {
  static_assert(kThreads % D == 0 || D % kThreads == 0, "D must tile the block");
  static_assert((kBQ * D) % kThreads == 0 && (kBQ * kBK) % kThreads == 0, "tile split");
  // A thread owns column tid % D of rows tid / D + i * RSTEP when D <= the
  // block; past it (D = 256) columns tid + c * kThreads of every row.
  constexpr int CPT = D > kThreads ? D / kThreads : 1;  // columns per thread
  constexpr int RSTEP = D > kThreads ? 1 : kThreads / D;
  constexpr int NR = kBQ / RSTEP;  // rows per thread
  constexpr int SPT = kBQ * kBK / kThreads;  // scores per thread
  constexpr int SSTEP = kThreads / kBK;
  constexpr int KS = D + 1;  // padded K row: lanes on distinct keys hit distinct banks

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * KS;
  float* sP = sV + kBK * D;
  float* sM = sP + kBQ * kBK;
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;
  int* sQp = reinterpret_cast<int*>(sA + kBQ);
  int* sKp = sQp + kBQ;
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0, windowed = has_window != 0;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, s = q0 + r;
    sQ[i] = s < Sq ? to_f(q[(((size_t)b * Sq + s) * Hq + h) * D + i % D]) * scale : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int s = q0 + r;
    sQp[r] = s < Sq ? q_pos[(size_t)b * Sq + s] : 0;
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = INT32_MAX, hi = INT32_MIN;
    for (int r = 0; r < kBQ && q0 + r < Sq; ++r) {
      lo = min(lo, sQp[r]);
      hi = max(hi, sQp[r]);
    }
    s_qmin = lo;
    s_qmax = hi;
  }

  float acc[NR][CPT];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  const int d = tid % D, row0 = tid / D;

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
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const int qp = sQp[r];
      softmax_row(
          sP + r * kBK, kBK,
          [&](int j) { return visible(qp, sKp[j], is_causal, windowed, window); },
          sM + r, sL + r, sA + r);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= sA[row0 + i * RSTEP];
    for (int j = 0; j < kBK; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[j * D + d + c * kThreads];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float p = sP[(row0 + i * RSTEP) * kBK + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + i * RSTEP, s = q0 + r;
    if (s < Sq) {
      const float l = sL[r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float o = l > 0.f ? acc[i][c] / l : 0.f;
        out[(((size_t)b * Sq + s) * Hq + h) * D + d + c * kThreads] = from_f<T>(o);
      }
    }
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int s = q0 + r;
    if (s < Sq) {
      const float l = sL[r];
      lse[((size_t)b * Sq + s) * Hq + h] = l > 0.f ? sM[r] + logf(l) : -INFINITY;
    }
  }
}

// The CUDA-core instance's launch; bf16 at D 64/128 is the wgmma
// instance's (Sq > 4) or the decode instance's (Sq <= 4).
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* qp,
                       const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                       int Hkv, int causal, int has_window, int window, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && (D == 64 || D == 128)) {
    return cudaErrorInvalidValue;
  } else {
    constexpr size_t smem = fwd_smem_bytes<D>();
    auto kern = flash_fwd_kernel<T, D>;
    // The shared-memory opt-in is set once per template instance (per process).
    static const cudaError_t attr =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qp, kp,
        static_cast<T*>(out), lse, Sq, Sk, Hq, Hkv, causal, has_window, window, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t pick_dim(int D, const void* q, const void* k, const void* v, const int* qp,
                     const int* kp, void* out, float* lse, int B, int Sq, int Sk, int Hq,
                     int Hkv, int causal, int has_window, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_fwd<T, 32>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                               has_window, window, scale, stream);
    case 64:
      return launch_fwd<T, 64>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                               has_window, window, scale, stream);
    case 128:
      return launch_fwd<T, 128>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                has_window, window, scale, stream);
    case 256:
      return launch_fwd<T, 256>(q, k, v, qp, kp, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                                has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The wgmma instance: bf16, D in {64, 128}, Sq > 4.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBQ = 128;            // q rows per block: two consumer warpgroups of 64
constexpr int kBK = 128;            // keys per KV tile
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kRegion = 128 * 128;  // bytes of one 128-row x 64-column bf16 region
constexpr int kProducerRegs = 40;   // 128 * 40 + 256 * 232 = 384 * 168, the launch budget
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;    // the opt-in maximum of one block
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base: Q (kHalves regions), then
// per stage K and V (kHalves regions each), the mbarriers, the q-position
// range and one flag per KV tile (0 dead, 1 visible to every row, 2 masked).
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  static constexpr int kTile = kHalves * kRegion;  // bytes of a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kKV = kTile;  // stage s: K at kKV + 2*s*kTile, V after it
  static constexpr int kBars = kKV + 2 * kStages * kTile;  // full[], empty[], q
  static constexpr int kQRange = kBars + 8 * (2 * kStages + 1);
  static constexpr int kFlags = kQRange + 8;
  static size_t bytes(int nk) { return 1024 + kFlags + 4 * static_cast<size_t>(nk); }
};

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
  const int q0 = qt * kBQ, h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int nk = (Sk + kBK - 1) / kBK;
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
  if (tid < kBQ) {
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
      for (int j = t * kBK + lane; j < (t + 1) * kBK; j += 32) {
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
      mbar_arrive_expect_tx(qbar, L::kTile);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_4d(sbase + L::kQ + c * kRegion, &tm_q, qbar, 64 * c, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < nk; ++t) {
        if (flags[t] == 0) continue;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t kdst = sbase + L::kKV + 2 * stage * L::kTile;
        mbar_arrive_expect_tx(full, 2 * L::kTile);
        for (int c = 0; c < L::kHalves; ++c) {
          tma_load_4d(kdst + c * kRegion, &tm_k, full, 64 * c, hk, t * kBK, b);
          tma_load_4d(kdst + L::kTile + c * kRegion, &tm_v, full, 64 * c, hk, t * kBK, b);
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
    int qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + r0 + 8 * r;
      qp[r] = s < Sq ? q_pos[(size_t)b * Sq + s] : 0;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // Descriptors move along the reduction dim by adding the byte offset / 16
    // to the start-address field (no carry: shared addresses are < 2^18).
    const uint64_t q_desc = sw128_desc(sbase + L::kQ + 64 * 128 * wgi, 16, 1024);
    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nk; ++t) {
      const int flag = flags[t];
      if (flag == 0) continue;
      const uint32_t k_addr = sbase + L::kKV + 2 * stage * L::kTile;
      const uint32_t v_addr = k_addr + L::kTile;
      mbar_wait(full0 + 8 * stage, phase);

      // S = Q K^T: both K-major, 16 columns of D per product.  The opaque
      // copy of q_desc keeps the compiler from holding all of its offsets
      // in registers across the loop.
      uint64_t dq = q_desc;
      asm volatile("" : "+l"(dq));
      const uint64_t dk = sw128_desc(k_addr, 16, 1024);
      // Scores of this tile only: nothing of the last tile's P stays live.
      float sc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      fence_regs<kBK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kRegion + (kk % 4) * 32) >> 4;
        wgmma_ss_n128(sc, dq + off, dk + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<kBK / 2>(sc);

      // Online softmax in registers, written as the Pallas body.
      if (flag == 2) {
        const int* kpt = k_pos + (size_t)b * Sk;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
          const int j = t * kBK + 8 * i + 2 * c4;
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
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale;
      }
      float alpha[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i)
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
      for (int i = 0; i < kBK / 8; ++i) {
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
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      // P as the A operand from registers: the f32 accumulator fragment of
      // S, converted to bf16 pairs in place, is wgmma's A fragment of P.
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      // O += P V: V is the MN-major B operand (rows of D along N).
      fence_regs<D / 2>(o);
      wgmma_fence();
      const uint64_t dv = sw128_desc(v_addr, kRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<D>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(o);
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
      __nv_bfloat16* orow = out + (((size_t)b * Sq + s) * Hq + h) * D + 2 * c4;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16x2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (c4 == 0) lse[((size_t)b * Sq + s) * Hq + h] = valid ? m[r] + logf(lr) : -INFINITY;
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
  if ((err = make_bf16_map(&tq, q, D, Hq, Sq, B, kBQ)) != cudaSuccess) return err;
  // With no keys there is no KV tile to load, but a map needs a nonzero
  // extent and an address: it is built over one row of q and never read.
  if ((err = make_bf16_map(&tk, Sk ? k : q, D, Hkv, Sk ? Sk : 1, B, kBK)) != cudaSuccess)
    return err;
  if ((err = make_bf16_map(&tv, Sk ? v : q, D, Hkv, Sk ? Sk : 1, B, kBK)) != cudaSuccess)
    return err;
  const size_t smem = Smem<D>::bytes((Sk + kBK - 1) / kBK);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, qp, kp, static_cast<__nv_bfloat16*>(out), lse,
                                         Sq, Sk, Hq, Hkv, causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace wg

// Which instance takes a call (mirrored by `flash_fwd_instance` in
// kernels/flash_attention.py): every call with Sq <= 4 goes to the decode
// instance, bf16 calls with D 64/128 and Sq > 4 to the wgmma instance, the
// rest (float32, D = 32, D = 256) to the CUDA-core instance.
inline bool takes_decode(int Sq) { return Sq <= 4; }
inline bool takes_wgmma(int bf16, int D, int Sq) {
  return bf16 && (D == 64 || D == 128) && Sq > 4;
}

}  // namespace rt

// C entry: returns the cudaError_t of the launch (0 on success).
// `bf16` selects __nv_bfloat16 inputs/outputs, else float32.  The decode
// instance (Sq <= 4) splits the KV range into ceil(ceil(Sk/32) /
// tiles_per_split) splits; with more than one it needs the float32 scratch
// `part_out` (splits, B*Sq*Hq, D), `part_lse` (splits, B*Sq*Hq) and the int32
// `counters` (B*Hkv*ceil(group*Sq/64)), zero at rest and left zero.  The
// other instances ignore those four arguments.
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

// Dynamic shared memory of one wgmma-instance block (bytes), or -1.
extern "C" int flash_fwd_wgmma_smem(int D, int Sk) {
  const int nk = (Sk + rt::wg::kBK - 1) / rt::wg::kBK;
  if (D == 128) return (int)rt::wg::Smem<128>::bytes(nk);
  if (D == 64) return (int)rt::wg::Smem<64>::bytes(nk);
  return -1;
}
