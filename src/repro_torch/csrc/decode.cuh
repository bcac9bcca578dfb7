// The split-KV decode core shared by kernel A's decode instance
// (flash_fwd.cu, dense K/V rows) and kernel C (paged_decode.cu, K/V pages
// reached through a block table).
//
// A decode call has few query rows (the GQA group x Sq <= 4) against a long
// KV range, so it is bound by the bytes of the live keys over the memory
// rate.  The design spreads those bytes over the card and keeps each byte's
// path short:
//
// * One block of 128 threads per (KV head, batch row, chunk of <= 64 rows,
//   split of the KV range).  The block holds every query row of its KV head
//   (group x Sq), so K and V are read once per group, never per query head.
//   The split count comes from the SM count and the KV length (the caller's
//   `decode_split_rule` in kernels/flash_attention.py): about
//   DECODE_BLOCKS_PER_SM blocks per SM, each split a whole number of 32-key
//   tiles, at most kMaxSplitTiles.
// * At block start the split's key positions (and, paged, each key's
//   physical pool row) are read once into shared memory, and each 32-key
//   tile's liveness is decided by warp reductions over them with the
//   `tile_flag` predicate (dead: every key padding, causally after every
//   row, or out of every row's window).  The live tiles are compacted into
//   a list.  Paged liveness comes from the raw table entry: an unmapped
//   entry's keys are padding and no memory behind it is ever read.
// * Live tiles stream through a ring of kStages shared-memory stages fed by
//   cp.async (16 bytes a thread, zero-filled past the end or behind an
//   unmapped entry), kStages - 1 tiles in flight while one is scored; one
//   __syncthreads per tile.  K and V stay in their stored type.
// * The four warps split the block as WR row groups x WK key groups, and
//   the lanes of a warp split into key groups of LPK lanes that share one
//   key's row in 16-byte vectors: a key's dot product is a shuffle reduction
//   over its group.  Each key group keeps its own online softmax (m, l, and
//   acc over its VEC columns) in registers, with the Pallas `safe_m` and
//   `alpha` guards, rescaled once per chunk of keys; no cross-lane
//   reduction runs per tile.  At the end the key groups of a warp merge by
//   a shuffle butterfly and the WK warps of each row in warp order.
// * One split writes its row directly; several write float32 partials
//   (normalised out, lse), and the last-arriving block of each (KV head,
//   batch row, row chunk), found with an atomic counter, merges all splits
//   in split order with the lse-weighted Update() and resets the counter to
//   0.  The merge order is fixed, so results are bitwise repeatable; a row
//   that sees no key gives exactly (0, -inf).
#pragma once

#include "common.cuh"

namespace rt {
namespace dec {

constexpr int kTK = 32;             // keys per KV tile (one per lane in the flag pass)
constexpr int kStages = 3;          // depth of the cp.async ring
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;        // query rows one block holds (group x Sq)
constexpr int kMaxSplitTiles = 64;  // tiles of one split (bounds the position arrays)
constexpr int kMaxSmem = 232448;    // the opt-in maximum of one block
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

struct Args {
  const void* q;             // (B, Sq, Hq, D)
  const void* k;             // dense (B, Sk, Hkv, D); paged pool (n_pages, ps, Hkv, D)
  const void* v;             // as k
  const int* q_pos;          // (B, Sq)
  const int* k_pos;          // dense (B, Sk); paged pos_pool (n_pages, ps)
  const int* block_tables;   // paged (B, W); dense unused
  void* out;                 // (B, Sq, Hq, D), q's type
  float* lse;                // (B, Sq, Hq)
  float* part_out;           // (splits, B*Sq*Hq, D) when splits > 1
  float* part_lse;           // (splits, B*Sq*Hq) when splits > 1
  int* counters;             // (B*Hkv*rchunks), 0 at rest, when splits > 1
  int B, Sq, Sk, Hq, Hkv;    // paged: Sq = 1, Sk = W * ps
  int n_pages, ps, W;        // paged only
  int causal, has_window, window;
  float scale;
  int tiles_per_split, splits, rchunks;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int Bytes>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

// N consecutive elements of type T from shared memory as floats, in loads
// of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* o) {
  if constexpr (N * sizeof(T) > 16) {
    load_f<T, N / 2>(p, o);
    load_f<T, N / 2>(p + N / 2, o + N / 2);
  } else {
    using R = typename Raw<N * sizeof(T)>::type;
    const R r = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(e[i]);
  }
}

template <typename T, int D, int WR, int RW, bool kPaged>
struct Shape {
  static constexpr int WK = kWarps / WR;       // warps along the keys of a tile
  static constexpr int RB = WR * RW;           // rows of the block
  static constexpr int TKW = kTK / WK;         // keys of a tile per warp
  // Elements of a lane's slice of a key row: 32 bytes at up to 2 rows a
  // warp, 16 up to 8 rows, 8 for bf16 at 16 rows, so that the slices of q
  // and acc (2 x RW x VEC floats) stay near 64 registers; and no wider than
  // lets the warp's TKW keys fill its lanes.
  static constexpr int VB = RW <= 2 ? 32 : (RW <= 8 || sizeof(T) == 4 ? 16 : 8);
  static constexpr int VEC0 = VB / sizeof(T);
  static constexpr int VEC = VEC0 < D * TKW / 32 ? VEC0 : D * TKW / 32;
  static constexpr int LPK = D / VEC;          // lanes sharing one key's row
  static constexpr int KPW = 32 / LPK;         // keys a warp scores at once
  static constexpr int PASSES = TKW / KPW;    // keys of a key group per tile
  // passes scored before one rescale: bounds the live scores at 16 a lane
  static constexpr int PC = PASSES < 16 / RW ? PASSES : (16 / RW > 0 ? 16 / RW : 1);
  static constexpr int ROWB = D * sizeof(T);   // bytes of one key row
  static constexpr int TILEB = kTK * ROWB;     // bytes of a K (or V) tile
  static constexpr int RING = kStages * 2 * TILEB;
  static_assert(WR * WK == kWarps && LPK <= 32 && KPW <= TKW && TKW % KPW == 0, "tiling");
  static_assert(sizeof(float) * (WK * RB * D + 2 * WK * RB) <= RING, "merge buffer");
  static size_t smem_bytes(int tps) {
    return RING + sizeof(float) * RB * D +
           sizeof(int) * (RB + static_cast<size_t>(tps) * kTK * (kPaged ? 2 : 1) + tps + 2);
  }
};

// The minimum of one block per SM moves ptxas off its default register
// target, which spilled 4-16 bytes in a few instances at 80-96 registers;
// the main-path layouts still fit 128 registers (4 blocks per SM).
template <typename T, int D, int WR, int RW, bool kPaged>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const Args a) {
  using S = Shape<T, D, WR, RW, kPaged>;
  constexpr int WK = S::WK, RB = S::RB, TKW = S::TKW, VEC = S::VEC, LPK = S::LPK;
  constexpr int KPW = S::KPW, PC = S::PC, TILEB = S::TILEB;

  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + S::RING);  // RB x D, scaled
  int* sQp = reinterpret_cast<int*>(sQ + RB * D);
  const int tps = a.tiles_per_split;
  int* sPos = sQp + RB;                           // tps * kTK key positions
  int* sRow = sPos + tps * kTK;                   // paged: tps * kTK pool rows, -1 unmapped
  int* sLive = sRow + (kPaged ? tps * kTK : 0);   // tps: flags, then the live-tile list
  // The live-tile count and the last-block flag (in the dynamic allocation:
  // the block may use all of the opt-in maximum).
  int& s_nlive = sLive[tps];
  int& s_last = sLive[tps + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WK, wk = warp % WK;
  const int group = a.Hq / a.Hkv;
  const int unit = blockIdx.x, split = blockIdx.y;
  const int rchunk = unit % a.rchunks;
  const int hk = (unit / a.rchunks) % a.Hkv;
  const int b = unit / (a.rchunks * a.Hkv);
  const int r0 = rchunk * kMaxRows;
  const int nrows = min(kMaxRows, group * a.Sq - r0);
  const bool causal = a.causal != 0, windowed = a.has_window != 0;
  const T* qg = static_cast<const T*>(a.q);
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);

  // Row i of the block is (group member gi, query s): its (b, s, h) index.
  auto row_index = [&](int i) -> size_t {
    const int r = r0 + i, gi = r / a.Sq, s = r % a.Sq;
    return ((size_t)b * a.Sq + s) * a.Hq + hk * group + gi;
  };

  for (int e = tid; e < RB * D; e += kThreads) {
    const int i = e / D;
    sQ[e] = i < nrows ? to_f(qg[row_index(i) * D + e % D]) * a.scale : 0.f;
  }
  for (int i = tid; i < RB; i += kThreads)
    sQp[i] = i < nrows ? a.q_pos[(size_t)b * a.Sq + (r0 + i) % a.Sq] : 0;
  const int key0 = split * tps * kTK;
#pragma unroll 4
  for (int t = tid; t < tps * kTK; t += kThreads) {
    const int j = key0 + t;
    int pos = 2 * kPadHalf, row = -1;
    if (j < a.Sk) {
      if constexpr (kPaged) {
        // Liveness from the raw table entry, before touching the pool.
        const int entry = a.block_tables[(size_t)b * a.W + j / a.ps];
        if (entry >= 0 && entry < a.n_pages) {
          row = entry * a.ps + j % a.ps;
          pos = a.k_pos[row];
        }
      } else {
        pos = a.k_pos[(size_t)b * a.Sk + j];
      }
    }
    sPos[t] = pos;
    if constexpr (kPaged) sRow[t] = row;
  }
  __syncthreads();

  // Tile flags by warp reductions (lane = key), then the live-tile list.
  {
    int qlo = INT32_MAX, qhi = INT32_MIN;
    for (int i = lane; i < nrows; i += 32) {
      qlo = min(qlo, sQp[i]);
      qhi = max(qhi, sQp[i]);
    }
    qlo = __reduce_min_sync(0xffffffffu, qlo);
    qhi = __reduce_max_sync(0xffffffffu, qhi);
    for (int t = warp; t < tps; t += kWarps) {
      const int kp = sPos[t * kTK + lane];
      const int kmin = __reduce_min_sync(0xffffffffu, kp);
      const int kmax = __reduce_max_sync(0xffffffffu, kp);
      if (lane == 0) sLive[t] = tile_flag(qlo, qhi, kmin, kmax, causal, windowed, a.window);
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact the live tiles in order (tps <= 64: two ballots)
    const bool f0 = lane < tps && sLive[lane] != 0;
    const bool f1 = lane + 32 < tps && sLive[lane + 32] != 0;
    const unsigned b0 = __ballot_sync(0xffffffffu, f0), b1 = __ballot_sync(0xffffffffu, f1);
    const unsigned below = (1u << lane) - 1u;
    __syncwarp();
    if (f0) sLive[__popc(b0 & below)] = lane;
    if (f1) sLive[__popc(b0) + __popc(b1 & below)] = lane + 32;
    if (lane == 0) s_nlive = __popc(b0) + __popc(b1);
  }
  __syncthreads();
  const int nlive = s_nlive;

  // Live tile number li into stage li % kStages (an empty group past the end,
  // so the wait counts stay uniform).
  auto issue = [&](int li) {
    if (li < nlive) {
      constexpr int CH = S::ROWB / 16;      // 16-byte chunks of one key row
      constexpr int KSTEP = kThreads / CH;  // key rows one round of the block covers
      static_assert(kThreads % CH == 0 && kTK % KSTEP == 0, "copy rounds");
      const int t = sLive[li];
      unsigned char* st = smem + (li % kStages) * 2 * TILEB + (tid % CH) * 16;
      const size_t col = (size_t)hk * D + (tid % CH) * (16 / sizeof(T));
#pragma unroll
      for (int key = tid / CH; key < kTK; key += KSTEP) {
        const int kl = t * kTK + key;
        size_t src_row = 0;
        bool ok;
        if constexpr (kPaged) {
          const int row = sRow[kl];
          ok = row >= 0;
          if (ok) src_row = row;
        } else {
          const int j = key0 + kl;
          ok = j < a.Sk;
          if (ok) src_row = (size_t)b * a.Sk + j;
        }
        const size_t off = src_row * a.Hkv * D + col;
        cp_async16(st + key * S::ROWB, kg + off, ok);          // K row
        cp_async16(st + TILEB + key * S::ROWB, vg + off, ok);  // V row
      }
    }
    cp_async_commit();
  };

  // Online-softmax state of this lane's key group (lane / LPK) for the
  // warp's rows: the LPK lanes of a group hold the same m and l and each its
  // VEC columns of acc.  The rows' q slices and positions sit in registers.
  // exp(x) is taken as exp2(x * log2 e) of the small difference x, so lse
  // keeps the precision of the natural-unit scores.
  const int g = lane / LPK, cpart = lane % LPK;
  float acc[RW][VEC], m[RW], l[RW], qv[RW][VEC];
  int qpr[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpr[i] = sQp[wr * RW + i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      acc[i][e] = 0.f;
      qv[i][e] = sQ[(wr * RW + i) * D + cpart * VEC + e];
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int li = 0; li < nlive; ++li) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile li has landed; every warp is done with tile li - 1
    issue(li + kStages - 1);
    const unsigned char* st = smem + (li % kStages) * 2 * TILEB;
    const T* sK = reinterpret_cast<const T*>(st) + wk * TKW * D + cpart * VEC;
    const T* sV = reinterpret_cast<const T*>(st + TILEB) + wk * TKW * D + cpart * VEC;
    const int* kp = sPos + sLive[li] * kTK + wk * TKW;

    // The warp's TKW keys in chunks of PC passes; a pass gives each key
    // group one key (kl = pass * KPW + g).  Rows past the block's are
    // skipped by warp-uniform branches.
#pragma unroll
    for (int p0 = 0; p0 < S::PASSES; p0 += PC) {
      float sc[RW][PC];
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        const int kl = (p0 + p) * KPW + g;
        float kf[VEC];
        load_f<T, VEC>(sK + kl * D, kf);
        const int kpos = kp[kl];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          sc[i][p] = kNegInf;
          if (wr * RW + i < nrows) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) d = fmaf(qv[i][e], kf[e], d);
#pragma unroll
            for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
            if (visible(qpr[i], kpos, causal, windowed, a.window)) sc[i][p] = d;
          }
        }
      }
      // Rescale by the chunk's new max (the Pallas safe_m / alpha guards).
      float safe[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        safe[i] = 0.f;
        if (wr * RW + i < nrows) {
          float mnew = m[i];
#pragma unroll
          for (int p = 0; p < PC; ++p) mnew = fmaxf(mnew, sc[i][p]);
          safe[i] = mnew <= kNegInf / 2 ? 0.f : mnew;
          const float alpha =
              m[i] <= kNegInf / 2 ? 0.f : exp2f(fminf(m[i] - safe[i], 0.f) * kLog2e);
          m[i] = mnew;
          l[i] *= alpha;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
        }
      }
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        float vf[VEC];
        load_f<T, VEC>(sV + ((p0 + p) * KPW + g) * D, vf);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (wr * RW + i < nrows) {
            const float pr =
                sc[i][p] > kNegInf / 2 ? exp2f((sc[i][p] - safe[i]) * kLog2e) : 0.f;
            l[i] += pr;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(pr, vf[e], acc[i][e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Merge the warp's KPW key groups (xor butterfly: both partners compute
  // the same sums, so every lane ends with the same state).
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (wr * RW + i >= nrows) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float M = fmaxf(m[i], mo);
      const float safe = M <= kNegInf / 2 ? 0.f : M;
      const float wa = m[i] <= kNegInf / 2 ? 0.f : exp2f((m[i] - safe) * kLog2e);
      const float wb = mo <= kNegInf / 2 ? 0.f : exp2f((mo - safe) * kLog2e);
      l[i] = wa * l[i] + wb * lo;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i][e] = wa * acc[i][e] + wb * __shfl_xor_sync(0xffffffffu, acc[i][e], o);
      m[i] = M;
    }
  }
  __syncthreads();  // the ring is free: it holds the WK partials of each row

  float* mAcc = reinterpret_cast<float*>(smem);  // WK x RB x D
  float* mM = mAcc + WK * RB * D;                // WK x RB
  float* mL = mM + WK * RB;
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = wr * RW + i;
      if (row < nrows) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) mAcc[(wk * RB + row) * D + cpart * VEC + e] = acc[i][e];
        if (lane == 0) {
          mM[wk * RB + row] = m[i];
          mL[wk * RB + row] = l[i];
        }
      }
    }
  }
  __syncthreads();

  const size_t NR = (size_t)a.B * a.Sq * a.Hq;
  const bool single = a.splits == 1;
  T* out = static_cast<T*>(a.out);
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int row = e / D, col = e % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, mM[w * RB + row]);
    const float safe = M <= kNegInf / 2 ? 0.f : M;
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float mw = mM[w * RB + row];
      const float aw = mw <= kNegInf / 2 ? 0.f : exp2f((mw - safe) * kLog2e);
      L += aw * mL[w * RB + row];
      O += aw * mAcc[(w * RB + row) * D + col];
    }
    const bool valid = L > 0.f;
    const float o = valid ? O / L : 0.f;
    const float ls = valid ? M + logf(L) : -INFINITY;
    const size_t ri = row_index(row);
    if (single) {
      out[ri * D + col] = from_f<T>(o);
      if (col == 0) a.lse[ri] = ls;
    } else {
      a.part_out[((size_t)split * NR + ri) * D + col] = o;
      if (col == 0) a.part_lse[split * NR + ri] = ls;
    }
  }
  if (single) return;

  // The last block of this unit to finish merges every split, in split
  // order (the Update() merge as a running sum): with max the largest lse,
  // w_s = exp(lse_s - max), out = sum w_s out_s / sum w_s, lse = max +
  // log(sum w_s); rows empty in every split give (0, -inf).
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + unit, 1) == a.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int row = e / D, col = e % D;
    const size_t ri = row_index(row);
    // Online over the splits in order, eight loads in flight at a time.
    float mx = -INFINITY, num = 0.f, den = 0.f;
    for (int s0 = 0; s0 < a.splits; s0 += 8) {
      float ls[8], os[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + u;
        ls[u] = s < a.splits ? __ldcg(a.part_lse + s * NR + ri) : -INFINITY;
        os[u] = s < a.splits ? __ldcg(a.part_out + (s * NR + ri) * D + col) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (ls[u] == -INFINITY) continue;
        const float M = fmaxf(mx, ls[u]);
        const float r = expf(mx - M);  // 0 while mx is -inf
        const float w = expf(ls[u] - M);
        num = fmaf(w, os[u], num * r);
        den = fmaf(den, r, w);
        mx = M;
      }
    }
    const bool valid = den > 0.f;
    out[ri * D + col] = from_f<T>(valid ? num / den : 0.f);
    if (col == 0) a.lse[ri] = valid ? mx + logf(den) : -INFINITY;
  }
  if (tid == 0) a.counters[unit] = 0;  // at rest again for the next call
}

template <typename T, int D, int WR, int RW, bool kPaged>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Shape<T, D, WR, RW, kPaged>::smem_bytes(a.tiles_per_split);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kern = decode_kernel<T, D, WR, RW, kPaged>;
  // The shared-memory opt-in is set once per template instance (per process).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(a.B * a.Hkv * a.rchunks, a.splits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The block's rows pick the warp layout: up to 2 or 4 rows on one row group
// (all four warps along the keys), 8 on two, 16 on four; more rows (group x
// Sq up to 64 a chunk, dense or paged) hold 8 or 16 rows a warp.
template <typename T, int D, bool kPaged>
cudaError_t pick_rows(const Args& a, cudaStream_t stream) {
  const int all_rows = a.Hq / a.Hkv * a.Sq;
  const int rows = all_rows < kMaxRows ? all_rows : kMaxRows;
  if (rows <= 2) return launch<T, D, 1, 2, kPaged>(a, stream);
  if (rows <= 4) return launch<T, D, 1, 4, kPaged>(a, stream);
  if (rows <= 8) return launch<T, D, 2, 4, kPaged>(a, stream);
  if (rows <= 16) return launch<T, D, 4, 4, kPaged>(a, stream);
  if (rows <= 32) return launch<T, D, 4, 8, kPaged>(a, stream);
  return launch<T, D, 4, 16, kPaged>(a, stream);
}

// Checks the split the caller chose (`tiles_per_split`, from
// `decode_split_rule` in kernels/flash_attention.py), sets the split count
// ceil(tiles / tiles_per_split) and the row chunks, and launches.
template <bool kPaged>
cudaError_t run(Args a, int D, int bf16, cudaStream_t stream) {
  if (a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.Sq < 1 || a.Sq > 4 || a.Sk < 0)
    return cudaErrorInvalidValue;
  if (a.tiles_per_split < 1 || a.tiles_per_split > kMaxSplitTiles) return cudaErrorInvalidValue;
  const int n_tiles = a.Sk > 0 ? (a.Sk + kTK - 1) / kTK : 1;
  a.splits = (n_tiles + a.tiles_per_split - 1) / a.tiles_per_split;
  if (a.splits > 1 && (a.part_out == nullptr || a.part_lse == nullptr || a.counters == nullptr))
    return cudaErrorInvalidValue;
  a.rchunks = (a.Hq / a.Hkv * a.Sq + kMaxRows - 1) / kMaxRows;
  switch (D) {
    case 32:
      return bf16 ? pick_rows<__nv_bfloat16, 32, kPaged>(a, stream)
                  : pick_rows<float, 32, kPaged>(a, stream);
    case 64:
      return bf16 ? pick_rows<__nv_bfloat16, 64, kPaged>(a, stream)
                  : pick_rows<float, 64, kPaged>(a, stream);
    case 128:
      return bf16 ? pick_rows<__nv_bfloat16, 128, kPaged>(a, stream)
                  : pick_rows<float, 128, kPaged>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dec
}  // namespace rt
