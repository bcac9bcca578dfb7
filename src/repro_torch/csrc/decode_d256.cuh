// The decode core's bf16 head-dim-256 instance (kernel A's decode calls and
// kernel C at D 256, bf16): recurrentgemma-2b's local attention, one KV head
// and a GQA group of 10 at Sq 1, over a 2048-slot ring buffer.
//
// The call reads about 10 flops a byte, far below the ~295 at which the
// tensor cores would bind, so its bound is the bytes of the live keys over
// the memory rate.  The design:
//
// * One wave, long splits, merged in a thread-block cluster.  Each unit
//   (batch row x KV head, 1 to 16 query rows: the GQA group x Sq) is one
//   cluster of G blocks, and block r of it streams tiles [r*tpb, (r+1)*tpb)
//   of the unit's 32-key tiles.  `decode_rule_d256` in
//   kernels/flash_attention.py picks tpb and G for about one block an SM,
//   G at most kMaxCluster (at B 8: G 8, 64 blocks, 8 tiles each).  An H100
//   holds only 7 clusters of 16 such blocks at once (a cluster's blocks
//   share one GPC), so G 16 would put B 8's eighth unit in a second wave;
//   it holds 15 of 8.  The blocks of a cluster then
//   merge their normalised (out, lse) partials through distributed shared
//   memory, in block order, with the lse-weighted Update(): no global
//   partials, no atomics, no second pass, and the result is bitwise
//   repeatable.
// * TMA tile loads into a ring sized for bytes in flight: kStages stages of
//   one K and one V tile (32 KB a stage, 128 KB in flight an SM, far above
//   the ~40 KB that 3.35 TB/s over 132 SMs needs at a microsecond's
//   latency), fed by one producer warp.  The producer
//   reads the key positions of each tile (paged: through the raw
//   block-table entry) in batches, decides the tile's liveness with
//   `tile_flag` before any load, and hands each live tile's positions and
//   flag to the consumers in the stage.  Dense keys past Sk are zero-filled
//   by the tensor map's bounds; paged, one box covers the keys of one page
//   (or a power-of-two part of it), an unmapped entry issues no load and
//   its keys' rows are zeroed in shared memory, so no stale bytes meet a
//   zero probability.
// * Scores and P V on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   float32 accumulate): the block's at most 16 rows are one m16 tile.  Q
//   is loaded once, with 16-byte loads, and held as A fragments.  Each of
//   the four consumer warps forms the same S over the whole D (the same
//   products in the same order, so m, l and P agree bitwise across warps)
//   and accumulates 64 of O's 256 columns.  The scale is applied to S in
//   float32; P is rounded to bf16 for the P V product, as kernel A's wgmma
//   instance rounds it, and l sums the unrounded P.
// * Masks as the split core: a dead tile is skipped before its load, a
//   partly visible one is masked key by key from each row's position; a
//   row that sees no key gives exactly (0, -inf), also across the merge.
#pragma once

#include "decode.cuh"
#include "hopper.cuh"

namespace rt {
namespace dcl {

constexpr int kD = 256;
constexpr int kTK = dec::kTK;            // keys a tile
constexpr int kRows = 16;                // query rows a block: one m16 tile
constexpr int kStages = 4;               // ring depth
constexpr int kConsumers = 4;            // warps, each 64 of O's columns
constexpr int kBlockThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kCols = kD / kConsumers;
constexpr int kBatch = 8;                // tiles whose positions the producer reads at once
constexpr int kMaxCluster = 8;           // mirrored by DECODE_D256_MAX_CLUSTER
constexpr int kPartStride = kD + 8;      // floats a row of the merge buffer
using dec::kLog2e;

using KT = Tile<kD, kTK>;    // a K (or V) tile: 4 swizzled regions of 32 rows
using QT = Tile<kD, kRows>;  // Q: 4 swizzled regions of 16 rows

// Shared memory, from a 1024-byte aligned base: the ring (stage s: K, then
// V), Q, each stage's key positions and tile flag (-1: no more tiles), the
// full and empty mbarriers.  After the loop the ring holds the block's
// partial for the cluster merge: kRows rows of out / l, then kRows lse.
struct Smem {
  static constexpr int kStage = 2 * KT::kBytes;
  static constexpr int kQ = kStages * kStage;
  static constexpr int kPos = kQ + QT::kBytes;
  static constexpr int kFlag = kPos + kStages * kTK * 4;
  static constexpr int kBars = kFlag + kStages * 4;
  static constexpr int kBytes = kBars + 16 * kStages;
  static constexpr int kPartLse = kRows * kPartStride * 4;
  static constexpr size_t bytes() { return 1024 + kBytes; }
};
static_assert(Smem::kBars % 8 == 0 && Smem::kPartLse + kRows * 4 <= Smem::kQ, "layout");

// Byte offset of 16-byte chunk c (of D/8) of row r in a tile of swizzled
// 128-byte rows whose 64-column regions are `region` bytes apart.
__device__ __forceinline__ uint32_t swz(int region, int r, int c) {
  return (c >> 3) * region + r * kRowBytes + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys a paged TMA box covers: the largest power of two <= 32 that
// divides the page size, so that a box never crosses a page (dense: a tile).
__host__ __device__ __forceinline__ int box_rows(int ps) {
  const int low = ps & -ps;
  return low < kTK ? low : kTK;
}

template <bool kPaged>
__global__ void __launch_bounds__(kBlockThreads, 1)
    decode_d256_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const dec::Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + Smem::kBars, empty0 = full0 + 8 * kStages;
  int* s_pos = reinterpret_cast<int*>(smem + Smem::kPos);
  int* s_flag = reinterpret_cast<int*>(smem + Smem::kFlag);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.splits;  // blocks of the cluster
  const int rank = static_cast<int>(cluster_ctarank());
  const int unit = blockIdx.x / G;
  const int hk = unit % a.Hkv, b = unit / a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int nrows = group * a.Sq;  // 1 to kRows
  const int n_tiles = a.Sk > 0 ? (a.Sk + kTK - 1) / kTK : 1;
  const int t0 = rank * a.tiles_per_split, t1 = min(n_tiles, t0 + a.tiles_per_split);
  const bool causal = a.causal != 0, windowed = a.has_window != 0;

  // Row i of the block is (group member i / Sq, query i % Sq).
  auto row_index = [&](int i) -> size_t {
    return ((size_t)b * a.Sq + i % a.Sq) * a.Hq + hk * group + i / a.Sq;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the producer's arrive (+ the TMA bytes)
      mbar_init(empty0 + 8 * s, kConsumers);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  float o[kCols / 2];  // 8 n8 column tiles x (rows g, g + 8) x 2 columns
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
  const int g = lane >> 2, c4 = lane & 3;

  if (warp == kConsumers) {
    // ---- producer warp: positions, liveness, TMA loads ----------------
    int qlo = INT32_MAX, qhi = INT32_MIN;
    if (lane < nrows) qlo = qhi = a.q_pos[(size_t)b * a.Sq + lane % a.Sq];
    qlo = __reduce_min_sync(0xffffffffu, qlo);
    qhi = __reduce_max_sync(0xffffffffu, qhi);
    int it = 0;  // live tiles handed over so far
    for (int tb = t0; tb < t1; tb += kBatch) {
      // Lane = key: each tile's key positions and (paged) pool rows, -1
      // behind an unmapped entry or past the range, read for the batch.
      int pos[kBatch], prow[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = (tb + u) * kTK + lane;
        pos[u] = 2 * kPadHalf;
        prow[u] = -1;
        if (tb + u < t1 && j < a.Sk) {
          if constexpr (kPaged) {
            const int entry = a.block_tables[(size_t)b * a.W + j / a.ps];
            if (entry >= 0 && entry < a.n_pages) prow[u] = entry * a.ps + j % a.ps;
          } else {
            pos[u] = a.k_pos[(size_t)b * a.Sk + j];
          }
        }
      }
      if constexpr (kPaged) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (prow[u] >= 0) pos[u] = a.k_pos[prow[u]];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (tb + u >= t1) break;
        const int kmin = __reduce_min_sync(0xffffffffu, pos[u]);
        const int kmax = __reduce_max_sync(0xffffffffu, pos[u]);
        const int flag = tile_flag(qlo, qhi, kmin, kmax, causal, windowed, a.window);
        if (flag == 0) continue;
        const int stage = it % kStages;
        if (it >= kStages) mbar_wait(empty0 + 8 * stage, ((it / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t kdst = sbase + stage * Smem::kStage, vdst = kdst + KT::kBytes;
        s_pos[stage * kTK + lane] = pos[u];
        if (lane == 0) s_flag[stage] = flag;
        uint32_t bytes = 2 * KT::kBytes;
        if constexpr (kPaged) {
          // An unmapped key's K and V rows are zeroed here and never loaded.
          const unsigned mapped = __ballot_sync(0xffffffffu, prow[u] >= 0);
          if (prow[u] < 0) {
            const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int r = 0; r < kD / 64; ++r) {
#pragma unroll
              for (int c = 0; c < kRowBytes / 16; ++c) {
                const int off = stage * Smem::kStage + r * KT::kRegion + lane * kRowBytes + 16 * c;
                *reinterpret_cast<uint4*>(smem + off) = zero;
                *reinterpret_cast<uint4*>(smem + off + KT::kBytes) = zero;
              }
            }
            fence_proxy_async_smem();
          }
          bytes = __popc(mapped) * 2 * kD * 2;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive_expect_tx(full, bytes);
        if constexpr (kPaged) {
          const int R = box_rows(a.ps);
          for (int i = 0; i < kTK / R; ++i) {
            const int pr = __shfl_sync(0xffffffffu, prow[u], i * R);
            if (lane == 0 && pr >= 0) {
              const uint32_t off = i * R * kRowBytes;
#pragma unroll
              for (int r = 0; r < kD / 64; ++r) {
                tma_load_4d(kdst + r * KT::kRegion + off, &tm_k, full, 64 * r, hk, pr % a.ps,
                            pr / a.ps);
                tma_load_4d(vdst + r * KT::kRegion + off, &tm_v, full, 64 * r, hk, pr % a.ps,
                            pr / a.ps);
              }
            }
          }
        } else if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kD / 64; ++r) {
            tma_load_4d(kdst + r * KT::kRegion, &tm_k, full, 64 * r, hk, (tb + u) * kTK, b);
            tma_load_4d(vdst + r * KT::kRegion, &tm_v, full, 64 * r, hk, (tb + u) * kTK, b);
          }
        }
        ++it;
      }
    }
    // No more tiles: the consumers stop at this stage.
    const int stage = it % kStages;
    if (it >= kStages) mbar_wait(empty0 + 8 * stage, ((it / kStages) - 1) & 1);
    if (lane == 0) {
      s_flag[stage] = -1;
      mbar_arrive(full0 + 8 * stage);
    }
  } else {
    // ---- four consumer warps: S over the whole D, 64 of O's columns each
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q);
    for (int e = tid; e < kRows * (kD / 8); e += 32 * kConsumers) {
      const int i = e / (kD / 8), c = e % (kD / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < nrows) v = *reinterpret_cast<const uint4*>(qg + row_index(i) * kD + 8 * c);
      *reinterpret_cast<uint4*>(smem + Smem::kQ + swz(QT::kRegion, i, c)) = v;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
    // Q as A fragments of the 16 k-steps of D: matrices (rows 0-7 | 8-15) x
    // (columns 16kk..+7 | +8..+15).
    uint32_t qa[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldmatrix_x4(qa[kk], sbase + Smem::kQ +
                              swz(QT::kRegion, (lane & 7) + 8 * ((lane >> 3) & 1),
                                  2 * kk + (lane >> 4)));
    // This lane's rows g and g + 8; rows past the block's are zero queries,
    // computed and never written.
    int qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = g + 8 * r;
      qp[r] = i < nrows ? a.q_pos[(size_t)b * a.Sq + i % a.Sq] : 0;
    }
    const int col0 = warp * kCols;

    for (int it = 0;; ++it) {
      const int stage = it % kStages;
      mbar_wait(full0 + 8 * stage, (it / kStages) & 1);
      const int flag = s_flag[stage];
      if (flag < 0) break;
      const uint32_t kb = sbase + stage * Smem::kStage, vb = kb + KT::kBytes;

      // S (16 x 32) = Q K^T: n8 tile n holds keys 8n..8n+7; one
      // ldmatrix.x4 gives the B fragments of two n8 tiles (keys 16h..+7 |
      // +8..+15) x (columns 16kk..+7 | +8..+15).
      float sc[4 * 4];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kb + swz(KT::kRegion, 16 * h + (lane & 7) + 8 * (lane >> 4),
                                   2 * kk + ((lane >> 3) & 1)));
          mma_bf16_16816(sc + 8 * h, qa[kk], kf[0], kf[1]);
          mma_bf16_16816(sc + 8 * h + 4, qa[kk], kf[2], kf[3]);
        }
      }
      // Scale in float32, then the per-key mask (sc[4n + 2r + e]: row g + 8r,
      // key 8n + 2*c4 + e).
      const int* kp = s_pos + stage * kTK;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int2 kpp = *reinterpret_cast<const int2*>(kp + 8 * n + 2 * c4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& s0 = sc[4 * n + 2 * r];
          float& s1 = sc[4 * n + 2 * r + 1];
          if (flag == 1) {
            s0 *= a.scale;
            s1 *= a.scale;
          } else {
            s0 = visible(qp[r], kpp.x, causal, windowed, a.window) ? s0 * a.scale : kNegInf;
            s1 = visible(qp[r], kpp.y, causal, windowed, a.window) ? s1 * a.scale : kNegInf;
          }
        }
      }
      // The online softmax (the Pallas safe_m and alpha guards), per row.
      float alpha[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        const float mnew = fmaxf(m[r], quad_max(mx));
        const float safe = mnew <= kNegInf / 2 ? 0.f : mnew;
        alpha[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f(fminf(m[r] - safe, 0.f) * kLog2e);
        m[r] = mnew;
        neg[r] = -safe * kLog2e;
      }
      // A masked score is kNegInf, so its exp2 underflows to exactly 0.
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[i] = exp2f(fmaf(sc[i], kLog2e, neg[(i >> 1) & 1]));
        psum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + psum[r];  // quad-summed at the end
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P in bf16: the S fragments of n8 tiles 2kk and 2kk + 1 are the A
      // fragment of k-step kk.
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      // O += P V over this warp's 64 columns: one ldmatrix.x4.trans gives the
      // B fragments of two n8 column tiles from (keys 16kk..+7 | +8..+15) x
      // (columns col0 + 16j..+7 | +8..+15).
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int j = 0; j < kCols / 16; ++j) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vb + swz(KT::kRegion, 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                         (col0 + 16 * j) / 8 + (lane >> 4)));
          mma_bf16_16816(o + 8 * j, pa[kk], vf[0], vf[1]);
          mma_bf16_16816(o + 8 * j + 4, pa[kk], vf[2], vf[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }
  }
  __syncthreads();  // the ring is free: it takes this block's partial

  float* part = reinterpret_cast<float*>(smem);
  float* part_lse = reinterpret_cast<float*>(smem + Smem::kPartLse);
  if (warp < kConsumers) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      const bool valid = lr > 0.f;
      const float inv = valid ? 1.f / lr : 0.f;
      const int row = g + 8 * r;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
        *reinterpret_cast<float2*>(part + row * kPartStride + warp * kCols + 8 * n + 2 * c4) =
            make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      if (warp == 0 && c4 == 0) part_lse[row] = valid ? m[r] + logf(lr) : -INFINITY;
    }
  }
  cluster_sync();

  // The merge: block `rank` takes its share of the unit's (row, column
  // pair) elements and walks the G partials in block order (the Update()
  // merge as a running sum: out = sum w_s out_s / sum w_s, w_s = exp(lse_s
  // - max), lse = max + log(sum w_s); rows empty everywhere stay (0, -inf)).
  {
    const int E = nrows * (kD / 2), per = (E + G - 1) / G;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
    for (int e = rank * per + tid; e < min(E, (rank + 1) * per); e += kBlockThreads) {
      const int row = e / (kD / 2), col = 2 * (e % (kD / 2));
      float ls[kMaxCluster];
      float2 os[kMaxCluster];
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        if (s < G) {
          const uint32_t peer = cluster_map(sbase, s);
          ls[s] = ld_cluster_f32(peer + Smem::kPartLse + 4 * row);
          os[s] = ld_cluster_f32x2(peer + 4 * (row * kPartStride + col));
        }
      }
      float mx = -INFINITY, num0 = 0.f, num1 = 0.f, den = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        if (s >= G || ls[s] == -INFINITY) continue;
        const float M = fmaxf(mx, ls[s]);
        const float rs = expf(mx - M);  // 0 while mx is -inf
        const float w = expf(ls[s] - M);
        num0 = fmaf(w, os[s].x, num0 * rs);
        num1 = fmaf(w, os[s].y, num1 * rs);
        den = fmaf(den, rs, w);
        mx = M;
      }
      const bool valid = den > 0.f;
      const size_t ri = row_index(row);
      *reinterpret_cast<uint32_t*>(out + ri * kD + col) =
          pack_bf16x2(valid ? num0 / den : 0.f, valid ? num1 / den : 0.f);
      if (col == 0) a.lse[ri] = valid ? mx + logf(den) : -INFINITY;
    }
  }
  cluster_sync();  // no block leaves while another still reads its partial
}

// The launch attributes (set once per instance and process): the opt-in
// shared memory, and clusters beyond the portable 8 blocks, so that
// `max_active_clusters` can report on 16.
template <bool kPaged>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    auto kern = decode_d256_kernel<kPaged>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem::bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

// Clusters of `cluster` blocks that the card holds at once, at the block's
// shared memory (cudaOccupancyMaxActiveClusters); 0 if none fits.
template <bool kPaged>
cudaError_t max_active_clusters(int cluster, int* n) {
  cudaError_t e = prepare<kPaged>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = Smem::bytes();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, decode_d256_kernel<kPaged>, &cfg);
}

}  // namespace dcl

namespace dec {

// One cluster of `a.splits` blocks per (batch row, KV head); the caller
// (`run`) has set splits = ceil(tiles / tiles_per_split).
template <bool kPaged>
cudaError_t launch_d256(const Args& a, cudaStream_t stream) {
  using namespace dcl;
  const int rows = a.Hq / a.Hkv * a.Sq;
  if (rows > kRows || a.splits > kMaxCluster) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) & 15)
    return cudaErrorMisalignedAddress;
  CUtensorMap tk, tv;
  cudaError_t err;
  if constexpr (kPaged) {
    const int R = box_rows(a.ps);
    if ((err = make_bf16_map(&tk, a.k, kD, a.Hkv, a.ps, a.n_pages, R)) != cudaSuccess) return err;
    if ((err = make_bf16_map(&tv, a.v, kD, a.Hkv, a.ps, a.n_pages, R)) != cudaSuccess) return err;
  } else {
    // With no keys no tile is loaded, but a map needs a nonzero extent and
    // an address: it is built over q and never read.
    const void* kk = a.Sk ? a.k : a.q;
    const void* vv = a.Sk ? a.v : a.q;
    const int S = a.Sk ? a.Sk : 1;
    if ((err = make_bf16_map(&tk, kk, kD, a.Hkv, S, a.B, kTK)) != cudaSuccess) return err;
    if ((err = make_bf16_map(&tv, vv, kD, a.Hkv, S, a.B, kTK)) != cudaSuccess) return err;
  }
  if ((err = prepare<kPaged>()) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv * a.splits);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = Smem::bytes();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, decode_d256_kernel<kPaged>, tk, tv, a)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace dec
}  // namespace rt
