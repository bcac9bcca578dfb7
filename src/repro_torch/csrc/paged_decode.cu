// Kernel C: fused paged-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_fwd_pallas` (body
// `_paged_decode_kernel`) of src/repro/kernels/paged_attention.py.  One
// decode token per request attends to that request's KV pages through its
// block table; no gathered dense view of the cache ever exists:
//   q (B,1,Hq,D); k/v pools (n_pages,ps,Hkv,D) in float32 or bfloat16;
//   pos_pool (n_pages,ps) int32 (PAD_POS in unwritten slots);
//   block_tables (B,W) int32 (entries >= n_pages are unmapped);
//   q_pos (B,1) int32 -> out (B,1,Hq,D) in q's type, lse (B,1,Hq) float32.
// Rows whose every page is dead give out = 0, lse = -inf (the merge
// identity), so the result merges with Update() like any partial.
//
// What bounds it: the bytes of the mapped pages,
// pages_used * ps * Hkv * D * 2 (K and V) * elem bytes, over the memory
// rate.  One request's pages per KV head are too few for one block to read
// at that rate, so the design spreads them:
//   * split: the block-table row is cut into splits of `entries_per_split`
//     entries (the caller picks it: 128 keys' worth of pages); one block of
//     128 threads per (KV head, batch row, split) computes a partial
//     (out, lse) of its pages in `paged_decode_split_kernel` (flash-decoding),
//     and a second kernel, `paged_decode_merge_kernel`, merges the splits with
//     the lse-weighted Update() merge.  One C call launches both;
//   * tiles: a block consumes up to 64 keys (several pages) per step, loaded
//     with 16-byte vector loads;
//   * the whole GQA query group of a KV head is scored against each tile at
//     once, so K/V are read once per group, never per query head.
// An unmapped entry is recognised from the raw table value and no memory
// behind it is read: there is no prefetch on the card, so no clamped
// (aliased) page is ever touched, and its slots count as padding.  A tile
// whose every slot is padding, causally after the query or out of its
// window is skipped whole (the Pallas `page_skip`).  The TPU's lane-
// replicated (group, 128) m/l scratch is a layout artifact and is dropped.
#include "common.cuh"

namespace rt {

constexpr int kMaxGroup = 16;   // query heads per KV head held in registers
constexpr int kTileKeys = 64;   // keys per step when pages are small
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline int tile_pages(int ps) { return ps >= kTileKeys ? 1 : kTileKeys / ps; }

template <int D>
size_t paged_smem_bytes(int group, int tk) {
  return sizeof(float) * (group * D + tk * (D + 1) + tk * D + group * tk + 3 * group) +
         sizeof(int) * 2 * tk;
}

template <typename T>
struct Vec;  // 16-byte vector of T
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& v, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// Pass 1: one partial per (KV head, batch row, split of the table row).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool, const int* __restrict__ pos_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ q_pos, float* __restrict__ part_out,
                              float* __restrict__ part_lse, int B, int n_pages, int ps, int Hq,
                              int Hkv, int W, int entries_per_split, int has_window,
                              int window, float scale) {
  constexpr int ACC = kMaxGroup * D / kThreads;  // accumulator slots per thread
  constexpr int KS = D + 1;
  using V = Vec<T>;
  constexpr int VPR = D / V::n;  // vectors per key row
  const int group = Hq / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool windowed = has_window != 0;
  const int ppt = tile_pages(ps);
  const int tk = ppt * ps;  // keys per tile step

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + group * D;
  float* sV = sK + tk * KS;
  float* sP = sV + tk * D;
  float* sM = sP + group * tk;
  float* sL = sM + group;
  float* sA = sL + group;
  int* sKp = reinterpret_cast<int*>(sA + group);  // tk positions (PAD if unmapped)
  int* sPage = sKp + tk;                          // tk physical rows, -1 if unmapped

  const int qp = q_pos[b];
  for (int i = tid; i < group * D; i += kThreads)
    sQ[i] = to_f(q[((size_t)b * Hq + hk * group + i / D) * D + i % D]) * scale;
  for (int g = tid; g < group; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int w_begin = split * entries_per_split;
  const int w_end = min(W, w_begin + entries_per_split);
  for (int w0 = w_begin; w0 < w_end; w0 += ppt) {
    __syncthreads();  // previous step's shared reads are done
    for (int t = tid; t < tk; t += kThreads) {
      const int w = w0 + t / ps;
      int row = -1, kp = 2 * kPadHalf;
      if (w < w_end) {
        // Liveness from the raw table entry, before touching the pool.
        const int page = block_tables[(size_t)b * W + w];
        if (page >= 0 && page < n_pages) {
          row = page * ps + t % ps;
          kp = pos_pool[row];
        }
      }
      sPage[t] = row;
      sKp[t] = kp;
    }
    __syncthreads();
    int kmin = INT32_MAX, kmax = INT32_MIN;
    for (int t = 0; t < tk; ++t) {
      kmin = min(kmin, sKp[t]);
      kmax = max(kmax, sKp[t]);
    }
    bool skip = kmin >= kPadHalf || qp < kmin;
    if (windowed) skip = skip || kmax <= qp - window;
    if (skip) continue;
    for (int i = tid; i < tk * VPR; i += kThreads) {
      const int t = i / VPR, c = (i % VPR) * V::n;
      float kv[V::n], vv[V::n];
      const int row = sPage[t];
      if (row >= 0) {
        const size_t off = ((size_t)row * Hkv + hk) * D + c;
        V::unpack(*reinterpret_cast<const typename V::type*>(k_pool + off), kv);
        V::unpack(*reinterpret_cast<const typename V::type*>(v_pool + off), vv);
      } else {
#pragma unroll
        for (int e = 0; e < V::n; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V::n; ++e) {
        sK[t * KS + c + e] = kv[e];
        sV[t * D + c + e] = vv[e];
      }
    }
    __syncthreads();
    for (int e = tid; e < group * tk; e += kThreads) {
      const int g = e / tk, t = e % tk;
      const float* qr = sQ + g * D;
      const float* kr = sK + t * KS;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      sP[e] = visible(qp, sKp[t], true, windowed, window) ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kThreads / 32) {
      softmax_row(
          sP + g * tk, tk, [&](int t) { return visible(qp, sKp[t], true, windowed, window); },
          sM + g, sL + g, sA + g);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * kThreads, g = e / D, d = e % D;
      if (g < group) {
        float a = acc[i] * sA[g];
        const float* p = sP + g * tk;
        for (int t = 0; t < tk; ++t) a = fmaf(p[t], sV[t * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  // Partial of this split: normalized out and lse, (0, -inf) when empty.
  const size_t base = ((size_t)split * B + b) * Hq + hk * group;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * kThreads, g = e / D, d = e % D;
    if (g < group) {
      const float l = sL[g];
      part_out[(base + g) * D + d] = l > 0.f ? acc[i] / l : 0.f;
    }
  }
  for (int g = tid; g < group; g += kThreads) {
    const float l = sL[g];
    part_lse[base + g] = l > 0.f ? sM[g] + logf(l) : -INFINITY;
  }
}

// Pass 2: lse-weighted merge of the splits (the paper's Update() as a sum):
// w_s = exp(lse_s - max lse), out = sum w_s out_s / sum w_s,
// lse = max + log(sum w_s); all-empty rows give (0, -inf).
template <typename T, int D>
__global__ void __launch_bounds__(D)
    paged_decode_merge_kernel(const float* __restrict__ part_out,
                              const float* __restrict__ part_lse, T* __restrict__ out,
                              float* __restrict__ lse, int rows, int splits) {
  const int r = blockIdx.x, d = threadIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_lse[(size_t)s * rows + r]);
  float num = 0.f, den = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ls = part_lse[(size_t)s * rows + r];
      if (ls == -INFINITY) continue;
      const float w = expf(ls - m);
      num = fmaf(w, part_out[((size_t)s * rows + r) * D + d], num);
      den += w;
    }
  }
  const bool valid = den > 0.f;
  out[(size_t)r * D + d] = from_f<T>(valid ? num / den : 0.f);
  if (d == 0) lse[r] = valid ? m + logf(den) : -INFINITY;
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp, const int* pos,
                         const int* bt, const int* qpos, void* out, float* lse,
                         float* part_out, float* part_lse, int B, int n_pages, int ps, int Hq,
                         int Hkv, int W, int entries_per_split, int splits, int has_window,
                         int window, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes<D>(Hq / Hkv, tile_pages(ps) * ps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_decode_split_kernel<T, D>;
  // The shared-memory opt-in is set once per template instance (per
  // process), to the most any call may ask for; each launch passes its own.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(Hkv, B, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), pos, bt,
      qpos, part_out, part_lse, B, n_pages, ps, Hq, Hkv, W, entries_per_split, has_window,
      window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<T, D><<<B * Hq, D, 0, stream>>>(
      part_out, part_lse, static_cast<T*>(out), lse, B * Hq, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pick_dim(int D, const void* q, const void* kp, const void* vp, const int* pos,
                     const int* bt, const int* qpos, void* out, float* lse, float* po,
                     float* pl, int B, int n_pages, int ps, int Hq, int Hkv, int W, int eps,
                     int splits, int has_window, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_paged<T, 32>(q, kp, vp, pos, bt, qpos, out, lse, po, pl, B, n_pages, ps,
                                 Hq, Hkv, W, eps, splits, has_window, window, scale, stream);
    case 64:
      return launch_paged<T, 64>(q, kp, vp, pos, bt, qpos, out, lse, po, pl, B, n_pages, ps,
                                 Hq, Hkv, W, eps, splits, has_window, window, scale, stream);
    case 128:
      return launch_paged<T, 128>(q, kp, vp, pos, bt, qpos, out, lse, po, pl, B, n_pages, ps,
                                  Hq, Hkv, W, eps, splits, has_window, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rt

// C entry: returns the cudaError_t of the two launches (0 on success).
// Each split covers `eps` block-table entries; the caller picks it and
// allocates the float32 scratch `part_out` (splits,B,Hq,D) and `part_lse`
// (splits,B,Hq), splits = ceil(W / eps).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* pos_pool, const void* block_tables, const void* q_pos,
                            void* out, void* lse, void* part_out, void* part_lse, int B,
                            int n_pages, int ps, int Hq, int Hkv, int W, int D, int bf16,
                            int has_window, int window, float scale, int eps, void* stream) {
  if (Hq % Hkv != 0 || Hq / Hkv > rt::kMaxGroup || ps < 1 || W < 1 || eps < 1)
    return (int)cudaErrorInvalidValue;
  const int splits = (W + eps - 1) / eps;
  const int* pos = static_cast<const int*>(pos_pool);
  const int* bt = static_cast<const int*>(block_tables);
  const int* qp = static_cast<const int*>(q_pos);
  float* l = static_cast<float*>(lse);
  float* po = static_cast<float*>(part_out);
  float* pl = static_cast<float*>(part_lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)rt::pick_dim<__nv_bfloat16>(D, q, k_pool, v_pool, pos, bt, qp, out, l, po, pl,
                                            B, n_pages, ps, Hq, Hkv, W, eps, splits,
                                            has_window, window, scale, s);
  return (int)rt::pick_dim<float>(D, q, k_pool, v_pool, pos, bt, qp, out, l, po, pl, B,
                                  n_pages, ps, Hq, Hkv, W, eps, splits, has_window, window,
                                  scale, s);
}
