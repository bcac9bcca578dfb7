// Kernel C: fused paged-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_fwd_pallas` (body
// `_paged_decode_kernel`, predicates `page_index_clamp`, `page_skip`,
// `page_mask`) of src/repro/kernels/paged_attention.py.  One decode token
// per request attends to that request's KV pages through its block table;
// no gathered dense view of the cache ever exists:
//   q (B,1,Hq,D); k/v pools (n_pages,ps,Hkv,D) in float32 or bfloat16;
//   pos_pool (n_pages,ps) int32 (PAD_POS in unwritten slots);
//   block_tables (B,W) int32 (entries outside [0, n_pages) are unmapped);
//   q_pos (B,1) int32 -> out (B,1,Hq,D) in q's type, lse (B,1,Hq) float32.
// Rows whose every page is dead give out = 0, lse = -inf (the merge
// identity), so the result merges with Update() like any partial.
//
// What bounds it: the bytes of the mapped pages,
// pages_used * ps * Hkv * D * 2 (K and V) * elem bytes, over the memory
// rate.  The kernel is the paged instance of the split-KV decode core in
// decode.cuh (shared with kernel A's decode instance): one block per (KV
// head, batch row, chunk of up to 64 rows of the GQA group, split of the
// request's logical key range), so any group size runs; the split's
// block-table entries and key positions are
// read once at block start, 32-key tiles (several pages, or part of one)
// stream through a 3-stage cp.async ring, scores and P V run in registers,
// and the last block of each (KV head, batch row) merges the splits in
// split order.  One launch, of the device kernel
// `rt::dec::decode_kernel<T, D, WR, RW, true>`.
//
// bf16 calls at head dim 256 run on the paged cluster instance of
// decode_d256.cuh (`rt::dcl::decode_d256_kernel<true>`): one TMA box a page
// (or a power-of-two part of it) through the raw table entry, mma.sync
// products, the splits merged in a thread-block cluster; float32 D 256 on
// the split kernel's 16-row layout.
//
// The safety rule of the TPU kernel stays: an unmapped entry is recognised
// from the raw table value and no memory behind it is read (its keys are
// zero-filled and count as padding), so no clamped, aliased page is ever
// touched.  A tile whose every key is padding, causally after the query or
// out of its window is skipped whole (the Pallas `page_skip`); the rest is
// masked per key (`page_mask`).  The TPU's lane-replicated (group, 128) m/l
// scratch is a layout artifact and is dropped.
#include "common.cuh"
#include "decode.cuh"

// C entry: returns the cudaError_t of the launch (0 on success).  The
// logical key range W * ps is cut into splits of `tiles_per_split` 32-key
// tiles; with more than one split the caller allocates the float32 scratch
// `part_out` (splits, B*Hq, D) and `part_lse` (splits, B*Hq), and the int32
// `counters` (B*Hkv), zero at rest and left zero (none on the cluster
// instance).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* pos_pool, const void* block_tables, const void* q_pos,
                            void* out, void* lse, void* part_out, void* part_lse,
                            void* counters, int B, int n_pages, int ps, int Hq, int Hkv, int W,
                            int D, int bf16, int has_window, int window, float scale,
                            int tiles_per_split, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || ps < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  rt::dec::Args a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(pos_pool);
  a.block_tables = static_cast<const int*>(block_tables);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.part_out = static_cast<float*>(part_out);
  a.part_lse = static_cast<float*>(part_lse);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.Sq = 1;
  a.Sk = W * ps;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.n_pages = n_pages;
  a.ps = ps;
  a.W = W;
  a.causal = 1;
  a.has_window = has_window;
  a.window = window;
  a.scale = scale;
  a.tiles_per_split = tiles_per_split;
  return (int)rt::dec::run<true>(a, D, bf16, static_cast<cudaStream_t>(stream));
}
