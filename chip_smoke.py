#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile | --profile=PHASE[,PHASE...]]

Phases, each fatal on failure:
  1. toolchain: torch, CUDA, nvcc and the card's name and power limit;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (sm_90a),
     failing if ptxas reports a spill or a serialised ``wgmma`` (C7512) in
     any wgmma instance of A, B1 or B2 or a spill in the decode core's
     cluster instance (bf16 D 256) or in A's, B1's and B2's CUDA-core
     instances at any head dim (the kernel lint's ptxas rules,
     ``repro_torch.analysis.kernel_lint``), whose registers, shared memory
     and admitted cluster sizes it logs; then the lint's closed forms of
     every instance's shared memory held equal, byte for byte, to the built
     library's own figures at the main paths' lengths, at the longest each
     instance admits and one tile past it, where A, B1 and B2 at D 256
     must refuse the launch;
  3. kernel A (flash forward) against its plain version on the card, in
     float32 and bf16, the zigzag, window, dead-row and ragged edge cases
     included, whisper-base's non-causal calls at phase 18's batches (its
     encoder and a training step's cross-attention at Sq 4096 against Sk
     1536, batch 16; a decode step's cross read, 8 clips), and the decode
     cases (Sq 1 and 3, GQA groups 1/2/8,
     window, dead rows, ragged Sk) and the CUDA-core instance's tile edges
     (``CORE_EDGE_CASES``: ragged 101 x 109, a window of 20 at every head
     dim, GQA 10 at D 256, bf16 at D 32) each run twice and required
     bitwise equal; each
     call's log names the instance that served it (decode: Sq <= 4; wgmma:
     bf16, D 64/128/256, Sq > 4; else the CUDA-core one);
  4. kernel C (fused paged decode) against its plain version on the card,
     each case run twice and required bitwise equal, the prefix cache's
     tables at the serving shape among them (four rows mapping the same 32
     leading pages, one a copy-on-write page with PAD_POS past its 8 kept
     rows), kernel A's resident and chunk-local calls of a bf16 prefill
     chunk at phase 14's shape resuming after a hit over such tables (at
     page-aligned offsets off the 256-token chunk grid, and after a COW
     page's kept rows), each run twice and required bitwise equal, and two
     calls of C on two streams at once each bitwise equal to its
     single-stream result; then C at head dim 256 (float32 on the split
     kernel, bf16 on the cluster instance) on the cases with up to 16 rows
     a KV head, recurrentgemma's 10/1 heads at page 16 and the alias
     poisoning, bitwise repeated, and its bf16 call at B 8, group 10, page
     16, 2048 keys timed beside its bound and the plain version;
  5. the paged engine and the dense-slab engine at qwen3-1.7b widths (2
     layers, float32) on the kernels, every emitted token teacher-forced
     against the plain path;
  6. the serving path: qwen3-1.7b at full width and depth (28 layers, bf16,
     seeded random weights) served by the paged engine and the dense-slab
     engine, each with its own kernel launch counts, held against its
     prefill ticks and decode steps, every step's logits finite; with
     ``--profile``, the paged and the
     dense-slab runs once more under torch.profiler (device busy share and
     the kernels that take the most device time; adds minutes);
  7. kernels B1 and B2 (flash backward: dq; dk/dv) against their plain
     version on the card, in float32 on the backward test cases (the
     CUDA-core instances), in bf16 at the training shape and on zigzag,
     window, dead-row and ragged cases at D 64 and 128 and non-causal
     cases at Sq != Sk (the wgmma instances), each run twice and required
     bitwise equal, gradients of rows that see no key exactly 0, and
     ``CORE_EDGE_CASES`` at the float32 limit; B1, B2
     and A held and timed at the training shapes beside SDPA (whisper-base's
     three at phase 18's batch of 16: cross, encoder, decoder), and A's, B1's
     and B2's float32 instances at ``F32_CORE_CALLS`` (phase 8's step call,
     16/8 heads, D 128, B 2 x S 512; the ``--reduced`` call, 4/4 heads of
     32, B 8 x 256; phase 20 (b)'s, 10/1 heads of 256, window 2048, B 2 x
     4096) beside their float32 bound, the plain version and SDPA's;
  8. one training step at qwen3-1.7b widths (2 layers, float32) on the
     kernels against the plain path: loss, every gradient, and the
     parameters after one AdamW step; then one bf16 step (kernel A's wgmma
     instance feeding B1/B2): loss and every gradient;
  9. the training path: qwen3-1.7b at full width and depth through the
     ``Trainer`` (AdamW, float32 parameters, bf16 compute, remat "full"),
     batch 2 x seq 4096, one warmup step and three timed steps whose launch
     counts must be 56 of A, 28 of B1 and 28 of B2 per step; with
     ``--profile``, one more step under torch.profiler;
 10. the ring strategies (tokenring with its accumulator travelling in
     float32 and in bf16, tokenring_faithful, ring, ring_bidir) on the
     virtual ring of P = 2, 4 and 8 ranks folded into the batch dimension
     of the card, at qwen3-1.7b attention widths in bf16 and float32:
     forward (out, lse) and q/k/v gradients on the kernels against the same
     ring on the plain versions, overlap=True bitwise equal to
     overlap=False, launches equal to the schedule's Computes, link bytes
     equal to the cost model and to ``comm_audit``'s walk of the same
     schedule; then the other strategies through their
     planners with the same checks (the output in place of (out, lse);
     every kernel call still held to phase 3's and 7's limits): Ulysses at
     P = 2, 4, 8; the window halo at P = 4, 8 (contig, windows 2048 and
     48); TokenRing2D through ``plan(topology=two_pods(n))`` at 2 x 2 and
     2 x 4 (bytes per link class); the multi-pod hybrid at 2 x 2 and 2 x 4
     with tokenring, ring and ulysses inside (ring_bidir, which the
     reference refuses there, refused); pass-KV and pass-Q (accumulator in
     float32 and bf16) through ``plan_prefill``, forward only, cold (4096
     queries and keys) and warm (the last 1024 queries against 4096 keys);
     TokenRing at the training shape under torch.profiler (the side
     stream's copies against the compute stream's kernels) with the
     overlap=True and overlap=False wall times; one 2-layer float32
     training step through TokenRing at P = 4 against the plain path;
 11. the ring training path: qwen3-1.7b at full width and depth through
     the ``Trainer`` with TokenRing over 4 virtual ranks, as phase 9
     otherwise, the first step's loss within ``SP1_LOSS_LIMIT`` of SP 1's
     on the same weights and batch, launch counts 448 of A, 224 of B1 and
     224 of B2 per step, then the same steps with overlap=False; with
     ``--profile``, one more step under torch.profiler;
 12. sequence-parallel serving on the virtual ring: ``sp_decode``,
     ``sp_decode_paged`` and ``sp_prefill`` at qwen3-1.7b attention widths
     (16/8 heads, D 128), f32 and bf16, P = 2, 4 and 8, window None and 48,
     on the kernels against the same ranks on the plain versions at phase
     3's and 4's limits (ranks with no live key, a table whose pages all sit
     on one stripe, one spanning every stripe, a row with no key exactly
     (0, -inf) before finalize and 0 after), each kernel case run twice and
     bitwise equal, all-reduce bytes equal to the cost models; the same
     functions in bf16 at P = 4 at phase 13's own shapes (dense slab of 4
     slots x 2048 keys, prefill chunks of 256 against it and against the
     paged view of 8 slots, paged decode of 8 slots with 128-entry tables
     into 1024 pages), bitwise repeated, with each kernel call they make
     held against its plain version and timed beside it, SDPA and its
     bound; then phase 5's engines at ``sp_degree=4``, teacher-forced
     against the plain SP-1 path, with launches equal to the products of
     ticks and steps, and the paged one once more with the prefix cache on
     prompts that share a 184-token head (a hit off the chunk grid and a
     copy-on-write);
 13. the SP serving path: phase 6's two runs with
     ``sp_degree=4`` (virtual ring) and nothing else changed, with launch
     counts per prefill tick and decode step, the all-reduce bytes per step,
     rank and direction against ``decode_comm_cost``, the pages each stripe
     holds at the peak and the share of tokens equal to phase 6's; with
     ``--profile``, both runs once more under torch.profiler; then every
     SP-4 chain fed back through phase 6's SP-1 bundle (and through the SP-4
     and the plain bundles as yardsticks), each SP-4 token within
     ``WITNESS_GAP`` of the row spread below SP 1's max logit;
 14. the prefix cache, the resilience layer and a snapshot restart (this
     slice's serving path): qwen3-1.7b at full width and depth through the
     paged engine of phase 6 on 16 requests that share a 512-token system
     prompt: a cold run, a prefix-cache run (hits, launches per tick and
     step, the auditor every 8 ticks), two warm repeats of request 0's
     prompt (prefill growth under one chunk, the second bitwise the first),
     a copy-on-write request (one copy, every index page's K/V bitwise
     unchanged), a run on a pool cut to 200 pages with one fault at each of
     the 7 tick points (every request
     done, ``fired`` the plan, the counters, a clean audit after each
     recovery) and a run snapshotted halfway, dropped and restarted from
     its snapshot (bitwise the prefix run's tokens); every token of the
     prefix, warm, COW and fault runs within ``WITNESS_GAP`` of the cold
     bundle's max logit, teacher-forced;
 15. checkpoint/restart training (the robustness slice's training path):
     qwen3-1.7b at full width and ``CKPT_LAYERS`` (8) of its 28 layers
     through the ``Trainer`` (batch 2 x seq 4096, remat "full") for 5 steps
     with a checkpoint every 2 (async saves), and through the
     ``FaultTolerantRunner`` with a failure before step 3
     (blocking saves, a restore from step 2): losses and parameters bitwise
     equal, launches 16/8/8 per step run, checkpoint bytes and save and
     restore seconds; then remat "dots" beside "full" from the same
     parameters and batch (the loss bitwise equal, gradients within phase
     8's bf16 limit, 3 timed steps and the peak memory of each);
 16. the other strategies' training path (this slice's main path):
     qwen3-1.7b at full width and depth through the ``Trainer`` (batch 2 x
     seq 4096, remat "full", one warmup and 2 timed steps) through Ulysses
     over 4 virtual ranks (launches 56/28/28 a step) and through the 2 x 2
     multi-pod hybrid with TokenRing inside each pod (448/224/224), each
     first loss within ``SP1_LOSS_LIMIT`` of SP 1's; step time, tok/s, peak
     memory, the bytes a step by link class (``RESULT training_ulysses``,
     ``RESULT training_hybrid``); with ``--profile``, one more step each
     under torch.profiler; then the serve CLI at full size with the prefix
     cache (``--shared-prefix 512 --page-size 16``): its adaptive-prefill
     line names what ``choose_prefill_strategy`` picks at the measured hit
     rate;
 17. the MoE and VLM families (this slice's main path): (a) at qwen3-moe
     widths, 2 layers, float32, a capacity factor at which nothing drops:
     one training step on the kernels against the plain path (phase 8's
     gates) and the paged and dense-slab engines teacher-forced against the
     plain SP-1 path (phase 5's), both again over 4 virtual ranks with
     expert parallelism, and the expert-parallel exchange's bytes against
     their closed form; (b) qwen3-moe-30b-a3b at full width and depth (48
     layers, bf16) served by phase 6's paged engine on phase 6's requests
     (96 A a prefill tick, 48 C a decode step, every step's logits finite;
     tok/s, TTFT, the median decode step beside the weight-read bound, peak
     memory; ``RESULT serving_moe``); (c) qwen3-moe at full width,
     ``MOE_TRAIN_LAYERS`` (4) of 48 layers, through the ``Trainer`` (batch 2
     x seq 4096, remat "full", one warmup and 2 timed steps) at SP 1
     (launches 8/4/4 a step, ``RESULT training_moe``) and through TokenRing
     over 4 virtual ranks with expert parallelism (64/32/32, ``RESULT
     training_moe_ring``; its first loss's distance from SP 1's reported,
     not gated: the capacities of the two dispatches differ, so do their
     drops); (d) llama4-scout at full width, ``LLAMA4_LAYERS`` (4) of 48
     layers (top-1 routing, the shared expert), through the dense-slab
     engine (``RESULT serving_llama4``); (e) pixtral-12b at full width and
     depth: ``lm_prefill`` of 2 requests of 1024 patch embeddings and 256
     tokens (40 A wgmma launches), 32 greedy decode steps (40 decode-instance
     launches each), every token within ``WITNESS_GAP`` of the plain path
     (``RESULT serving_vlm``);
 18. the encoder-decoder family (this slice's main path): (a) whisper-base
     at full width, 2 encoder and 2 decoder layers, float32, at SP 1 and
     through TokenRing over 4 virtual ranks: one training step on the
     kernels against the plain path (phase 8's gates; the decoder's
     queries against the encoder's 1536 keys, non-causal) and an encode
     then 16 greedy decode steps, each token teacher-forced through the
     plain path at SP 1 (phase 5's gate), A's launches counted; (b)
     whisper-base at full width and depth (6 + 6 layers, bf16 compute,
     float32 parameters, remat "full") through the ``Trainer`` with seeded
     frames (1536 x 512 a clip), batch 16 x 4096 decoder tokens, one warmup
     and 2 timed steps, at SP 1 (launches 36/18/18 a step, ``RESULT
     training_whisper``) and through TokenRing over 4 virtual ranks
     (288/144/144, ``RESULT training_whisper_ring``, first loss within
     ``SP1_LOSS_LIMIT`` of SP 1's); (c) 8 clips encoded and 128 greedy
     decode steps on a dense slab of 448 slots at SP 1 and over 4 virtual
     ranks (12 decode-instance launches a step: 6 self, 6 cross), every
     token within ``WITNESS_GAP`` of the plain path, teacher-forced
     (``RESULT serving_whisper``, ``serving_whisper_sp4``); with
     ``--profile``, one training step each and an encode with 16 decode
     steps under torch.profiler; then the serve CLI ``--arch whisper-base``
     on 4 requests through the engine's token-by-token prefill;
 19. the SSM family and the one-shot prefill at SP > 1 (this slice's main
     path): (a) ``sp_scan`` on the virtual ring against a loop over time
     at P = 2, 4, 8 and 2 x 2 pods (the reference's cases and one at
     falcon-mamba's state width), and falcon-mamba at full width, 2 layers,
     float32: the loss and every gradient leaf at SP 1 and through the scan
     over 4 virtual ranks against the plain path (its scan a loop over
     time), each bitwise repeated, the ring's bytes against their closed
     form; (b) falcon-mamba at full width, ``MAMBA_TRAIN_LAYERS`` (8) of
     64 layers, through the ``Trainer`` (bf16 compute, remat "full", batch
     2 x 4096, one warmup and 3 timed steps) at SP 1 (``RESULT
     training_mamba``) and through the scan over 4 virtual ranks (``RESULT
     training_mamba_ring``, first loss within ``SP1_LOSS_LIMIT`` of SP
     1's), no kernel launch; (c) falcon-mamba at full width and depth
     (bf16): 8 prompts of 256 tokens fed one token a step through
     ``decode_step``, 64 greedy tokens, every position within
     ``WITNESS_GAP`` of the forward pass (``RESULT decoding_mamba``), the
     engine's refusal; (d) ``lm_prefill`` of 2 x 1024 tokens at SP 4 on
     qwen3-1.7b at full size through TokenRing (A: 28 x the schedule's
     Computes), 16 greedy decode steps, every token within ``WITNESS_GAP``
     of SP 1's (``RESULT prefill_sp``); with ``--profile``, one profiled
     training step each;
 20. the hybrid family and the head-dim-256 kernels (this slice's main
     path): (a) kernels A, B1 and B2 at 10/1 heads and D 256 in float32
     and bf16 (the CUDA-core instances in float32; in bf16 the
     column-split wgmma instances of A, B1 and B2, each line
     naming the instance the built library picks, checked against
     ``flash_fwd_instance``/``flash_bwd_instance``; the training call, B 2
     x S 4096, causal, window 2048; a ragged 37 x 45 edge; dead rows) and
     A's decode instance (float32: the split kernel; bf16: the decode
     core's cluster instance, each line naming the kernel the built library
     picks, checked against ``decode_core_instance``)
     at group 10 x Sq 1 over a 2048-slot ring buffer (wrapped rows, a
     half-filled one, a row that sees no key) and at 1 to 16 rows a KV head
     (ragged Sk, windows, padding rows) against their plain versions,
     each case bitwise repeated, then each timed at the main path's shapes
     beside the plain version, SDPA on the same masked call and its bound
     (B1 + B2 beside SDPA's whole backward; A must beat SDPA's forward,
     and A's decode over a full buffer SDPA's masked call; the decode also
     timed at (d)'s lengths, 256-319 live keys of 2048 slots);
     (b) recurrentgemma-2b at full width, ``RG_CHECK_LAYERS`` (5) layers,
     float32: the loss and every gradient leaf on the kernels at SP 1 and
     through 4 virtual ranks (the window halo, the RG-LRU's scan) against
     the plain path, bitwise repeated (phase 8's limits); (c) at full width
     and depth (26 layers, bf16 compute, float32 AdamW, remat "full")
     through the ``Trainer`` (batch 2 x 4096, one warmup and 3 timed steps)
     at SP 1 (A 16, B1 8, B2 8 a step, ``RESULT training_rg``) and through
     the window halo and the scan over 4 virtual ranks (``RESULT
     training_rg_ring``, first loss within ``SP1_LOSS_LIMIT`` of SP 1's);
     (d) at full depth in bf16: 8 prompts of 256 tokens fed one token a
     step, 64 greedy tokens, 8 decode-instance launches a step, every
     layer's forward pass fed the decode's inputs within
     ``RG_LAYER_LIMIT`` (``RESULT decoding_rg``), the engine's refusal;
     (e) one superblock at full width in float32, one row fed 2112 tokens
     by ``decode_step``: every step's logits against the windowed forward
     pass, past the ring buffer's 2048 slots;
 21. the static analysis gate, ``repro_torch.launch.analyze``'s
     ``run_analysis(device="cuda")`` with every pass (schedule check, comm
     audit, the kernel lint with the card's limits and the build's ptxas
     report, the topology check): 0 findings (``RESULT analysis``);
 22. data parallelism with FSDP storage (this slice's main path): (a)
     qwen3-1.7b at full width, 2 layers, float32, on the virtual (data 2,
     model 4) mesh through TokenRing, batch 4 x 512: the FSDP step's loss
     and every gathered gradient leaf on the kernels against the plain path
     on one rank and the whole batch (phase 8's limits), a second pass
     bitwise equal, launches equal to the ring's Computes, the data-axis
     ledger equal to ``fsdp_comm_bytes`` (on the virtual mesh the data
     axis's collectives hand back their input and charge the ledger, so
     this gate shows that each leaf was gathered and reduce-scattered
     once, not the bytes a link carried); (b) qwen3-1.7b at full width and
     depth (28 layers, bf16 compute, float32 AdamW, remat "full") through
     the ``Trainer`` with FSDP storage on that mesh, global batch 4 x 4096,
     one warmup and 2 timed steps (448 A, 224 B1, 224 B2 a step), one more
     under torch.profiler (the idle share), the state a rank by the rules
     (``RESULT training_dp``), then the same global batch through the (1,
     4) mesh, untimed, each step's loss bitwise equal to it (the fold
     keeps the summation order; ``SP1_LOSS_LIMIT`` checked first); (c) at full
     width, 2 layers: the state migrated to ``shrink_mesh(4,
     model_axis=4)``'s (1, 4) mesh bitwise and one step there, a checkpoint
     saved on (2, 4) restored onto (4, 2) bitwise, and
     ``compressed_psum_ef`` over a virtual data axis of 8 ranks on the
     model's gradient tree at the reference's limits; the phase's seconds;
 23. the decode step under serve-mode (Megatron) storage (this slice's
     main path): (a) qwen3-1.7b and qwen3-moe-30b-a3b (capacity factor
     E / K) at full width, 2 layers, float32, on the virtual (1, 4) and
     (2, 4) meshes: a common prefill, then 8 decode steps on the serve
     blocks on the kernels teacher-forced with the replicated SP-4 decode
     on the plain path, each step's logits within 1e-4 of its row's
     largest |logit| (phase 8's limit) and each token within 1e-3 of the
     plain path's max logit (phase 5's gate), a second run bitwise equal,
     the ledger's bytes a step equal to ``serve_comm_bytes`` in every
     class, each rank's blocks the rule's, A's decode launches one a layer
     a step; (b) qwen2-72b at full width, 8 of its 80 layers, bf16: batch 8
     prompts of 2048 prefilled through the replicated ``lm_prefill`` at SP
     4, 32 greedy steps on the replicated tree (the reference), then the
     tree cut to serve blocks over the virtual (1, 4) mesh and freed, the
     reference's chain fed through the blocks (each token within
     ``WITNESS_GAP`` and each logit within ``SERVE_TP_LOGIT_GAP`` of the
     reference row's spread), then 32 greedy steps
     timed with CUDA events beside the weight-read bound, the peak memory,
     the TP bytes a step (= the closed form) and ``state_bytes`` at full
     depth for a model axis of 4 and 8 (``RESULT serving_tp``); the qkv
     biases are drawn at random (``SERVE_TP_BIAS_STD``), and the chain fed
     once more with them zeroed on the blocks must fail the logit limit;
     every call that kernel A served in (b)'s prefill and decode (the first
     of each shape) is then replayed through its wrapper twice (bitwise
     equal) and through its plain version at phase 3's limits; with
     ``--profile``, 4 steps once more under torch.profiler;
 24. the encoder-decoder, SSM and hybrid decode steps under serve-mode
     storage (this slice's main path): (a) whisper-base (2 + 2 layers),
     falcon-mamba-7b (2 layers) and recurrentgemma-2b (5 layers: every
     block kind) at full width, float32, on the virtual (1, 4) and (2, 4)
     meshes: the replicated SP-4 decode on the plain path (greedy) against
     the decode step on the serve blocks on the kernels, fed the same
     tokens, from one start (whisper's encode on the plain path; a seeded
     synthetic state for the recurrent two, recurrentgemma's at length 2040
     with its ring buffer's positions in ring order, so that its 16 steps
     wrap slot 2047 on rank 3 to slot 0 on rank 0), each step's logits
     within ``SERVE_LOGIT_LIMIT`` of its row's largest |logit| and each
     token within 1e-3 of the plain path's max logit, a second run bitwise
     equal, each rank's blocks the rule's, the ledger's bytes a step equal
     to the family's closed form, A's decode launches (two a whisper
     layer, one a recurrentgemma superblock, none for falcon-mamba);
     (b) each at full width, bf16, batch 8, over the virtual (1, 4) mesh:
     recurrentgemma-2b at all 26 layers from the synthetic state at
     length 2040 (A's D-256 decode instance on each rank's 512 ring slots,
     8 launches a step), falcon-mamba-7b at ``MAMBA_SERVE_LAYERS`` of 64
     layers from a synthetic state, whisper-base at its 6 layers from an
     encode of 8 clips (12 launches a step): 32 greedy steps of the
     replicated SP-1 decode on the kernels (the reference), the tree cut
     to serve blocks and the whole tree freed, the reference's chain fed
     through the blocks (their token and logit gaps from it logged as
     shares of its row spread), then 32 greedy steps timed with CUDA
     events beside the replicated step, the weight-read bound, the peak
     memory, the TP bytes a step (= the closed form) and ``state_bytes``
     at full depth for a model axis of 4 and 8 (``RESULT
     serving_tp_<family>``); with ``--profile``, 4 of recurrentgemma's
     steps once more under torch.profiler; A's calls on the blocks (the
     first of each shape) replayed through its wrapper twice (bitwise
     equal) and through its plain version at phase 3's limits.  The gate
     of (b)'s values runs
     in float32, at full width and depth (falcon-mamba at
     ``FAMILY_F32_LAYERS``), since two bf16 decodes that sum in other
     orders part by as much as either parts from its float32 run (logged
     as the bf16 floor): ``FAMILY_GATE_STEPS`` greedy steps of the
     replicated SP-1 decode, its chain fed through the blocks, each token within ``WITNESS_GAP`` and each logit within
     ``SERVE_TP_LOGIT_GAP`` of the reference row's spread, the ledger =
     the closed form; (c) the fault that this gate must catch:
     falcon-mamba's ``in_proj`` blocks of ranks 1 and 2 swapped in every
     layer (in this script only), 4 steps fed the chain, the logits above
     ``SERVE_TP_LOGIT_GAP``; each rank's slice of a recurrent state in (a)
     within ``SERVE_LOGIT_LIMIT`` of the leaf's max from its slice of the
     plain path's state; the phase's seconds;
 25. every family's decode step under serve-mode storage over the pod mesh
     (pod, data, model) (this slice's main path): (a) qwen3-moe-30b-a3b (2
     layers, capacity factor E / K, prefilled as in 23 (a)),
     falcon-mamba-7b (2 layers) and recurrentgemma-2b (5 layers, from
     length 2040: its 16 steps wrap the ring buffer over the 4 sequence
     ranks) at full width, float32, on the virtual (2, 1, 2) and (2, 2, 2)
     meshes, as 23 (a) and 24 (a): the replicated SP-4 decode on the plain
     path against the serve blocks on the kernels fed the same tokens,
     logits within ``SERVE_LOGIT_LIMIT``, a second run bitwise equal, each
     rank's blocks the rule's, each rank's slice of the recurrent state the
     model-major slice (``m * pods + p``) of the plain path's, bytes = the
     closed form, A's decode launches; (c) qwen3-moe's EP slices of pods 0
     and 1 swapped inside every model block of its first layer (in this
     script only): the logits must fail that limit; (b) qwen3-moe-30b-a3b
     at full width, ``POD_LAYERS`` of 48 layers, bf16, batch 8, from a
     seeded synthetic dense slab at length 2040: 32 greedy steps of the
     replicated SP-1 decode on the kernels (the reference), the tree cut to
     serve blocks over the virtual (2, 1, 2) and (1, 1, 4) meshes (both SP
     4) and freed, the reference's chain fed through each (gaps logged as
     shares of the row spread), 32 greedy steps on each timed with CUDA
     events, twice, in the order (2, 1, 2), (1, 1, 4), (1, 1, 4), (2, 1,
     2), beside the replicated step, the weight-read bound, the peak
     memory, the bytes a step (= ``serve_comm_bytes``) and ``state_bytes``
     at 48 layers on (2, 16, 16) (``RESULT serving_tp_pod``); the values
     gated in float32 at the same depth on (2, 1, 2) as 24 (b)'s gate; A's
     calls on the (2, 1, 2) blocks replayed through its wrapper twice and
     against its plain version; with ``--profile``, 4 steps on (2, 1, 2)
     under torch.profiler; the phase's seconds;
 26. the dry run (``repro_torch.launch.dryrun``: a step traced on fake
     tensors, its per-rank memory predicted by ``launch.step_analysis``)
     against the card: (a) phase 9's training step at world 1 (qwen3-1.7b
     at full width and depth, batch 2 x 4096, remat "full", bf16 compute,
     float32 AdamW): its predicted peak within ``DRYRUN_LIMIT`` (10%) of
     phase 9's measured ``peak_bytes_timed_steps``; (b) qwen3-1.7b's
     ``decode_step`` at full depth, bf16, batch 8 over a dense slab of 4096,
     SP 1: 4 steps on the card after ``reset_peak_memory_stats`` against
     the prediction, within the same limit; no kernel launch counted by
     either trace; (c) logged only: qwen2-72b ``decode_32k`` on (16, 16),
     traced on rank 0 over a fake group of 256 ranks in a process of its
     own with no card visible, started as the phase begins and collected
     after (b) (per-rank state, peak, dominant term, the trace's seconds;
     a train cell's trace outlasts the phase's minute, and
     ``tests/test_torch_dryrun.py`` traces qwen3-1.7b ``train_4k``);
     ``RESULT dryrun``; the phase's seconds;
 27. a ``{"kernels": [...]}`` summary line, the card line, and last the
     ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Timings are CUDA-event medians after warmup;
the serving-shape rows of kernels A and C also give each call's device
time from torch.profiler (their ``ms``), which leaves out the host's time
between launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:  # phase 2's ptxas rules are the kernel lint's
    from repro_torch.analysis.kernel_lint import (CLUSTER_KERNEL, CORE_KERNELS,
                                                  ptxas_functions, ptxas_wgmma_faults)
except ImportError:  # no checkout (or no torch) beside this file: main() refuses to run
    CLUSTER_KERNEL = CORE_KERNELS = ptxas_functions = ptxas_wgmma_faults = None

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core / fp32 CUDA core
PAD_POS = 2**30


_T0 = time.perf_counter()


def log(*args):
    if args and str(args[0]).startswith("== "):  # a phase header: the seconds so far
        args = (*args, f"[{time.perf_counter() - _T0:.1f} s]")
    print(*args, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median per-call device time over ``reps`` runs of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


PROFILER_TRIES = 3


def profiled(fn, activities, named=""):
    """``fn`` under torch.profiler; the profile, or None when it recorded no
    device event whose name holds ``named`` in each of ``PROFILER_TRIES``
    sessions.  CUPTI can drop a session's activity records (a trace with no
    kernel, where the same calls launched them), so an empty session is run
    again before the profiler is taken to be blind."""
    import torch
    from torch.profiler import profile

    for attempt in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA and named in e.key
               for e in prof.key_averages()):
            return prof
        log(f"  torch.profiler recorded no device event (session {attempt + 1} of "
            f"{PROFILER_TRIES})")
    return None


def device_ms(fn, iters: int = 30):
    """Device time of one call and how it was taken: the kernels' own time
    on the card (sum of every kernel the call launches, from torch.profiler)
    over ``iters`` calls.  Unlike :func:`time_ms` it leaves out the host's
    time between launches, which a call of a few tens of microseconds can
    exceed.

    The calls are alike, so each kernel's count is a multiple of ``iters``;
    where it is not, CUPTI dropped records, and the session is run again
    (``PROFILER_TRIES`` in all).  If none is whole, the session that lost
    the fewest gives each kernel its mean time times its launches a call
    (its count over ``iters``, rounded); if none recorded a kernel, CUDA
    events around the calls give the time.  The label says which."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    best = None
    for attempt in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.count, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        lost = sum(-count % iters for count, _ in kernels)
        total_us = sum(us for _, us in kernels)
        if kernels and not lost and total_us > 0:
            return total_us / iters / 1e3, "device time (torch.profiler)"
        log(f"  torch.profiler: {sum(c for c, _ in kernels)} kernel records of {iters} calls, "
            f"{lost} short of whole calls (session {attempt + 1} of {PROFILER_TRIES})")
        if kernels and total_us > 0 and (best is None or lost < best[0]):
            best = (lost, kernels)
    if best is None:
        return time_ms(fn, iters=iters), "CUDA events (torch.profiler recorded no kernels)"
    lost, kernels = best
    us = sum(t / c * max(1, round(c / iters)) for c, t in kernels)
    return us / 1e3, (f"device time (torch.profiler, {lost} lost kernel records filled with "
                      "their kernels' mean)")


def device_times(*calls):
    """:func:`device_ms` of each ``(fn, iters)``, and the row's timing label."""
    got = [device_ms(fn, iters) for fn, iters in calls]
    return [ms for ms, _ in got], " and ".join(sorted({how for _, how in got}))


def compare(name, got, want, atol, rtol, lse_tol, quiet=False):
    """Raise unless kernel ``(out, lse)`` matches the plain version; dead
    rows (plain lse = -inf) must be exactly (0, -inf).  Returns max |err|
    (and logs it unless ``quiet``)."""
    import torch

    (out, lse), (ref_out, ref_lse) = got, want
    dead = torch.isneginf(ref_lse)
    if not torch.equal(torch.isneginf(lse), dead):
        raise AssertionError(f"{name}: dead-row pattern differs from the plain version")
    if dead.any():
        if not (out.float()[dead] == 0).all():
            raise AssertionError(f"{name}: dead rows are not exactly 0")
    live = ~dead
    err = (out.float() - ref_out.float()).abs()
    lerr = (lse[live] - ref_lse[live]).abs()
    ok_out = torch.all(err <= atol + rtol * ref_out.float().abs())
    ok_lse = lerr.numel() == 0 or torch.all(lerr <= lse_tol)
    max_err = float(err.max()) if err.numel() else 0.0
    max_lerr = float(lerr.max()) if lerr.numel() else 0.0
    if not (ok_out and ok_lse) or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: max |out err| {max_err:.3e}, max |lse err| {max_lerr:.3e}")
    if not quiet:
        log(f"  ok {name}: max|out err| {max_err:.3e} max|lse err| {max_lerr:.3e}")
    return max_err


def tolerances(dtype):
    import torch

    # Both sides accumulate in float32 from the same inputs, only in another
    # order: f32 holds out and lse to 1e-4.  bf16 adds the rounding of out
    # to bf16, at most one bf16 step apart (relative 2**-7 < 1e-2); lse stays
    # float32, so 1e-3 absolute, with no relative term.
    if dtype == torch.bfloat16:
        return dict(atol=5e-3, rtol=1e-2, lse_tol=1e-3)
    return dict(atol=1e-4, rtol=1e-4, lse_tol=1e-4)


# ---------------------------------------------------------------------------
# phase 3: kernel A
# ---------------------------------------------------------------------------

SHAPES = [(1, 128, 128, 1, 1, 64), (2, 256, 256, 4, 2, 64), (1, 128, 256, 4, 1, 128),
          (1, 512, 512, 2, 2, 128)]


def flash_bytes_flops(q, k, q_pos, k_pos, causal, window):
    """What this call's data needs: every query and live key read once, the
    outputs written once, and 4*D flops per visible (query, key, head)."""
    from repro_torch.kernels.ref import visibility_mask

    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    live_keys = int((k_pos < PAD_POS // 2).sum())
    e = q.element_size()
    nbytes = (q.numel() * e + 2 * live_keys * Hkv * D * e + q_pos.numel() * 4
              + k_pos.numel() * 4 + q.numel() * e + B * Sq * Hq * 4)
    pairs = int(visibility_mask(q_pos, k_pos, causal=causal, window=window).sum())
    flops = 4.0 * D * Hq * pairs
    return nbytes, flops


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    def run(q, k, v, qp, kp, causal, window, scale=None):
        scale = scale or 1.0 / q.shape[-1] ** 0.5
        got = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=causal, window=window,
                                          scale=scale)
        want = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal, window=window,
                                            scale=scale, block_k=pick_block(k.shape[1], 512))
        return got, want

    def short(dtype):
        return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]

    def check(label, q, k, v, qp, kp, causal, window, repeat=False):
        """Kernel vs plain at the tolerances of q's type; the log names the
        instance of kernel A that served the call.  A decode-instance call
        (and any with ``repeat``) runs twice and must be bitwise equal (its
        splits merge in a fixed order)."""
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        name = f"A {short(q.dtype)} {label} [{inst}]"
        got, want = run(q, k, v, qp, kp, causal, window)
        if inst == "decode" or repeat:
            again, _ = run(q, k, v, qp, kp, causal, window)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two runs on the same inputs differ")
            name += " bitwise repeatable"
        return compare(name, got, want, **tolerances(q.dtype))

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Sk, Hq, Hkv, D) in SHAPES:
            for causal in (False, True):
                q, k, v = rnd((B, Sq, Hq, D), dtype), rnd((B, Sk, Hkv, D), dtype), rnd(
                    (B, Sk, Hkv, D), dtype)
                qp = torch.arange(Sq, device=dev, dtype=torch.int32).expand(B, Sq).contiguous()
                kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
                check(f"{(B, Sq, Sk, Hq, Hkv, D)} causal={causal}", q, k, v, qp, kp, causal,
                      None)
    # zigzag positions (P = 4), sliding window, dead rows: each in float32
    # (the CUDA-core instance) and in bf16 (the wgmma instance at D = 64)
    S, P = 256, 4
    half = S // (2 * P)
    zz = []
    for j in range(P):
        zz += list(range(j * half, (j + 1) * half))
        zz += list(range((2 * P - 1 - j) * half, (2 * P - j) * half))
    q32, k32, v32 = (rnd((2, S, 2, 64), torch.float32) for _ in range(3))
    zp = torch.tensor(zz, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    ar = torch.arange(S, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    kp_dead = ar.clone()
    kp_dead[1] = PAD_POS
    qp_dead = ar.clone()
    qp_dead[0, :16] = -1
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
        check("zigzag", q, k, v, zp, zp, True, None)
        check("window=48", q, k, v, ar, ar, True, 48)
        check("dead rows", q, k, v, qp_dead, kp_dead, True, None)
    # ragged edges: lengths that are no multiple of either instance's tiles.
    # The D=64/128 cases draw from a generator of their own, so the serving
    # shapes below get the same data as in earlier runs of this script.
    gen_ragged = torch.Generator(device=dev).manual_seed(1)
    for (Sq, Sk, D) in ((37, 45, 32), (37 + 128, 45 + 128, 64), (37 + 128, 45 + 128, 128)):
        g = gen if D == 32 else gen_ragged
        q32, k32, v32 = (torch.randn(shape, generator=g, device=dev)
                         for shape in ((2, Sq, 4, D), (2, Sk, 2, D), (2, Sk, 2, D)))
        qp = (torch.arange(Sq, device=dev, dtype=torch.int32) + 8).expand(2, Sq).contiguous()
        kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(2, Sk).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            check(f"ragged {Sq}x{Sk} D={D}", q32.to(dtype), k32.to(dtype), v32.to(dtype), qp, kp,
                  True, None)
    # no keys at all: every row is dead, exactly (0, -inf), on both instances
    qp = torch.arange(165, device=dev, dtype=torch.int32).expand(1, 165).contiguous()
    kp = torch.empty((1, 0), device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 165, 2, 128), generator=gen_ragged, device=dev).to(dtype)
        k = torch.empty((1, 0, 1, 128), device=dev, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, k, qp, kp, causal=True, window=None,
                                               scale=128 ** -0.5)
        inst = fa.flash_fwd_instance(dtype, 165, 128)
        if not (torch.equal(out, torch.zeros_like(out)) and torch.isneginf(lse).all()):
            raise AssertionError(f"A {short(dtype)} no keys [{inst}]: rows are not (0, -inf)")
        log(f"  ok A {short(dtype)} no keys Sq=165 Sk=0 [{inst}]: every row exactly (0, -inf)")

    phase_flash_decode(torch, dev, check)
    phase_flash_layouts(torch, dev, check)
    for case in CORE_EDGE_CASES:  # the CUDA-core instance's tile edges, bitwise repeated
        label, (q, k, v, qp, kp, _, _), window = core_edge_inputs(torch, dev, case)
        check(f"core edge {label}", q, k, v, qp, kp, True, window, repeat=True)

    # serving shapes: B=8, D=128, Sk=2048 (the resident call of a prefill
    # chunk and the dense decode call), each held in float32 and in
    # bfloat16; timed in bfloat16, the model's type.  qwen3-1.7b's 16/8
    # heads at Sq 1 and 256, then qwen3-moe-30b-a3b's 32/4 (the main path's
    # resident call; its decode runs on kernel C) at the same lengths, from
    # a generator of its own so that the first model's data stay as they were.
    rng_lengths = torch.randint(128, 2049 - 256, (8,), generator=gen, device=dev)
    B, D, Sk = 8, 128, 2048
    ar = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    kp = torch.where(ar < rng_lengths[:, None], ar, PAD_POS).to(torch.int32).contiguous()
    # the chunk-local call of a 256-token prefill chunk: Sq = Sk = 256
    cp = (rng_lengths[:, None] + torch.arange(256, device=dev)[None]).to(torch.int32).contiguous()

    def serving_rows(rnd_, Hq, Hkv, sqs, repeat):
        k32, v32 = rnd_((B, Sk, Hkv, D), torch.float32), rnd_((B, Sk, Hkv, D), torch.float32)
        k, v = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
        qc, kc, vc = (rnd_(shape, torch.float32) for shape in (
            (B, 256, Hq, D), (B, 256, Hkv, D), (B, 256, Hkv, D)))
        for dtype in (torch.float32, torch.bfloat16):
            check(f"chunk-local Sq=Sk=256 Hq={Hq} Hkv={Hkv}", qc.to(dtype), kc.to(dtype),
                  vc.to(dtype), cp, cp, True, None, repeat=repeat)
        rows = {}
        for Sq in sqs:
            q32 = rnd_((B, Sq, Hq, D), torch.float32)
            q = q32.to(torch.bfloat16)
            qp = (rng_lengths[:, None] - (1 if Sq == 1 else 0)
                  + torch.arange(Sq, device=dev)[None]).to(torch.int32).contiguous()
            label = f"serving Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv}"
            check(label, q32, k32, v32, qp, kp, True, None, repeat=repeat)
            err = check(label, q, k, v, qp, kp, True, None, repeat=repeat)
            rows[Sq] = timed_row(label, q, k, v, qp, kp, True, err)
        return rows

    def timed_row(label, q, k, v, qp, kp, causal, err):
        """One bf16 call of A timed beside its plain version and SDPA, with
        its bound."""
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        scale = 1.0 / D ** 0.5
        mask = kp[:, None, None, :] < PAD_POS // 2
        if causal:
            mask = mask & (qp[:, None, :, None] >= kp[:, None, None, :])
        # yardstick only: SDPA gives out without lse; KV repeated for GQA
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        fns = (lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=causal,
                                                   window=None, scale=scale),
               lambda: fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal,
                                                    window=None, scale=scale, block_k=512),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        # CUDA events around the calls (host gaps between launches included)
        ev_ms, ev_plain, ev_lib = (time_ms(f, iters=it) for f, it in zip(fns, (10, 3, 10)))
        # the kernels' own device time (torch.profiler; events where it sees none)
        (ms, plain_ms, lib_ms), how = device_times(*zip(fns, (30, 3, 30)))
        nbytes, flops = flash_bytes_flops(q, k, qp, kp, causal, None)
        bms, by = bound(nbytes, flops, "bfloat16")
        inst = fa.flash_fwd_instance(q.dtype, Sq, D)
        log(f"  A {label} [{inst}]: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms; events kernel {ev_ms:.4f} ms, plain {ev_plain:.4f} ms, "
            f"sdpa {ev_lib:.4f} ms; bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s at {how}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                    event_ms=ev_ms, event_plain_ms=ev_plain, event_library_ms=ev_lib,
                    max_abs_err=err, instance=inst, timing=how,
                    shape=(f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16 "
                           + ("causal" if causal else "non-causal")))

    def whisper_rows():
        """whisper-base's calls (8/8 heads, D 64), all non-causal, at the
        main path's batches: the encoder's self-attention (a training
        step's WHISPER_TRAIN_BATCH clips of 1536 frames), the
        cross-attention of a training step (4096 decoder tokens against
        1536 frames: 32 query tiles against 12 key tiles on the wgmma
        instance) and of a decode step (WHISPER_CLIPS clips, one token
        against 1536 frames, the decode instance at GQA group 1).  Each
        held in float32 and in bf16, the bf16 call bitwise repeated and
        timed."""
        g = torch.Generator(device=dev).manual_seed(7)
        rows = {}
        Bt = WHISPER_TRAIN_BATCH
        for name, (B, Sq, Sk) in (("encoder", (Bt, 1536, 1536)),
                                  ("cross_prefill", (Bt, 4096, 1536)),
                                  ("cross_decode", (WHISPER_CLIPS, 1, 1536))):
            q32, k32, v32 = (torch.randn(shape, generator=g, device=dev)
                             for shape in ((B, Sq, 8, 64), (B, Sk, 8, 64), (B, Sk, 8, 64)))
            qp = torch.arange(Sq, device=dev, dtype=torch.int32)
            if name == "cross_decode":  # decoder positions well past the first frames
                qp = qp + torch.randint(0, 448, (B, 1), generator=g, device=dev,
                                        dtype=torch.int32)
            qp = qp.expand(B, Sq).contiguous()
            kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
            label = f"whisper {name} B={B} Sq={Sq} Sk={Sk} Hq=8 Hkv=8 non-causal"
            check(label, q32, k32, v32, qp, kp, False, None)
            q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
            err = check(label, q, k, v, qp, kp, False, None, repeat=True)
            rows[name] = timed_row(label, q, k, v, qp, kp, False, err)
        return rows

    gen_moe = torch.Generator(device=dev).manual_seed(5)
    return {"qwen3-1.7b": serving_rows(rnd, 16, 8, (1, 256), repeat=False),
            "qwen3-moe-30b-a3b": serving_rows(
                lambda shape, dtype: torch.randn(shape, generator=gen_moe, device=dev).to(dtype),
                32, 4, (256,), repeat=True),
            "whisper-base": whisper_rows()}


# Decode-instance cases of kernel A (Sq <= 4): id, (B, Sq, Sk, Hq, Hkv, D),
# causal, window, layout.  GQA groups 1, 2 and 8 at Sq 1 and 3 (1 to 24 rows
# a block), 32 rows of one KV head at Sq 4 (two row chunks of 64), a window,
# dead rows, ragged Sk (no multiple of a tile or of a split), Sk shorter
# than one tile, D 64 and 32, and a non-causal call.
DECODE_CASES = [
    (f"g{Hq // Hkv} Sq={Sq}", (3, Sq, 1000, Hq, Hkv, 128), True, None, "lengths")
    for Sq in (1, 3) for Hq, Hkv in ((4, 4), (8, 4), (16, 2))
] + [
    ("mqa 32/1 Sq=4", (2, 4, 456, 32, 1, 128), True, None, "lengths"),
    ("window=48", (3, 1, 488, 8, 4, 128), True, 48, "lengths"),
    ("window=48 Sq=3", (3, 3, 488, 8, 4, 128), True, 48, "lengths"),
    ("dead rows", (3, 3, 472, 8, 4, 128), True, None, "dead"),
    ("Sk=20 < tile", (2, 1, 20, 8, 4, 128), True, None, "lengths"),
    ("D=64", (3, 3, 1000, 8, 4, 64), True, None, "lengths"),
    ("D=32", (3, 1, 1000, 8, 2, 32), True, None, "lengths"),
    ("noncausal", (2, 3, 300, 8, 4, 128), False, None, "lengths"),
]


# Kernel A at the head layouts of the MoE and VLM families, D 128, bf16:
# llama4-scout 40/8 (GQA group 5: 20 decode rows a KV head at Sq 4),
# qwen3-moe 32/4 (group 8: 32 rows at Sq 4) at the serving shapes of phase
# 17 (the resident call of a 256-token chunk against 2048 keys, decode
# against them), and pixtral's one-shot prefill, 32/8 with Sq = Sk = 1280;
# qwen2-72b 64/8 (group 8) at phase 23 (b)'s shapes: the decode against
# the SP-4 fold of 8 rows (32 rank rows of 520 slots) and against the whole
# 2080 slots, and a call of its TokenRing prefill (32 rank rows, 256
# queries against a block of 512 keys).
LAYOUT_CASES = [
    ("llama4 40/8 decode Sq=4", (2, 4, 1536, 40, 8, 128)),
    ("llama4 40/8 decode Sq=1", (4, 1, 2048, 40, 8, 128)),
    ("llama4 40/8 chunk", (2, 256, 2048, 40, 8, 128)),
    ("qwen3-moe 32/4 decode Sq=4", (2, 4, 1536, 32, 4, 128)),
    ("qwen3-moe 32/4 decode Sq=1", (8, 1, 2048, 32, 4, 128)),
    ("qwen3-moe 32/4 chunk", (8, 256, 2048, 32, 4, 128)),
    ("pixtral 32/8 prefill Sq=Sk=1280", (2, 1280, 1280, 32, 8, 128)),
    ("qwen2-72b 64/8 decode SP-4 fold", (32, 1, 520, 64, 8, 128)),
    ("qwen2-72b 64/8 decode Sq=1", (8, 1, 2080, 64, 8, 128)),
    ("qwen2-72b 64/8 ring chunk", (32, 256, 512, 64, 8, 128)),
]


def phase_flash_layouts(torch, dev, check):
    """LAYOUT_CASES in bf16, each run twice and required bitwise equal, at
    phase 3's limits."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, (B, Sq, Sk, Hq, Hkv, D) in LAYOUT_CASES:
        if Sq == Sk:  # one-shot prefill: queries and keys at the same positions
            qp = kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
        else:
            qp, kp = decode_positions(torch, dev, B, Sq, Sk, "lengths", gen)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
        check(f"{label} {(B, Sq, Sk, Hq, Hkv, D)}", q, k, v, qp, kp, True, None, repeat=True)


def decode_positions(torch, dev, B, Sq, Sk, layout, gen):
    """Each batch row's used length drawn in [1, Sk] (the first is Sk), keys
    past it padding, and its Sq queries at the last Sq positions.  "dead":
    batch row 1 has only padding keys and the first query of batch row 0
    precedes every key."""
    lengths = torch.randint(1, Sk + 1, (B,), generator=gen, device=dev)
    lengths[0] = Sk
    ar = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    kp = torch.where(ar < lengths[:, None], ar, PAD_POS).to(torch.int32).contiguous()
    qp = (lengths[:, None] - Sq + torch.arange(Sq, device=dev)[None]).to(torch.int32)
    if layout == "dead":
        kp[1] = PAD_POS
        qp[0, 0] = -1
    return qp.contiguous(), kp


def phase_flash_decode(torch, dev, check):
    """Kernel A's decode instance on DECODE_CASES in float32 and bf16, each
    run twice (bitwise equal) by ``check``; then a call with no keys."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(4)
    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, window, layout in DECODE_CASES:
        qp, kp = decode_positions(torch, dev, B, Sq, Sk, layout, gen)
        q32, k32, v32 = (torch.randn(shape, generator=gen, device=dev)
                         for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
        for dtype in (torch.float32, torch.bfloat16):
            check(f"decode {case_id} {(B, Sq, Sk, Hq, Hkv, D)}", q32.to(dtype), k32.to(dtype),
                  v32.to(dtype), qp, kp, causal, window)
    qp = torch.zeros((2, 1), device=dev, dtype=torch.int32)
    kp = torch.empty((2, 0), device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((2, 1, 8, 128), generator=gen, device=dev).to(dtype)
        k = torch.empty((2, 0, 4, 128), device=dev, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, k, qp, kp, causal=True, window=None,
                                               scale=128 ** -0.5)
        inst = fa.flash_fwd_instance(dtype, 1, 128)
        if not (torch.equal(out, torch.zeros_like(out)) and torch.isneginf(lse).all()):
            raise AssertionError(f"A {dtype} no keys [{inst}]: rows are not (0, -inf)")
        log(f"  ok A {str(dtype)[6:]} decode no keys Sq=1 Sk=0 [{inst}]: every row exactly "
            "(0, -inf)")


# ---------------------------------------------------------------------------
# phase 4: kernel C
# ---------------------------------------------------------------------------

PAGED_CASES = [
    ("ps1_mha", 1, (2, 2), (1, 3), None),
    ("ps4_gqa", 4, (8, 2), (3, 4, 5), None),
    ("ps8_mqa", 8, (4, 1), (8, 23), None),
    ("ps16_boundary", 16, (4, 4), (15, 16, 17, 64), None),
    ("ps8_window", 8, (4, 2), (40, 7), 16),
    # rows longer than one split of the kernel, so the merge combines
    # several partials (the plain version never splits)
    ("ps4_splits", 4, (8, 2), (300, 77, 129), None),
    ("ps8_window_splits", 8, (4, 2), (500, 33), 40),
    # GQA groups 8 and 16: the decode core's two- and four-row-group layouts
    ("ps16_group8", 16, (16, 2), (200, 31), None),
    ("ps16_group16", 16, (16, 1), (600, 5), None),
    # MQA with a group of 32: 8 rows a warp (no cap at 16 since the row chunks)
    ("ps16_group32_mqa", 16, (32, 1), (300, 40), None),
]
# The head layouts of the MoE family at D 128: llama4-scout 40/8 (GQA group
# 5) and qwen3-moe 32/4 (group 8), rows longer than one split
PAGED_LAYOUT_CASES = [
    ("ps16_llama4_40x8_group5", 16, (40, 8), (700, 33, 257), None),
    ("ps16_qwen3moe_32x4_group8", 16, (32, 4), (1100, 64, 513, 9), None),
]


def paged_case_data(case_id, ps, heads, lengths, D=32):
    """Reversed page order, sentinel table tails, random K/V under PAD_POS."""
    import numpy as np

    Hq, Hkv = heads
    B = len(lengths)
    W = max(-(-L // ps) for L in lengths) + 1
    n_pages = sum(-(-L // ps) for L in lengths) + 2
    rng = np.random.default_rng(zlib.crc32(repr((case_id, ps, heads, tuple(lengths))).encode()))
    k_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    pos_pool = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    free = list(range(n_pages))
    for b, L in enumerate(lengths):
        pages = [free.pop() for _ in range(-(-L // ps))][::-1]
        for ip, pg in enumerate(pages):
            bt[b, ip] = pg
            for off in range(ps):
                if ip * ps + off < L:
                    pos_pool[pg, off] = ip * ps + off
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    q_pos = (np.asarray(lengths, np.int32) - 1)[:, None]
    return [q, k_pool, v_pool, pos_pool, bt, q_pos]


def alias_poisoned_data(D=32):
    """Alias poisoning: the page a clamped sentinel would alias holds huge,
    live-looking K/V at visible positions, and row 1's table is all
    sentinel, so it must stay (0, -inf)."""
    raw = paged_case_data("dead", 4, (4, 2), (9, 5), D=D)
    n_pages = raw[1].shape[0]
    raw[4][1, :] = n_pages
    raw[1][n_pages - 1] = 1e3
    raw[2][n_pages - 1] = 1e3
    raw[3][n_pages - 1] = 0
    return raw


def prefix_shared_data(seed=2, B=8, ps=16, n_pages=1024, W=128, heads=(16, 8), D=128,
                       shared=32, keep=8):
    """Kernel C's inputs as the prefix cache lays them out, at the serving
    shape (8 rows, page 16, 1024 pages, 128-entry tables): rows 0-3 map the
    same ``shared`` leading pages (a 512-token system prompt), then pages of
    their own; row 4 maps ``shared - 1`` of them and then a copy-on-write
    page whose rows past ``keep`` hold ``PAD_POS`` (the copy before its
    prefill); rows 5-7 are private.  Pages come from a seeded permutation
    of the pool (not contiguous), tables end in the ``n_pages`` sentinel."""
    import numpy as np

    Hq, Hkv = heads
    rng = np.random.default_rng(seed)
    k_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    pos_pool = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    free = list(rng.permutation(n_pages))
    common = [int(free.pop()) for _ in range(shared)]
    lengths = []
    for b in range(B):
        if b < 4:
            L = shared * ps + int(rng.integers(1, W * ps - shared * ps + 1))
            pages = common + [int(free.pop()) for _ in range(-(-L // ps) - shared)]
        elif b == 4:
            L = (shared - 1) * ps + keep
            pages = common[:shared - 1] + [int(free.pop())]
        else:
            L = int(rng.integers(128, W * ps + 1))
            pages = [int(free.pop()) for _ in range(-(-L // ps))]
        lengths.append(L)
        bt[b, :len(pages)] = pages
        for ip, pg in enumerate(pages):
            for off in range(ps):
                if ip * ps + off < L:
                    pos_pool[pg, off] = ip * ps + off
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    q_pos = (np.asarray(lengths, np.int32) - 1)[:, None]
    return [q, k_pool, v_pool, pos_pool, bt, q_pos], lengths, common


PREFIX_PREFILL_STARTS = (528, 784, 1072, 1552, 504, 176, 1296, 1776)


def prefix_prefill_data(torch, dev, starts=PREFIX_PREFILL_STARTS, seed=3, ps=16, n_pages=1024,
                        W=128, heads=(16, 8), D=128, shared=32, keep=8, C=256):
    """Kernel A's two calls of a paged prefill chunk as the prefix cache
    feeds them, at phase 14's shape (8 rows, chunk ``C`` = 256, page 16,
    1024 pages, 128-entry tables, bf16): rows 0-3 map the same ``shared``
    leading pages (a 512-token system prompt) and resume at ``starts``,
    page-aligned offsets that are no multiple of the chunk, as after a
    hit; row 4 maps ``shared - 1`` of them and then a copy-on-write page
    whose rows past ``keep`` hold ``PAD_POS``, and resumes after the kept
    rows; rows 5-7 are private.  Pages come from a seeded permutation of the
    pool.  The resident view and its pre-chunk positions are gathered
    through the tables with the engine's own helpers.  Returns the
    resident call's and the chunk-local call's ``(q, k, v, q_pos, k_pos)``."""
    import numpy as np

    from repro_torch.serving.kv_cache import gather_pages, gather_positions, view_indices

    Hq, Hkv = heads
    B = len(starts)
    rng = np.random.default_rng(seed)
    pos_pool = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    free = list(rng.permutation(n_pages))
    common = [int(free.pop()) for _ in range(shared)]
    for b, start in enumerate(starts):
        n = -(-(start + C) // ps)
        head = common if b < 4 else common[:shared - 1] if b == 4 else []
        pages = head + [int(free.pop()) for _ in range(n - len(head))]
        bt[b, :n] = pages
        for ip, pg in enumerate(pages):
            for off in range(ps):
                if ip * ps + off < start:
                    pos_pool[pg, off] = ip * ps + off
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    k_pool, v_pool = rnd(n_pages, ps, Hkv, D), rnd(n_pages, ps, Hkv, D)
    lens = torch.tensor(starts, device=dev, dtype=torch.int32)
    flat = view_indices(torch.from_numpy(bt).to(dev), ps, lengths=lens)
    kp = gather_positions(torch.from_numpy(pos_pool).to(dev), flat).to(torch.int32).contiguous()
    k, v = gather_pages(k_pool, flat).contiguous(), gather_pages(v_pool, flat).contiguous()
    cow = (shared - 1) * ps
    if not (len({tuple(bt[b, :shared]) for b in range(4)}) == 1
            and bool((kp[4, cow:cow + keep] == torch.arange(cow, cow + keep, device=dev)).all())
            and bool((kp[4, cow + keep:cow + ps] == PAD_POS).all())):
        raise AssertionError("A prefix-shared prefill case: the tables are not laid out as "
                             "the prefix cache lays them out")
    qp = (lens[:, None] + torch.arange(C, device=dev)[None]).to(torch.int32).contiguous()
    q, kc, vc = rnd(B, C, Hq, D), rnd(B, C, Hkv, D), rnd(B, C, Hkv, D)
    return (q, k, v, qp, kp), (q, kc, vc, qp, qp)


def phase_prefix_prefill(torch, dev):
    """Kernel A's resident and chunk-local calls of a prefill chunk resuming
    after a prefix hit (``prefix_prefill_data``) against the plain version
    at bf16's limits, each call run twice and required bitwise equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    resident, local = prefix_prefill_data(torch, dev)
    for label, (q, k, v, qp, kp) in (("resident", resident), ("chunk-local", local)):
        scale = 1.0 / q.shape[-1] ** 0.5
        got = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=None, scale=scale)
        again = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=None,
                                            scale=scale)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"A prefix-shared prefill {label}: two runs on the same inputs "
                                 "differ")
        want = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=True, window=None,
                                            scale=scale, block_k=pick_block(k.shape[1], 512))
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        compare(f"A bf16 prefix-shared prefill {label} B={q.shape[0]} Sq={q.shape[1]} "
                f"Sk={k.shape[1]} (rows 0-3 share 32 pages and resume at page-aligned offsets "
                f"off the chunk grid, row 4 after a COW page's 8 kept rows) [{inst}] bitwise "
                "repeatable", got, want, **tolerances(torch.bfloat16))


def phase_paged(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    def to_dev(data, dtype):
        return [torch.from_numpy(x).to(dev).to(dtype if x.dtype.kind == "f" else torch.int32)
                .contiguous() for x in data]

    def run(data, lengths, window):
        """Kernel (run twice: bitwise equal or raise) and plain version."""
        q, kp, vp, pos, bt, qp = data
        scale = 1.0 / q.shape[-1] ** 0.5
        got = pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=window, scale=scale)
        again = pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=window, scale=scale)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("C: two runs on the same inputs differ")
        want = pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp, lengths=lengths, window=window,
                                         scale=scale, block_k=512)
        return got, want

    def splits(data):
        q, kp, _, _, bt, _ = data
        B, _, Hq, _ = q.shape
        n_pages, ps, Hkv, _ = kp.shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return fa.decode_split_rule(bt.shape[1] * ps, fa.decode_units(B, Hq, Hkv, 1), sms)[1]

    for dtype in (torch.float32, torch.bfloat16):
        for D, cases in ((32, PAGED_CASES), (128, PAGED_LAYOUT_CASES)):
            for case_id, ps, heads, lengths, window in cases:
                data = to_dev(paged_case_data(case_id, ps, heads, lengths, D=D), dtype)
                lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
                compare(f"C {str(dtype)[6:]} {case_id} D={D} ({splits(data)} splits) bitwise "
                        "repeatable", *run(data, lens, window), **tolerances(dtype))
    data = to_dev(alias_poisoned_data(), torch.float32)
    got, want = run(data, torch.tensor([9, 0], device=dev, dtype=torch.int32), None)
    compare("C f32 alias poisoning", (got[0], got[1]), want, **tolerances(torch.float32))
    if not (torch.equal(got[0][1], torch.zeros_like(got[0][1])) and torch.isneginf(got[1][1]).all()):
        raise AssertionError("C: unmapped row is not the merge identity")

    # serving shapes: ps=16, B=8, D=128, reversed pages, sentinel tails:
    # qwen3-1.7b's 16/8 heads at lengths up to 2048, each held in float32
    # and bf16 and timed in bf16 (the prefix-shared tables and two streams
    # follow); then qwen3-moe-30b-a3b's 32/4 heads, the main path's call, at
    # phase 6's lengths (its first 8 prompts, 16 tokens into their 32
    # decode steps)
    import numpy as np

    def serving_row(heads, lengths, D=128):
        Hq, Hkv = heads
        raw = paged_case_data("serving", 16, heads, tuple(lengths), D=D)
        lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
        label = f"serving ps=16 Hq={Hq} Hkv={Hkv}" + (f" D={D}" if D != 128 else "")
        n_keys = raw[4].shape[1] * 16
        data = to_dev(raw, torch.float32)
        how = decode_blocks(torch, dev, torch.float32, D, len(lengths), Hq, Hkv, n_keys)
        compare(f"C f32 {label} ({how}) bitwise repeatable",
                *run(data, lens, None), **tolerances(torch.float32))
        data = to_dev(raw, torch.bfloat16)
        how = decode_blocks(torch, dev, torch.bfloat16, D, len(lengths), Hq, Hkv, n_keys)
        err = compare(f"C bf16 {label} ({how}) bitwise repeatable",
                      *run(data, lens, None), **tolerances(torch.bfloat16))
        q, kp, vp, pos, bt, qp = data
        scale = 1.0 / D ** 0.5
        kern = lambda: pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp,  # noqa: E731
                                                window=None, scale=scale)
        plain = lambda: pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp,  # noqa: E731
                                                  lengths=lens, window=None, scale=scale,
                                                  block_k=512)
        ev_ms, ev_plain = time_ms(kern, iters=20), time_ms(plain, iters=5)
        (ms, plain_ms), timing = device_times((kern, 30), (plain, 5))
        pages_used = int((bt < kp.shape[0]).sum())
        ps = 16
        nbytes = (pages_used * ps * Hkv * D * 2 * 2 + pages_used * ps * 4 + bt.numel() * 4
                  + 2 * q.numel() * 2 + q.shape[0] * q.shape[2] * 4)
        flops = 4.0 * D * Hq * sum(lengths)
        bms, by = bound(nbytes, flops, "bfloat16")
        log(f"  C {label} [{how}]: device kernel {ms:.4f} ms ({ms / bms:.2f}x its bound), plain "
            f"{plain_ms:.4f} ms; events kernel {ev_ms:.4f} ms, plain {ev_plain:.4f} ms; bound "
            f"{bms:.4f} ms ({by}), {nbytes / ms / 1e6:.1f} GB/s over {pages_used} pages at "
            f"{timing}")
        return data, dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                          event_ms=ev_ms, event_plain_ms=ev_plain, timing=timing,
                          max_abs_err=err, lengths=list(lengths), blocks=how,
                          instance=fa.decode_core_instance(torch.bfloat16, D),
                          shape=f"B=8 ps=16 Hq={Hq} Hkv={Hkv} D={D} pages={pages_used} bf16")

    rng = np.random.default_rng(1)
    data, row = serving_row((16, 8), rng.integers(128, 2049, 8).tolist())
    rows = {"qwen3-1.7b": row}
    # prefix-shared tables: four rows map the same 32 leading pages, one a
    # copy-on-write page with PAD_POS past its 8 kept rows
    shared_raw, shared_lengths, common = prefix_shared_data()
    shared_lens = torch.tensor(shared_lengths, device=dev, dtype=torch.int32)
    if len({tuple(shared_raw[4][b, :32]) for b in range(4)}) != 1:
        raise AssertionError("C prefix-shared case: rows 0-3 do not map the same pages")
    for dtype in (torch.float32, torch.bfloat16):
        sdata = to_dev(shared_raw, dtype)
        compare(f"C {str(dtype)[6:]} prefix-shared ps=16 (rows 0-3 share 32 pages, row 4 a "
                f"COW page keeping 8 rows; {splits(sdata)} splits) bitwise repeatable",
                *run(sdata, shared_lens, None), **tolerances(dtype))

    phase_prefix_prefill(torch, dev)
    two_streams(torch, dev, pa, data, splits(data))
    phase6 = [len(p) + 16 for p in make_prompts(16, 128, 1024, 2)[:8]]
    rows["qwen3-moe-30b-a3b"] = serving_row((32, 4), phase6)[1]
    paged_d256_cases(torch, dev, to_dev, run)
    rows["d256"] = serving_row(*PAGED_D256_MAIN, D=256)[1]
    return rows


# Kernel C at head dim 256 (float32 on the split kernel's 16-row layout,
# bf16 on the cluster instance): the cases above with at most 16 rows a KV
# head, and recurrentgemma's 10/1 heads at page 16 (rows of 2048 keys and
# shorter, a window).
PAGED_D256_CASES = [c for c in PAGED_CASES if c[2][0] // c[2][1] <= 16] + [
    ("ps16_rg_group10", 16, (10, 1), (2048, 700, 33, 1), None),
    ("ps16_rg_group10_window", 16, (10, 1), (600, 45), 128),
]
PAGED_D256_MAIN = ((10, 1), (2048,) * 8)  # the timed call (heads, lengths) at page 16


def decode_blocks(torch, dev, dtype, D, B, Hq, Hkv, n_keys):
    """How the decode core cuts a call, for the logs: its splits, or the
    cluster instance's blocks a unit and tiles a block."""
    from repro_torch.kernels import flash_attention as fa

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    units = fa.decode_units(B, Hq, Hkv, 1)
    if fa.decode_core_instance(dtype, D) == "cluster":
        per, g = fa.decode_rule_d256(n_keys, units, sms)
        return f"cluster: {g} blocks a unit, {per} tiles each"
    return f"split: {fa.decode_split_rule(n_keys, units, sms)[1]} splits"


def paged_d256_cases(torch, dev, to_dev, run):
    """Phase 4 at head dim 256: ``PAGED_D256_CASES`` and the alias poisoning
    with an unmapped row in float32 and bf16, each run twice and bitwise
    equal (``run``)."""
    D = 256
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for case_id, ps, heads, lengths, window in PAGED_D256_CASES:
            data = to_dev(paged_case_data(case_id, ps, heads, lengths, D=D), dtype)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            how = decode_blocks(torch, dev, dtype, D, len(lengths), *heads,
                                data[4].shape[1] * ps)
            compare(f"C {name} {case_id} D={D} ({how}) bitwise repeatable",
                    *run(data, lens, window), **tolerances(dtype))
        got, want = run(to_dev(alias_poisoned_data(D), dtype),
                        torch.tensor([9, 0], device=dev, dtype=torch.int32), None)
        compare(f"C {name} alias poisoning D={D}", got, want, **tolerances(dtype))
        if not (torch.equal(got[0][1], torch.zeros_like(got[0][1]))
                and torch.isneginf(got[1][1]).all()):
            raise AssertionError(f"C {name} D={D}: unmapped row is not the merge identity")


def two_streams(torch, dev, pa, data, n_splits, rounds=20):
    """Two kernel C calls on two streams at once (different queries, the
    same pool), ``rounds`` times: each result bitwise equal to its
    single-stream result.  The decode core's merge counters are per
    (device, stream), so launches on two streams never share them."""
    q, kp, vp, pos, bt, qp = data
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = (q, (-q).contiguous())
    solo = [pa.paged_decode_fwd_cuda(x, kp, vp, pos, bt, qp, window=None, scale=scale)
            for x in qs]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    main = torch.cuda.current_stream(dev)
    got = [[], []]
    for st in streams:
        st.wait_stream(main)
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(pa.paged_decode_fwd_cuda(qs[i], kp, vp, pos, bt, qp, window=None,
                                                       scale=scale))
    torch.cuda.synchronize(dev)
    for i in range(2):
        for out, lse in got[i]:
            if not (torch.equal(out, solo[i][0]) and torch.equal(lse, solo[i][1])):
                raise AssertionError(f"C on two streams: stream {i}'s result differs from its "
                                     "single-stream result")
    log(f"  ok C two streams at once ({n_splits} splits): {rounds} rounds x 2 calls bitwise "
        "equal to their single-stream results")


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------


def make_prompts(n, lo, hi, vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lengths]


def phase_e2e_checked(torch, dev, sp_degree=1, label="phase 5", prefix_cache=False, cfg=None):
    """qwen3-1.7b widths (or ``cfg``'s), 2 layers, float32: the paged engine (kernels A and
    C) and the dense-slab engine (kernel A, its decode instance for every
    decode step), each emitted token teacher-forced against the plain path
    at SP 1 on the card.  With ``sp_degree > 1`` the engines serve over that
    many virtual ranks (phase 12).  With ``prefix_cache`` only the paged
    engine runs, with the prefix cache on and prompts that share a 184-token
    head (later requests map the first's 11 full pages and copy the 12th on
    write, keeping its 8 shared rows, so their prefill resumes at 184, off
    the 128-token chunk grid).  Launches of A and C must equal the products
    of the prefill ticks and decode steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    bundle = build_model(cfg, ParallelContext(device="cuda", sp_degree=sp_degree))
    params = bundle.init(0)
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    max_len = 512
    paths = (("paged", dict(page_size=16)), ("dense-slab", {}))
    prompts = make_prompts(6, 40, 300, cfg.vocab_size)
    if prefix_cache:
        import numpy as np

        paths = (("paged prefix-cache", dict(page_size=16, prefix_cache=True)),)
        head = make_prompts(1, 184, 184, cfg.vocab_size, seed=3)[0]
        prompts = [np.concatenate([head, p]) for p in prompts]
    for path, kw in paths:
        eng = ServingEngine(bundle, params, max_batch=4, max_len=max_len, prefill_chunk=128,
                            token_budget=256, device=dev, **kw)
        a0, c0 = flash_attention_fwd_cuda.launches, paged_decode_fwd_cuda.launches
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
        ran_a = flash_attention_fwd_cuda.launches - a0
        ran_c = paged_decode_fwd_cuda.launches - c0
        want = serving_launches(cfg.n_layers, eng.counters["prefill_steps"],
                                eng.counters["decode_steps"], paged=path != "dense-slab")
        if (ran_a, ran_c) != (want["flash_attention_fwd"], want["paged_decode_fwd"]):
            raise AssertionError(f"{label} {path}: launches A {ran_a}, C {ran_c}, expected {want}")
        worst = 0.0
        for r in reqs:
            if len(r.output) != 16:
                raise AssertionError(f"{path} request {r.uid} emitted {len(r.output)} tokens")
            state = plain.init_serve_state(1, max_len, dev)
            head = torch.from_numpy(r.prompt[:-1][None].copy()).to(dev)
            plain.prefill_chunk(params, head, state,
                                torch.tensor([head.shape[1]], device=dev, dtype=torch.int32))
            feed = [int(r.prompt[-1])] + r.output[:-1]
            for t, (tok_in, tok_out) in enumerate(zip(feed, r.output)):
                logits, state = plain.decode_step(params, torch.tensor([tok_in], device=dev),
                                                  state)
                row = logits[0].float()
                gap = float(row.max() - row[tok_out])
                worst = max(worst, gap)
                if gap > 1e-3:
                    raise AssertionError(f"{path} req {r.uid} step {t}: token {tok_out} is "
                                         f"{gap:.2e} below the plain path's max logit")
        hits = ""
        if prefix_cache:
            ps = eng.stats()["prefix"]
            if ps["hit_tokens"] == 0 or ps["cow_copies"] == 0 or eng.auditor.violations():
                raise AssertionError(f"{label} {path}: no prefix hit or no copy-on-write "
                                     f"({ps}) or the auditor found {eng.auditor.violations()}")
            hits = (f"; prefix hits {ps['hit_tokens']} of {ps['lookup_tokens']} tokens, "
                    f"{ps['cow_copies']} COW copies, {ps['indexed_pages']} pages indexed, "
                    "auditor clean")
        del eng
        log(f"  ok {label} {path} (SP {sp_degree}): {len(reqs)} requests x 16 tokens within "
            f"1e-3 of the plain SP-1 path (worst gap {worst:.2e}); launches A {ran_a}, C {ran_c}"
            + hits)


def serving_launches(L, ticks, steps, *, paged):
    """Launches of a serving run: every prefill tick runs A twice per layer
    (resident + chunk-local partial, the latter once over every rank on the
    virtual ring); a decode step runs C (paged) or A (dense) once per layer,
    over every rank's rows in one launch; serving runs no backward."""
    if paged:
        want = {"flash_attention_fwd": 2 * L * ticks, "paged_decode_fwd": L * steps}
    else:
        want = {"flash_attention_fwd": 2 * L * ticks + L * steps, "paged_decode_fwd": 0}
    return {**want, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def serve_run(torch, dev, bundle, params, *, n_requests, paged, seed=0, outputs=None):
    """Phase 6's request mix through a fresh engine; ``outputs`` (a list)
    receives every request's tokens.  The stats carry the median device
    time of a decode step and of a prefill tick (CUDA events around each
    step, read after the run)."""
    from repro_torch.serving.engine import ServingEngine

    kw = dict(page_size=16) if paged else {}
    eng = ServingEngine(bundle, params, max_batch=8 if paged else 4, max_len=2048,
                        prefill_chunk=256, token_budget=512, device=dev, **kw)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    events = {"decode": [], "prefill": []}

    def checked(step, kind):
        # every step's logits must be finite: one device flag, read once
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits, state = step(*args)
            end.record()
            events[kind].append((start, end))
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, state
        return run

    eng._step = checked(eng._step, "decode")
    eng._chunk_step = checked(eng._chunk_step, "prefill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32)
            for p in make_prompts(n_requests, 128, 1024, bundle.cfg.vocab_size, seed)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("a serving step gave non-finite logits")
    for r in reqs:
        if r.status != "done" or len(r.output) != 32:
            raise AssertionError(f"request {r.uid}: {r.status}, {len(r.output)} tokens")
        if not all(0 <= t < bundle.cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of vocabulary")
    if outputs is not None:
        outputs.extend(r.output for r in reqs)
    s = eng.stats()
    for kind, pairs in events.items():
        s[f"median_{kind}_ms"] = statistics.median(a.elapsed_time(b) for a, b in pairs)
    s["wall_s"] = wall
    s["tok_s"] = s["tokens"] / wall
    s["prompt_tokens"] = int(sum(len(r.prompt) for r in reqs))
    s["max_batch"] = eng.max_batch
    del eng
    return s


def device_rows(torch, prof):
    """``(device us, count, name)`` of every kernel in a profile, largest first.

    Summed straight from the profiler's raw events, as ``key_averages``
    sums a device event's self time, without building its event tree
    (tens of seconds for the tens of thousands of events of a training
    step)."""
    cuda = torch.autograd.DeviceType.CUDA
    sums = {}
    for evt in prof.profiler.kineto_results.events():
        if (evt.device_type() != cuda or evt.is_async()
                or getattr(evt, "is_hidden_event", lambda: False)()):
            continue
        us, count = sums.get(evt.name(), (0.0, 0))
        sums[evt.name()] = (us + evt.duration_ns() / 1e3, count + 1)
    rows = [(us, count, name) for name, (us, count) in sums.items()]
    rows.sort(reverse=True)
    return rows


def port_kernel_rows(rows, busy_s):
    """Log and return the profile rows of the port's own kernels (``rt::``),
    whether or not they are among the largest."""
    mine = [r for r in rows if "rt::" in r[2]]
    for us, count, key in mine:
        log(f"    port kernel {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} "
            f"{key[:70]}")
    return [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in mine]


def profile_run(torch, dev, bundle, params, unprofiled_wall_s, paged=True):
    """The paged (or dense-slab) run once more under torch.profiler: device
    busy time (sum of kernel times on the one stream) against the profiled
    wall, and the kernels that take the most device time.  The profiler adds
    host time per op, so its wall is above the unprofiled run's; the busy
    time over the unprofiled run's wall (same requests, same kernels) is
    printed beside it as the estimate of the unprofiled run's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = serve_run(torch, dev, bundle, params, n_requests=16 if paged else 4, paged=paged)
    rows = device_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profiled {'paged' if paged else 'dense-slab'} run: wall {s['wall_s']:.3f} s, "
        f"device busy {busy_s:.3f} s "
        f"({100 * busy_s / s['wall_s']:.1f}%), idle {100 * (1 - busy_s / s['wall_s']):.1f}%; "
        f"against the unprofiled wall {unprofiled_wall_s:.3f} s: busy "
        f"{100 * busy_s / unprofiled_wall_s:.1f}%, idle "
        f"{100 * (1 - busy_s / unprofiled_wall_s):.1f}%")
    for us, count, key in rows[:10]:
        log(f"    {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} {key[:90]}")
    return {"wall_s": s["wall_s"], "device_busy_s": busy_s,
            "unprofiled_wall_s": unprofiled_wall_s,
            "top": [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in rows[:10]],
            "port_kernels": port_kernel_rows(rows, busy_s)}


def phase_full(torch, dev, with_profile, sp_degree=1, reference=None, cfg=None,
               paths=("paged", "dense"), tag=None):
    """qwen3-1.7b (or ``cfg``) at full width (seeded weights) through the
    paged and the dense-slab engine (``paths``), with ``sp_degree`` virtual
    ranks (phase 13) or one (phase 6).  Returns each run's launches and the
    tokens it emitted; at SP > 1 the all-reduce bytes of each run must equal
    the cost models' per step and rank, and the share of tokens equal to
    ``reference`` (phase 6's) is logged.  Each run's median decode step
    stands beside the least time the card needs to read the weights a
    decode step reads (every layer's, the final norm and the LM head)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.core.decode import decode_comm_cost, prefill_comm_cost
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model

    cfg = cfg or ARCHS["qwen3-1.7b"]
    pctx = ParallelContext(device="cuda", sp_degree=sp_degree)
    bundle = build_model(cfg, pctx)
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    step_bytes = sum(t.numel() * t.element_size() for name, t in named_leaves(params)
                     if cfg.tie_embeddings or not name.startswith(".embed"))
    decode_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  weights: {cfg.n_layers} layers, {cfg.dtype}, seeded init "
        f"{time.perf_counter() - t0:.1f} s; SP degree {sp_degree}"
        + (" (virtual ring)" if sp_degree > 1 else ""))
    serve_run(torch, dev, bundle, params, n_requests=2, paged="paged" in paths,
              seed=99)  # warmup
    torch.cuda.reset_peak_memory_stats()
    suffix = f"_sp{sp_degree}" if sp_degree > 1 else ""
    runs, launches, outputs = {}, {}, {}
    for path, n_requests, paged in (("paged", 16, True), ("dense", 4, False)):
        if path not in paths:
            continue
        name = path + suffix
        outputs[path] = []
        if sp_degree > 1:
            pctx.ring.reset_counts()
        reset_launch_counts()
        s = serve_run(torch, dev, bundle, params, n_requests=n_requests, paged=paged,
                      outputs=outputs[path])
        got = {**launch_counts(), "paged_decode_fwd": paged_decode_fwd_cuda.launches}
        L, ticks, steps = cfg.n_layers, s["prefill_steps"], s["decode_steps"]
        want = serving_launches(L, ticks, steps, paged=paged)
        if got != want:
            raise AssertionError(f"{name} path: launches {got}, expected {want} from "
                                 f"{ticks} prefill ticks and {steps} decode steps")
        s["launches_per_prefill_tick"] = 2 * L
        s["launches_per_decode_step"] = L
        s["decode_weight_bytes"], s["decode_bound_ms"] = step_bytes, decode_bound_ms
        if sp_degree > 1:
            # every layer of a decode step all-reduces B rows, of a prefill
            # tick B x chunk rows (the resident partial); tables priced apart
            Bm, heads = s["max_batch"], (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
            dec = decode_comm_cost(Bm, 1, *heads, sp_degree).fwd_bytes * L
            pre = prefill_comm_cost(Bm, 256, *heads, sp_degree).fwd_bytes * L
            counted = dict(pctx.ring.link_bytes)
            want_bytes = dec * steps + pre * ticks
            if counted != {"fwd": want_bytes, "bwd": want_bytes}:
                raise AssertionError(f"{name}: all-reduce bytes {counted}, cost models "
                                     f"{want_bytes} a direction ({steps} steps x {dec} + "
                                     f"{ticks} ticks x {pre})")
            s["allreduce_bytes_per_decode_step"] = dec
            s["allreduce_bytes_per_prefill_tick"] = pre
            s["allreduce_bytes_run"] = counted
        if reference is not None:
            pairs = [(a, b) for x, y in zip(outputs[path], reference[path]) for a, b in zip(x, y)]
            s["tokens_equal_to_sp1_share"] = sum(a == b for a, b in pairs) / len(pairs)
            # a greedy chain that flips one near-tie differs from there on
            first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
                     for x, y in zip(outputs[path], reference[path])]
            s["requests_equal_to_sp1"] = sum(f == 32 for f in first)
            s["mean_first_difference"] = sum(first) / len(first)
        runs[name], launches[name] = s, got
    if "paged" in paths and min(launches["paged" + suffix]["flash_attention_fwd"],
                                launches["paged" + suffix]["paged_decode_fwd"]) == 0:
        raise AssertionError(f"a kernel was not launched on the paged path: {launches}")
    peak = torch.cuda.max_memory_allocated()
    for name, s in runs.items():
        log(f"  run {name}: {s['requests']} requests, {s['tokens']} tokens "
            f"({s['prompt_tokens']} prompt) in {s['wall_s']:.3f} s = {s['tok_s']:.2f} tok/s, "
            f"mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean latency "
            f"{s['mean_latency_s'] * 1e3:.1f} ms, {s['prefill_steps']} prefill ticks, "
            f"{s['decode_steps']} decode steps, {s['preemptions']} preemptions, "
            f"launches {launches[name]}")
        log(f"    {name}: median decode step {s['median_decode_ms']:.3f} ms against the "
            f"weight-read bound {s['decode_bound_ms']:.3f} ms ({s['decode_weight_bytes'] / 1e9:.2f} "
            f"GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); median prefill tick "
            f"{s['median_prefill_ms']:.3f} ms")
        if sp_degree > 1:
            log(f"    {name}: all-reduce {s['allreduce_bytes_per_decode_step']:.0f} B a decode "
                f"step and {s['allreduce_bytes_per_prefill_tick']:.0f} B a prefill tick, per rank "
                f"and direction (= decode_comm_cost / prefill_comm_cost x {cfg.n_layers} "
                f"layers); run total {s['allreduce_bytes_run']['fwd']:.0f} B a direction")
        if "pages" in s:
            log(f"    {name}: pages at the high water {s['pages']['high_water']} of "
                f"{s['pages']['pages_total']}"
                + (f", by stripe {s['pages']['stripes_at_high_water']}"
                   if "stripes_at_high_water" in s["pages"] else ""))
        if "tokens_equal_to_sp1_share" in s:
            log(f"    {name}: {100 * s['tokens_equal_to_sp1_share']:.1f}% of the tokens equal "
                f"phase 6's, {s['requests_equal_to_sp1']} of {s['requests']} requests whole, "
                f"first difference at token {s['mean_first_difference']:.1f} on average (not "
                "gated: the merge's bf16 rounding in another order can flip a near-tie)")
    log(f"  peak memory {peak / 2**30:.2f} GiB")
    prof = {path: profile_run(torch, dev, bundle, params, runs[path + suffix]["wall_s"],
                              paged=path == "paged")
            for path in paths} if with_profile else {}
    tag = tag or ("serving_sp" if sp_degree > 1 else "serving")
    log(f"RESULT {tag} " + json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                                      **{k: {kk: vv for kk, vv in v.items()
                                             if not isinstance(vv, dict)}
                                         for k, v in runs.items()},
                                      "peak_bytes": peak, "launches": launches,
                                      "profile_paged": prof.get("paged"),
                                      "profile_dense": prof.get("dense")}))
    return launches, outputs


# The SP-4 chains of phase 13 differ from phase 6's after a near-tie flips.
# To tell that from a fault of the SP path, every chain is fed back one
# token a step through phase 6's bundle (SP 1, the kernels): each SP-4 token
# must lie within WITNESS_GAP of that bundle's row spread (max minus mean
# logit) below its max logit.  Over a vocabulary of 151936 the max stands
# about 4.5 standard deviations above the mean and the two largest logits
# about 0.2 deviations apart, so a token drawn off a wrong attention lies a
# few deviations down, while rounding moves each logit by a small share of
# one.
WITNESS_GAP = 0.1


def forced_logits(torch, dev, bundle, params, prompts, chains, max_len=2048, chunk=256):
    """Logits ``(len(chain), vocab)`` of each of ``chains`` fed one token a
    step after its prompt's ``[:-1]`` prefilled in ``chunk``-token chunks
    (the engine's chunks, the last padded) into a dense slot of
    ``max_len``: one slot a prompt, all in one batch (a row whose head or
    chain has ended is skipped: ``n_valid`` 0, ``active`` False)."""
    heads = [p[:-1] for p in prompts]
    feeds = [[int(p[-1])] + list(c[:-1]) for p, c in zip(prompts, chains)]
    state = bundle.init_serve_state(len(prompts), max_len, dev)
    for i in range(0, max(len(h) for h in heads), chunk):
        part = torch.zeros((len(heads), chunk), dtype=torch.int32, device=dev)
        n = [max(0, min(chunk, len(h) - i)) for h in heads]
        for b, h in enumerate(heads):
            part[b, :n[b]] = torch.from_numpy(h[i:i + n[b]].copy()).to(dev)
        bundle.prefill_chunk(params, part, state, torch.tensor(n, device=dev, dtype=torch.int32))
    out = []
    for t in range(max(len(f) for f in feeds)):
        tok = torch.tensor([f[t] if t < len(f) else 0 for f in feeds], device=dev)
        active = torch.tensor([t < len(f) for f in feeds], device=dev)
        logits, state = bundle.decode_step(params, tok, state, active)
        out.append(logits.float())
    rows = torch.stack(out, 1)
    return [rows[b, :len(f)] for b, f in enumerate(feeds)]


def witness_gate(torch, dev, bundle, params, prompts, chains, label):
    """Feed every chain back through ``bundle`` (the reference path): each
    token must lie within ``WITNESS_GAP`` of the row spread (max minus mean
    logit) below the reference's max logit.  Returns the summary."""
    ratios, gaps, flips = [], [], 0
    for ref, chain in zip(forced_logits(torch, dev, bundle, params, prompts, chains), chains):
        top = ref.max(dim=-1).values
        gap = top - ref.gather(1, torch.tensor(chain, device=dev)[:, None])[:, 0]
        ratios.append(gap / (top - ref.mean(dim=-1)))
        gaps.append(gap)
        flips += int((gap > 0).sum())
    ratio, gap = torch.cat(ratios), torch.cat(gaps)
    r = dict(tokens=int(gap.numel()), flips=flips, max_gap=float(gap.max()),
             max_gap_over_spread=float(ratio.max()))
    log(f"  witness {label}: {r['tokens']} tokens fed back through the reference bundle, "
        f"{flips} not its argmax, largest gap {r['max_gap']:.5f} "
        f"({r['max_gap_over_spread']:.4f} of the row spread; limit {WITNESS_GAP})")
    if r["max_gap_over_spread"] > WITNESS_GAP:
        raise AssertionError(f"witness {label}: a token lies {r['max_gap_over_spread']:.4f} of "
                             f"the row spread below the reference's max logit")
    return r


def teacher_forced_witness(torch, dev, outputs, max_len=2048, chunk=256):
    """Feed each SP-4 chain (``outputs``: phase 13's tokens by path, its
    prompts regenerated from serve_run's seed) through three bundles on the
    same seeded weights, the prompt in ``chunk``-token chunks, then one
    token a step: SP 1 on the
    kernels (the reference), SP 4 on the kernels (virtual ring) and SP 1 on
    the plain versions.  Gates each SP-4 token's gap below the reference's
    max logit at ``WITNESS_GAP`` of the row's spread; logs how far the SP-4
    and the plain logits lie from the reference's, as the yardstick of
    rounding."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model

    cfg = ARCHS["qwen3-1.7b"]
    bundles = {name: build_model(cfg, ParallelContext(device="cuda", **kw)) for name, kw in (
        ("sp1", {}), ("sp4", dict(sp_degree=4)), ("plain", dict(impl="torch")))}
    params = bundles["sp1"].init(0)
    res = {}
    for path, n_requests in (("paged", 16), ("dense", 4)):
        prompts = make_prompts(n_requests, 128, 1024, cfg.vocab_size)
        gaps, ratios, spreads, margins, d_sp4, d_plain, flips = ([] for _ in range(7))
        forced = {name: forced_logits(torch, dev, b, params, prompts, outputs[path], max_len,
                                      chunk) for name, b in bundles.items()}
        for i, chain in enumerate(outputs[path]):
            rows = {name: f[i] for name, f in forced.items()}
            ref = rows["sp1"]
            top2 = ref.topk(2, dim=-1).values
            tok = torch.tensor(chain, device=dev)[:, None]
            gap = top2[:, 0] - ref.gather(1, tok)[:, 0]
            spread = top2[:, 0] - ref.mean(dim=-1)
            gaps.append(gap)
            ratios.append(gap / spread)
            spreads.append(spread)
            margins.append(top2[:, 0] - top2[:, 1])
            d_sp4.append((rows["sp4"] - ref).abs().amax(dim=-1))
            d_plain.append((rows["plain"] - ref).abs().amax(dim=-1))
            flips.append(gap > 0)
        gap, ratio, spread, margin, dsp4, dplain, flip = (torch.cat(x) for x in (
            gaps, ratios, spreads, margins, d_sp4, d_plain, flips))
        r = dict(tokens=int(gap.numel()), flips=int(flip.sum()), max_gap=float(gap.max()),
                 max_gap_over_spread=float(ratio.max()),
                 gaps_at_flips=[round(float(x), 5) for x in gap[flip].tolist()],
                 median_top2_margin=float(margin.median()),
                 median_spread=float(spread.median()),
                 sp4_vs_sp1_max_logit_diff=float(dsp4.max()),
                 sp4_vs_sp1_median_logit_diff=float(dsp4.median()),
                 plain_vs_sp1_max_logit_diff=float(dplain.max()),
                 plain_vs_sp1_median_logit_diff=float(dplain.median()))
        res[path] = r
        log(f"  witness {path}_sp4: {r['tokens']} tokens fed back through SP 1: {r['flips']} "
            f"are not SP 1's argmax, gaps below its max {r['gaps_at_flips']} (largest "
            f"{r['max_gap_over_spread']:.4f} of the row spread, median spread "
            f"{r['median_spread']:.3f}, median top-2 margin {r['median_top2_margin']:.4f}); "
            f"|SP-4 - SP-1 logits| max {r['sp4_vs_sp1_max_logit_diff']:.4f} median "
            f"{r['sp4_vs_sp1_median_logit_diff']:.4f}, |plain - SP-1| max "
            f"{r['plain_vs_sp1_max_logit_diff']:.4f} median "
            f"{r['plain_vs_sp1_median_logit_diff']:.4f}")
        if r["max_gap_over_spread"] > WITNESS_GAP:
            raise AssertionError(f"witness {path}: an SP-4 token lies "
                                 f"{r['max_gap_over_spread']:.4f} of the row spread below SP 1's "
                                 f"max logit (limit {WITNESS_GAP})")
    del bundles, params
    log("RESULT serving_sp_witness " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 12: sequence-parallel serving on the kernels
# ---------------------------------------------------------------------------

SP_HEADS = (16, 8, 128)  # qwen3-1.7b attention: Hq, Hkv, D


def sp_dense_data(torch, dev, P, dtype, Smax=1024, C=64):
    """Dense cache of 4 rows at lengths 1000 (every rank holds keys), 300
    (ranks past the first hold none), 37 (rank 0 alone) and 0 (no key
    at all: its decode query at position 0 sees nothing); a C-token chunk
    after each row's length."""
    import numpy as np

    Hq, Hkv, D = SP_HEADS
    rng = np.random.default_rng(zlib.crc32(repr(("sp_dense", P)).encode()))
    lengths = np.asarray([1000, 300, 37, 0])
    B = len(lengths)
    k_pos = np.full((B, Smax), PAD_POS, np.int32)
    for b, L in enumerate(lengths):
        k_pos[b, :L] = np.arange(L)
    c_pos = (lengths[:, None] + np.arange(C)).astype(np.int32)
    arrays = dict(
        q=rng.standard_normal((B, 1, Hq, D)), k=rng.standard_normal((B, Smax, Hkv, D)),
        v=rng.standard_normal((B, Smax, Hkv, D)), k_pos=k_pos,
        q_pos=np.maximum(lengths - 1, 0)[:, None].astype(np.int32),
        cq=rng.standard_normal((B, C, Hq, D)), ck=rng.standard_normal((B, C, Hkv, D)),
        cv=rng.standard_normal((B, C, Hkv, D)), c_pos=c_pos)
    return {n: torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(
        dtype if x.dtype.kind == "f" else torch.int32) for n, x in arrays.items()}


def sp_paged_data(torch, dev, P, dtype, ps=16, n_pages=128, W=64):
    """Page pool of ``n_pages`` pages striped over P ranks: row 0's table
    spans every stripe (one page from each in turn, reversed), row 1's
    pages all sit on the last stripe, row 2 holds two pages of rank 0, row 3
    none (all sentinel)."""
    import numpy as np

    Hq, Hkv, D = SP_HEADS
    rng = np.random.default_rng(zlib.crc32(repr(("sp_paged", P)).encode()))
    n_local = n_pages // P
    rows = [[(i % P) * n_local + i // P for i in range(W)][::-1],
            [n_pages - n_local + i for i in range(min(20, n_local))],
            [0, 1], []]
    lengths = np.asarray([W * ps - 5, len(rows[1]) * ps - 3, 20, 0])
    pos = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((len(rows), W), n_pages, np.int32)
    for b, pages in enumerate(rows):
        bt[b, :len(pages)] = pages
        for i, pg in enumerate(pages):
            for off in range(ps):
                if i * ps + off < lengths[b]:
                    pos[pg, off] = i * ps + off
    arrays = dict(q=rng.standard_normal((len(rows), 1, Hq, D)),
                  k_pool=rng.standard_normal((n_pages, ps, Hkv, D)),
                  v_pool=rng.standard_normal((n_pages, ps, Hkv, D)), pos_pool=pos,
                  block_tables=bt, q_pos=np.maximum(lengths - 1, 0)[:, None].astype(np.int32),
                  lengths=lengths.astype(np.int32))
    return {n: torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(
        dtype if x.dtype.kind == "f" else torch.int32) for n, x in arrays.items()}


def phase_sp_attention(torch, dev, ps=(2, 4, 8)):
    """``sp_decode``, ``sp_decode_paged`` and ``sp_prefill`` over P virtual
    ranks at qwen3-1.7b attention widths, f32 and bf16: on the kernels
    against the same ranks on the plain versions under phase 3's and 4's
    limits (each merged ``(out, lse)``; the row with no key exactly ``(0,
    -inf)`` before finalize, exactly 0 after), every kernel case run twice
    and bitwise equal, one launch of A (decode), C (paged) or two of A
    (prefill) a call, and the all-reduce bytes per rank and direction equal
    to ``decode_comm_cost`` / ``prefill_comm_cost``."""
    from repro_torch.core import decode as dec
    from repro_torch.core.api import ParallelContext, sp_decode, sp_decode_paged, sp_prefill
    from repro_torch.core.collectives import fold_ranks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    Hq, Hkv, D = SP_HEADS
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = tolerances(dtype)
        tag = str(dtype)[6:]
        for P in ps:
            d = sp_dense_data(torch, dev, P, dtype)
            p = sp_paged_data(torch, dev, P, dtype)
            folded = {n: fold_ranks(d[n], P) for n in ("k", "v", "k_pos")}
            ring = ParallelContext(device="cuda", sp_degree=P).ring
            B = d["q"].shape[0]

            def calls(impl, window):
                kw = dict(ring=ring, window=window, impl=impl, return_lse=True)
                return {
                    "decode": lambda: dec.sp_decode_attention(
                        d["q"], folded["k"], folded["v"], folded["k_pos"], q_pos=d["q_pos"],
                        **kw),
                    "prefill": lambda: dec.sp_prefill_chunk_attention(
                        d["cq"], d["ck"], d["cv"], d["c_pos"], folded["k"], folded["v"],
                        folded["k_pos"], q_pos=d["c_pos"], **kw),
                    "paged": lambda: dec.sp_paged_decode_attention(
                        p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"],
                        p["q_pos"], lengths=p["lengths"], **kw),
                }

            per_call = {"decode": (1, 0), "prefill": (2, 0), "paged": (0, 1)}
            for window in (None, 48):
                kern, plain = calls("cuda", window), calls("torch", window)
                for name in kern:
                    a0, c0 = fa.flash_attention_fwd_cuda.launches, pa.paged_decode_fwd_cuda.launches
                    got, again = kern[name](), kern[name]()
                    ran = (fa.flash_attention_fwd_cuda.launches - a0,
                           pa.paged_decode_fwd_cuda.launches - c0)
                    if ran != tuple(2 * n for n in per_call[name]):
                        raise AssertionError(f"phase 12 {name} P={P}: launches {ran} for two "
                                             f"calls, expected {per_call[name]} a call")
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise AssertionError(f"phase 12 {name} P={P}: two runs differ")
                    label = f"SP {name} {tag} P={P} window={window} bitwise repeatable"
                    compare(label, got, plain[name](), quiet=True, **tol)
                    # row 3 holds no key: decode sees nothing; a prefill
                    # chunk there is a fresh slot's first (every rank's
                    # resident partial empty, the chunk's own keys live)
                    empty = 3
                    if name != "prefill" and not (torch.isneginf(got[1][empty]).all()
                            and torch.equal(got[0][empty], torch.zeros_like(got[0][empty]))):
                        raise AssertionError(f"{label}: the keyless row is not (0, -inf)")
                    n_cases += 1
            # the public entry points: bytes, and the keyless row exactly 0
            pctx = ParallelContext(device="cuda", sp_degree=P)
            ring2 = pctx.ring
            cost_dec = dec.decode_comm_cost(B, 1, Hq, Hkv, D, P)
            cost_pre = dec.prefill_comm_cost(B, d["cq"].shape[1], Hq, Hkv, D, P)
            for name, fn, cost in (
                    ("decode", lambda: sp_decode(d["q"], folded["k"], folded["v"],
                                                 folded["k_pos"], d["q_pos"], pctx=pctx),
                     cost_dec),
                    ("paged", lambda: sp_decode_paged(
                        p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"],
                        p["q_pos"], p["lengths"], pctx=pctx), cost_dec),
                    ("prefill", lambda: sp_prefill(d["cq"], d["ck"], d["cv"], d["c_pos"],
                                                   folded["k"], folded["v"], folded["k_pos"],
                                                   d["c_pos"], pctx=pctx), cost_pre)):
                ring2.reset_counts()
                out = fn()
                if ring2.link_bytes != {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}:
                    raise AssertionError(f"phase 12 {name} {tag} P={P}: bytes "
                                         f"{ring2.link_bytes}, cost model {cost}")
                if name != "prefill" and not torch.equal(out[3], torch.zeros_like(out[3])):
                    raise AssertionError(f"phase 12 {name} {tag} P={P}: keyless row not 0")
            log(f"  ok SP {tag} P={P}: decode, prefill and paged decode (window None and 48) on "
                f"the kernels within phase 3/4 limits of the plain ranks, bitwise repeatable, "
                f"keyless row (0, -inf); all-reduce bytes a rank and direction "
                f"{cost_dec.fwd_bytes:.0f} (decode, paged) and {cost_pre.fwd_bytes:.0f} "
                f"(prefill) = the cost models")
    log(f"  phase 12: {n_cases} kernel cases passed")


def sp_main_data(torch, dev, P=4, Smax=2048, ps=16, n_pages=1024, C=256):
    """Phase 13's attention inputs at P = 4 in bf16, laid out as its engines
    lay them out.  Decode lengths are drawn from ``Smax/16 + 1`` to
    ``Smax/2 + 32`` (129-1056: prompts of 128-1024 tokens plus up to 32 new
    ones); a prefill chunk's resident
    length is the multiple of the chunk size C below, row 0's 0 (a fresh
    slot: no resident key on any rank).  Dense slab: 4 slots of ``Smax``
    keys, rank-major (16 rows of 512 keys).  Paged: 8 slots with block
    tables of ``Smax / ps`` entries into a pool of ``n_pages`` pages; row
    1 holds the lowest page ids (all on stripe 0, as the allocator hands
    them out first), the other rows pages drawn from every stripe; the
    chunk's resident view is gathered rank-major (32 rows of ``Smax``
    keys, each rank's own pages live) as ``lm_prefill_chunk_paged`` does."""
    import numpy as np

    from repro_torch.core.collectives import fold_ranks
    from repro_torch.serving.kv_cache import (
        gather_pages,
        gather_positions,
        stripe_view,
        view_indices,
    )

    Hq, Hkv, D = SP_HEADS
    W = Smax // ps
    rng = np.random.default_rng(zlib.crc32(b"sp_main"))
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def lengths(B):
        dec = rng.integers(Smax // 16 + 1, Smax // 2 + 33, B)
        pre = (dec - 1) // C * C
        pre[0] = 0
        return dec, pre

    dec, pre = lengths(4)
    ar = np.arange(Smax)[None]
    dense = dict(q=rnd(4, 1, Hq, D), q_pos=ints(dec[:, None] - 1),
                 k=fold_ranks(rnd(4, Smax, Hkv, D), P), v=fold_ranks(rnd(4, Smax, Hkv, D), P),
                 k_pos=fold_ranks(ints(np.where(ar < dec[:, None], ar, PAD_POS)), P),
                 pre_pos=fold_ranks(ints(np.where(ar < pre[:, None], ar, PAD_POS)), P),
                 cq=rnd(4, C, Hq, D), ck=rnd(4, C, Hkv, D), cv=rnd(4, C, Hkv, D),
                 c_pos=ints(pre[:, None] + np.arange(C)))
    dec, pre = lengths(8)
    used = -(-dec // ps)
    free = iter(rng.permutation(np.arange(used[1], n_pages)).tolist())
    bt = np.full((8, W), n_pages, np.int32)
    pos = np.full((n_pages, ps), PAD_POS, np.int32)
    for b in range(8):
        pages = list(range(used[1])) if b == 1 else [next(free) for _ in range(used[b])]
        bt[b, :used[b]] = pages
        for i, pg in enumerate(pages):
            pos[pg] = np.where(i * ps + np.arange(ps) < dec[b], i * ps + np.arange(ps), PAD_POS)
    k_pool, v_pool, pos_pool, tables = (rnd(n_pages, ps, Hkv, D), rnd(n_pages, ps, Hkv, D),
                                        ints(pos), ints(bt))
    view = stripe_view(view_indices(tables, ps, lengths=ints(pre)), n_pages, ps, P, None)
    paged = dict(q=rnd(8, 1, Hq, D), q_pos=ints(dec[:, None] - 1), k_pool=k_pool,
                 v_pool=v_pool, pos_pool=pos_pool, block_tables=tables, lengths=ints(dec),
                 k_view=gather_pages(k_pool, view), v_view=gather_pages(v_pool, view),
                 view_pos=gather_positions(pos_pool, view), cq=rnd(8, C, Hq, D),
                 ck=rnd(8, C, Hkv, D), cv=rnd(8, C, Hkv, D),
                 c_pos=ints(pre[:, None] + np.arange(C)))
    return dense, paged


def phase_sp_main_shapes(torch, dev, P=4, **sizes):
    """The SP serving functions at the shapes phase 13 gives kernels A and C
    (:func:`sp_main_data`), bf16, on the kernels against the same ranks on
    the plain versions under phase 3's and 4's limits, every call run twice
    and bitwise equal, with its launches checked.  Then each kernel call
    these functions make, on the inputs they give it: the wrapper against
    its plain version (the same limits) and timed beside the plain version,
    the PyTorch library call (A: ``scaled_dot_product_attention`` with the
    same mask, GQA heads repeated; C: none) and the bound of this data's
    work (``sizes`` shrink :func:`sp_main_data` for a rehearsal off the
    card).  Returns the timing rows by call."""
    import torch.nn.functional as F

    from repro_torch.core import decode as dec
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ops import pick_block
    from repro_torch.kernels.ref import visibility_mask

    d, p = sp_main_data(torch, dev, P, **sizes)
    ring = ParallelContext(device="cuda", sp_degree=P).ring
    tol = tolerances(torch.bfloat16)
    calls = {
        "dense decode": ((1, 0), lambda impl: dec.sp_decode_attention(
            d["q"], d["k"], d["v"], d["k_pos"], q_pos=d["q_pos"], ring=ring, impl=impl,
            return_lse=True)),
        "dense prefill": ((2, 0), lambda impl: dec.sp_prefill_chunk_attention(
            d["cq"], d["ck"], d["cv"], d["c_pos"], d["k"], d["v"], d["pre_pos"],
            q_pos=d["c_pos"], ring=ring, impl=impl, return_lse=True)),
        "paged prefill": ((2, 0), lambda impl: dec.sp_prefill_chunk_attention(
            p["cq"], p["ck"], p["cv"], p["c_pos"], p["k_view"], p["v_view"], p["view_pos"],
            q_pos=p["c_pos"], ring=ring, impl=impl, return_lse=True)),
        "paged decode": ((0, 1), lambda impl: dec.sp_paged_decode_attention(
            p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"], p["q_pos"],
            ring=ring, lengths=p["lengths"], impl=impl, return_lse=True)),
    }
    for name, (per_call, fn) in calls.items():
        a0, c0 = fa.flash_attention_fwd_cuda.launches, pa.paged_decode_fwd_cuda.launches
        got, again = fn("cuda"), fn("cuda")
        ran = (fa.flash_attention_fwd_cuda.launches - a0, pa.paged_decode_fwd_cuda.launches - c0)
        if ran != tuple(2 * n for n in per_call):
            raise AssertionError(f"phase 12 {name} at phase 13's shapes: launches {ran} for two "
                                 f"calls, expected {per_call} a call")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"phase 12 {name} at phase 13's shapes: two runs differ")
        compare(f"SP bf16 P={P} {name} at phase 13's shapes, bitwise repeatable", got,
                fn("torch"), **tol)

    scale = 1.0 / SP_HEADS[2] ** 0.5
    rep = ring.replicate
    a_calls = {  # the kernel-A calls of phase 13, each on its own inputs
        "paged_prefill_resident": (rep(p["cq"]), p["k_view"], p["v_view"], rep(p["c_pos"]),
                                   p["view_pos"]),
        "paged_prefill_chunk_local": (p["cq"], p["ck"], p["cv"], p["c_pos"], p["c_pos"]),
        "dense_prefill_resident": (rep(d["cq"]), d["k"], d["v"], rep(d["c_pos"]),
                                   d["pre_pos"]),
        "dense_decode": (rep(d["q"]), d["k"], d["v"], rep(d["q_pos"]), d["k_pos"]),
    }
    rows = {}
    for name, (q, k, v, qp, kp) in a_calls.items():
        Hq, Hkv = q.shape[2], k.shape[2]
        kern = lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True,  # noqa: E731
                                                   window=None, scale=scale)
        plain = lambda: fa.flash_attention_fwd_torch(  # noqa: E731
            q, k, v, qp, kp, causal=True, window=None, scale=scale,
            block_k=pick_block(k.shape[1], 512))
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        err = compare(f"A bf16 [{inst}] phase 13's {name} call", kern(), plain(), **tol)
        mask = visibility_mask(qp, kp, causal=True, window=None)[:, None]
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        (ms, plain_ms, lib_ms), how = device_times((kern, 30), (plain, 3), (lib, 30))
        bms, by = bound(*flash_bytes_flops(q, k, qp, kp, True, None), "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                          bound_by=by, max_abs_err=err, instance=inst, timing=how,
                          shape=f"B={q.shape[0]} Sq={q.shape[1]} Sk={k.shape[1]} Hq={Hq} "
                                f"Hkv={Hkv} D={q.shape[3]} bf16 (P={P} folded)")
        del mask, qt, kt, vt
    # kernel C: every rank's rows of the table keep only its stripe
    bt = dec.folded_stripe_tables(p["block_tables"], P, p["k_pool"].shape[0])
    q, qp, lens = rep(p["q"]), rep(p["q_pos"]), rep(p["lengths"])
    kern = lambda: pa.paged_decode_fwd_cuda(q, p["k_pool"], p["v_pool"],  # noqa: E731
                                            p["pos_pool"], bt, qp, window=None, scale=scale)
    plain = lambda: pa.paged_decode_fwd_torch(  # noqa: E731
        q, p["k_pool"], p["v_pool"], p["pos_pool"], bt, qp, lengths=lens, window=None,
        scale=scale, block_k=512)
    err = compare(f"C bf16 phase 13's paged decode call (P={P} folded)", kern(), plain(), **tol)
    (ms, plain_ms), how = device_times((kern, 30), (plain, 5))
    n_pages, ps, Hkv, D = p["k_pool"].shape
    live = int((bt < n_pages).sum())
    nbytes = (live * ps * Hkv * D * 2 * 2 + live * ps * 4 + bt.numel() * 4 + 2 * q.numel() * 2
              + q.shape[0] * q.shape[2] * 4)
    bms, by = bound(nbytes, 4.0 * D * q.shape[2] * int(p["lengths"].sum()), "bfloat16")
    rows["paged_decode"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by, max_abs_err=err,
        timing=how,
        shape=f"B={q.shape[0]} ps={ps} Hq={q.shape[2]} Hkv={Hkv} D={D} W={bt.shape[1]} "
              f"pool={n_pages} live entries={live} bf16 (P={P} folded)")
    for name, r in rows.items():
        log(f"  phase 13's {name} call: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            + (f"sdpa {r['library_ms']:.4f} ms, " if r["library_ms"] is not None else "")
            + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: kernels B1 and B2
# ---------------------------------------------------------------------------

BWD_CASES = [
    # id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window: the JAX package's
    # backward cases (tests/test_kernels.py::BWD_CASES), then D=128 GQA, a
    # ragged edge (no multiple of the kernels' 32-row tiles, Sq != Sk) and
    # dead rows (queries before every key; a batch row of padding keys)
    ("causal", (1, 128, 128, 2, 2, 32), True, "contig", None),
    ("noncausal", (1, 128, 128, 2, 2, 32), False, "contig", None),
    ("gqa", (2, 128, 128, 4, 2, 32), True, "contig", None),
    ("mqa", (1, 128, 128, 4, 1, 64), True, "contig", None),
    ("zigzag", (1, 256, 256, 2, 2, 32), True, "zigzag", None),
    ("zigzag_gqa", (1, 256, 256, 4, 2, 32), True, "zigzag", None),
    ("window", (1, 256, 256, 2, 2, 32), True, "contig", 64),
    ("gqa_d128", (2, 256, 256, 16, 8, 128), True, "contig", None),
    ("ragged", (2, 37, 45, 4, 2, 32), True, "offset", None),
    ("dead_rows", (2, 256, 256, 2, 2, 64), True, "dead", None),
]
# bf16 cases on the wgmma instances (D 64/128): the bf16 D 64/128 rows of
# BWD_CASES, then zigzag, window and ragged edges at both widths
BWD_BF16_CASES = [
    ("mqa", (1, 128, 128, 4, 1, 64), True, "contig", None),
    ("gqa_d128", (2, 256, 256, 16, 8, 128), True, "contig", None),
    ("dead_rows", (2, 256, 256, 2, 2, 64), True, "dead", None),
] + [case for D in (64, 128) for case in (
    ("zigzag", (1, 256, 256, 4, 2, D), True, "zigzag", None),
    ("window", (1, 256, 256, 2, 2, D), True, "contig", 64),
    ("ragged", (2, 37, 45, 4, 2, D), True, "offset", None),
    ("ragged", (2, 165, 173, 4, 2, D), True, "offset", None),
)] + [("qwen3-moe 32/4", (2, 1024, 1024, 32, 4, 128), True, "contig", None)] + [
    # whisper-base's non-causal calls (8/8 heads, D 64): self-attention, the
    # cross-attention of a 448-token decoder context against 1536 frames,
    # and a ragged Sq != Sk edge
    ("non-causal", (2, 256, 256, 8, 8, 64), False, "contig", None),
    ("whisper cross", (2, 448, 1536, 8, 8, 64), False, "contig", None),
    ("ragged non-causal", (2, 37, 173, 4, 4, 64), False, "offset", None),
]
TRAIN_SHAPE = dict(B=2, S=4096, Hq=16, Hkv=8, D=128)  # qwen3-1.7b, batch 2 x seq 4096
MOE_TRAIN_SHAPE = dict(B=2, S=4096, Hq=32, Hkv=4, D=128)  # qwen3-moe-30b-a3b, the same batch
WHISPER_TRAIN_BATCH = 16  # train_4k's global batch of 256, cut for one card
# whisper-base's three attention calls of a training step (8/8 heads, D 64)
# at the main path's batch (phase 18 (b)), the decoder at train_4k's 4096
# tokens, the encoder at 1536 frames
WHISPER_TRAIN_SHAPES = {
    "cross": dict(B=WHISPER_TRAIN_BATCH, S=4096, Sk=1536, Hq=8, Hkv=8, D=64, causal=False),
    "encoder": dict(B=WHISPER_TRAIN_BATCH, S=1536, Hq=8, Hkv=8, D=64, causal=False),
    "decoder": dict(B=WHISPER_TRAIN_BATCH, S=4096, Hq=8, Hkv=8, D=64),
}
# The wgmma instances round P and dS to bf16 (2^-9 relative per term) as
# the operands of the dq, dk and dv products, where the plain backward
# multiplies float32 values.  Each gradient element is a sum of such terms
# of random sign, so its error scales with the size of its row's terms, not
# with the element itself: a limit in |plain| or in absolute units is either
# loose for rows with small gradients (long causal rows, late keys) or tight
# for large ones.  The limit is therefore per row of D values: |err| <=
# row * rms(plain row), and per tensor ||err|| <= l2 * ||plain||.  On the
# card the worst element read 1.23e-2 of its row's RMS at the training
# shape (1.19e-2 on the cases above), and the worst tensor 1.65e-3 relative
# L2 there (1.76e-3 above) (PERF.md, section 6); a CPU emulation of the
# rounding against the JAX backward (tests/test_torch_flash_bwd_numerics.py)
# passes the same limit.  It keeps 2.4x and 2.8x above those readings and
# stays 20x below a typical element (0.67 of its row's RMS).  A row whose plain gradient is all zero
# must be exactly zero.  The float32 limits stay 1e-4.
BWD_BF16_LIMIT = dict(row=3e-2, l2=5e-3)


def zigzag_order(S, P):
    half = S // (2 * P)
    zz = []
    for j in range(P):
        zz += list(range(j * half, (j + 1) * half))
        zz += list(range((2 * P - 1 - j) * half, (2 * P - j) * half))
    return zz


def bwd_positions(torch, dev, B, Sq, Sk, layout):
    qp = torch.arange(Sq, device=dev, dtype=torch.int32)
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)
    if layout == "zigzag":
        qp = kp = torch.tensor(zigzag_order(Sq, 4), device=dev, dtype=torch.int32)
    elif layout == "offset":
        qp = qp + 8
    qp = qp.expand(B, Sq).contiguous()
    kp = kp.expand(B, Sk).contiguous()
    if layout == "dead":
        qp[0, :16] = -1
        kp[1] = PAD_POS
    return qp, kp


def bwd_bytes_flops(q, k, q_pos, k_pos, causal, window, flops_per_pair_dim, out_tensors):
    """Inputs read once (q, dout, live K/V, lse/delta/dlse, positions), the
    float32 gradients written once, and ``flops_per_pair_dim * D`` flops per
    visible (query, key, head): 6 for B1 (s, dp, dq), 8 for B2 (s, dp, dk, dv)."""
    from repro_torch.kernels.ref import visibility_mask

    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    live_keys = int((k_pos < PAD_POS // 2).sum())
    e = q.element_size()
    nbytes = (2 * q.numel() * e + 2 * live_keys * Hkv * D * e + 3 * B * Sq * Hq * 4
              + (q_pos.numel() + k_pos.numel()) * 4 + sum(t.numel() * 4 for t in out_tensors))
    pairs = int(visibility_mask(q_pos, k_pos, causal=causal, window=window).sum())
    return nbytes, float(flops_per_pair_dim) * D * Hq * pairs


def run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window, out=None, lse=None):
    """B1 and B2 twice each (bitwise equal or raise) and the plain backward,
    on the same inputs; ``out``/``lse`` default to the plain forward's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    scale = 1.0 / q.shape[-1] ** 0.5
    Sq, Sk = q.shape[1], k.shape[1]
    if out is None:
        out, lse = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal, window=window,
                                                scale=scale, block_k=pick_block(Sk, 512))
        lse = lse.contiguous()  # the plain version returns a transposed view
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    args = (q, k, v, qp, kp, dout, lse, delta, dlse)
    kw = dict(causal=causal, window=window, scale=scale)

    def kernels():
        return (fa.flash_attention_bwd_dq_cuda(*args, **kw),
                *fa.flash_attention_bwd_dkv_cuda(*args, **kw))

    got, again = kernels(), kernels()
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
    want = fa.flash_attention_bwd_torch(q, k, v, qp, kp, out, lse, dout, dlse, causal=causal,
                                        window=window, scale=scale,
                                        block_q=pick_block(Sq, 512), block_k=pick_block(Sk, 512))
    return got, want, args, kw


def compare_grads(torch, name, got, want, atol=0.0, rtol=0.0, row=0.0, l2=None, dead=None,
                  elementwise=True, quiet=False):
    """Raise unless each of dq/dk/dv is finite and within ``atol + rtol *
    |plain| + row * rms(plain row)`` of the plain version elementwise (a row
    is the D values of one (batch, position, head); ``elementwise=False``
    skips this), ``||err|| <= l2 * ||plain||`` when ``l2`` is given, and,
    given ``dead = (rows, keys)``, the dq rows that see no key and the dk/dv
    rows of keys that no query sees are exactly 0.  Returns the largest
    |error| and the readings ``(max |err|/rms(row), ||err||/||plain||)`` of
    each gradient (logged unless ``quiet``)."""
    worst, readings, pairs = 0.0, [], []
    for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {g_name}: not finite")
        err = (g - w).abs()
        rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        rel_row = float((err / rms).nan_to_num(0.0, posinf=float("inf")).max())
        rel_l2 = float(err.norm() / w.norm())
        pairs.append((rel_row, rel_l2))
        if elementwise and not torch.all(err <= atol + rtol * w.abs() + row * rms):
            raise AssertionError(f"{name} {g_name}: max |err| {float(err.max()):.3e}, "
                                 f"max |err|/rms(row) {rel_row:.3e}")
        if l2 is not None and not rel_l2 <= l2:
            raise AssertionError(f"{name} {g_name}: ||err||/||plain|| {rel_l2:.3e} > {l2}")
        worst = max(worst, float(err.max()))
        readings.append(f"{g_name} {rel_row:.2e}/{rel_l2:.2e}")
    n_dead = ""
    if dead is not None:
        rows, keys = dead
        for g_name, g, m in (("dq", got[0], rows), ("dk", got[1], keys), ("dv", got[2], keys)):
            if g[m].count_nonzero():
                raise AssertionError(f"{name} {g_name}: gradients of rows that see no key, or "
                                     "of keys that no query sees, are not exactly 0")
        n_dead = f", {int(rows.sum())} dead (row, head) and {int(keys.sum())} unseen keys exactly 0"
    if not quiet:
        log(f"  ok {name}: max|grad err| {worst:.3e} (max |err|/rms(row) / ||err||/||plain||: "
            f"{', '.join(readings)}){n_dead}, a second run bitwise equal")
    return worst, pairs


def dead_masks(torch, lse, qp, kp, causal, window):
    """``(rows, keys)``: the (batch, query, head) rows whose lse is -inf,
    and the (batch, key) rows that no query of the batch row sees."""
    from repro_torch.kernels.ref import visibility_mask

    seen = visibility_mask(qp, kp, causal=causal, window=window).any(dim=1)
    return torch.isneginf(lse), ~seen


def training_shape_rows(torch, dev, rnd, train_shape):
    """Kernels A (wgmma), B1 and B2 at one model's training shape (bf16;
    causal unless ``train_shape["causal"]`` is False, ``Sk`` keys, default
    ``S``): A's out/lse and the gradients against the plain versions at
    phase 3's and phase 7's bf16 limits, each kernel run twice and required
    bitwise equal; then each timed beside the plain versions and SDPA, with
    its bound.  Returns the rows "fwd", "dq" and "dkv"."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    B, S, Hq, Hkv, D = (train_shape[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    Sk, causal = train_shape.get("Sk", S), train_shape.get("causal", True)
    bf = torch.bfloat16
    q, dout = rnd((B, S, Hq, D), bf), rnd((B, S, Hq, D), bf)
    k, v = rnd((B, Sk, Hkv, D), bf), rnd((B, Sk, Hkv, D), bf)
    dlse = rnd((B, S, Hq))
    qp = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
    scale = 1.0 / D ** 0.5
    keys = "" if Sk == S else f" Sk={Sk}"

    def fwd():
        return fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=causal, window=None,
                                           scale=scale)

    out, lse = fwd()
    if not all(torch.equal(x, y) for x, y in zip((out, lse), fwd())):
        raise AssertionError(f"A bf16 training shape B={B} S={S}{keys} Hq={Hq} Hkv={Hkv}: two "
                             "runs on the same inputs differ")
    blk, blk_k = pick_block(S, 512), pick_block(Sk, 512)  # the plain versions' tiles
    a_err = compare(f"A bf16 training shape B={B} S={S}{keys} Hq={Hq} Hkv={Hkv} D={D} "
                    f"causal={causal} [{fa.flash_fwd_instance(bf, S, D)}] bitwise repeatable",
                    (out, lse),
                    fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal, window=None,
                                                 scale=scale, block_k=blk_k),
                    **tolerances(bf))
    # bf16 inputs at the training shape; out/lse from kernel A, as on the
    # training path; held to the bf16 limit (BWD_BF16_LIMIT).
    got, want, args, kw = run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, None, out, lse)
    shape = (f"B={B} S={S}{keys} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             + ("causal" if causal else "non-causal"))
    inst = fa.flash_bwd_instance_built(bf, D)
    err, _ = compare_grads(torch, f"B1/B2 bf16 training shape {shape} [{inst}]", got, want,
                           dead=dead_masks(torch, lse, qp, kp, causal, None), **BWD_BF16_LIMIT)

    ms_dq = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args, **kw), iters=3, reps=3)
    ms_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args, **kw), iters=3, reps=3)
    plain_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_torch(
        q, k, v, qp, kp, out, lse, dout, dlse, causal=causal, window=None, scale=scale,
        block_q=blk, block_k=blk_k), iters=1, reps=3)
    ms_a = time_ms(fwd, iters=3, reps=3)
    plain_fwd_ms = time_ms(lambda: fa.flash_attention_fwd_torch(
        q, k, v, qp, kp, causal=causal, window=None, scale=scale, block_k=blk_k),
        iters=1, reps=3)
    # yardsticks only: SDPA gives no lse, so its backward has no dlse term
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    lib_fwd_ms = time_ms(sdpa, iters=5)
    o_t, do_t = sdpa(), dout.transpose(1, 2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                                     retain_graph=True), iters=5)
    rows = {}
    for name, ms, per_pair, outs in (("dq", ms_dq, 6, got[:1]), ("dkv", ms_dkv, 8, got[1:])):
        nbytes, flops = bwd_bytes_flops(q, k, qp, kp, causal, None, per_pair, outs)
        bms, by = bound(nbytes, flops, "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms, bound_ms=bms,
                          bound_by=by, max_abs_err=err, instance=inst, shape=shape,
                          plain_and_library_compute="dq, dk and dv in one call")
        log(f"  B {name} [{inst}]: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.2f} TFLOP/s")
    nbytes, flops = flash_bytes_flops(q, k, qp, kp, causal, None)
    bms, by = bound(nbytes, flops, "bfloat16")
    inst = fa.flash_fwd_instance(q.dtype, S, D)
    rows["fwd"] = dict(ms=ms_a, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms, bound_ms=bms,
                       bound_by=by, max_abs_err=a_err, instance=inst, shape=shape)
    log(f"  training shape {shape}: A [{inst}] {ms_a:.3f} ms (plain {plain_fwd_ms:.3f}, sdpa {lib_fwd_ms:.3f}, "
        f"bound {bms:.4f} {by}, {flops / ms_a / 1e9:.2f} TFLOP/s); backward plain "
        f"{plain_bwd_ms:.3f} ms, sdpa backward {lib_bwd_ms:.3f} ms")
    return rows


F32_STEP_SHAPE = dict(B=2, S=512, Hq=16, Hkv=8, D=128)  # phase 8's float32 step's attention
# The float32 calls at which the CUDA-core instances are timed: phase 8's
# step (qwen3-1.7b's 16/8 heads of 128), the `--reduced` quickstart's
# (`ArchConfig.reduced()`: 4/4 heads of 32, the train CLI's batch 8 x 256)
# and phase 20 (b)'s (recurrentgemma-2b's 10/1 heads of 256, window 2048,
# batch 2 x 4096); all causal, contiguous positions.
F32_CORE_CALLS = {
    "phase8": F32_STEP_SHAPE,
    "reduced_d32": dict(B=8, S=256, Hq=4, Hkv=4, D=32),
    "rg_d256": dict(B=2, S=4096, Hq=10, Hkv=1, D=256, window=2048),
}


def f32_step_rows(torch, dev, shape):
    """B1 and B2's CUDA-core instances at one float32 call (causal, window
    ``shape.get("window")``): held to the plain backward at 1e-4 (each run
    twice, bitwise), then each timed beside its float32 bound, the plain
    backward and SDPA's whole float32 backward; A's CUDA-core instance at
    the same call, held to the plain forward at 1e-4 (bitwise on a second
    run) and timed beside its float32 bound, the plain forward and SDPA's
    float32 forward.  Times are CUDA-event medians (``ms``) and, for the
    kernels and SDPA, the kernels' device time (``device_ms``,
    ``library_device_ms``), which leaves out the host's time between
    launches.  Returns the rows "dq", "dkv" and "fwd"."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block
    from repro_torch.kernels.ref import visibility_mask

    B, S, Hq, Hkv, D = (shape[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    window = shape.get("window")
    gen = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape_):
        return torch.randn(shape_, generator=gen, device=dev)

    q, dout, k, v = rnd(B, S, Hq, D), rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    dlse = rnd(B, S, Hq)
    qp = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    got, want, args, kw = run_bwd(torch, q, k, v, qp, qp, dout, dlse, True, window)
    inst = fa.flash_bwd_instance_built(torch.float32, D)
    label = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} f32 causal" + (
        f" window={window}" if window else "")
    err, _ = compare_grads(torch, f"B1/B2 f32 call {label} [{inst}]", got, want,
                           atol=1e-4, rtol=1e-4,
                           dead=dead_masks(torch, args[6], qp, qp, True, window))
    blk = pick_block(S, 512)
    out = fa.flash_attention_fwd_torch(q, k, v, qp, qp, causal=True, window=window,
                                       scale=kw["scale"], block_k=blk)[0]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    if window:  # SDPA's yardstick with the window as a boolean mask
        mask = visibility_mask(qp, qp, causal=True, window=window)[:, None]
        o_t = F.scaled_dot_product_attention(qt, kt.repeat_interleave(Hq // Hkv, dim=1),
                                             vt.repeat_interleave(Hq // Hkv, dim=1),
                                             attn_mask=mask)
    else:
        o_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    big = D == 256  # phase 20 (b)'s call: fewer repeats of the slow plain version
    dq_fn = lambda: fa.flash_attention_bwd_dq_cuda(*args, **kw)  # noqa: E731
    dkv_fn = lambda: fa.flash_attention_bwd_dkv_cuda(*args, **kw)  # noqa: E731
    lib_fn = lambda: torch.autograd.grad(o_t, (qt, kt, vt), dout.transpose(1, 2),  # noqa: E731
                                         retain_graph=True)
    ms_dq, ms_dkv, plain_ms, lib_ms = (time_ms(f, iters=it, reps=3) for f, it in (
        (dq_fn, 5), (dkv_fn, 5),
        (lambda: fa.flash_attention_bwd_torch(q, k, v, qp, qp, out, args[6], dout, dlse,
                                              causal=True, window=window, scale=kw["scale"],
                                              block_q=blk, block_k=blk), 1),
        (lib_fn, 2 if big else 5)))
    (dev_dq, dev_dkv, dev_lib), how = device_times((dq_fn, 5 if big else 30),
                                                   (dkv_fn, 5 if big else 30),
                                                   (lib_fn, 2 if big else 10))
    rows = {}
    for name, ms, dms, per_pair, outs in (("dq", ms_dq, dev_dq, 6, got[:1]),
                                          ("dkv", ms_dkv, dev_dkv, 8, got[1:])):
        nbytes, flops = bwd_bytes_flops(q, k, qp, qp, True, window, per_pair, outs)
        bms, by = bound(nbytes, flops, "float32")
        rows[name] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=lib_ms,
                          library_device_ms=dev_lib, bound_ms=bms, bound_by=by,
                          max_abs_err=err, instance=inst, shape=label, timing=how,
                          plain_and_library_compute="dq, dk and dv in one call",
                          device_kernel=f"rt::core::flash_bwd_{name}_core_kernel<float, {D}>")
        log(f"  B {name} {label} [{inst}]: kernel {ms:.4f} ms (device {dms:.4f}), bound "
            f"{bms:.4f} ms ({by}, 67 TFLOP/s float32; {ms / bms:.2f}x), "
            f"{flops / ms / 1e9:.2f} TFLOP/s; plain backward {plain_ms:.3f} ms, sdpa f32 "
            f"backward {lib_ms:.3f} ms (device {dev_lib:.4f})")
    del o_t, qt, kt, vt
    fwd = lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, qp, causal=True,  # noqa: E731
                                              window=window, scale=kw["scale"])
    finst = fa.flash_fwd_instance_built(torch.float32, S, D)
    first = fwd()
    if not all(torch.equal(x, y) for x, y in zip(first, fwd())):
        raise AssertionError(f"A f32 call {label}: two runs on the same inputs differ")
    f_err = compare(f"A f32 call {label} [{finst}] bitwise repeatable", first,
                    fa.flash_attention_fwd_torch(q, k, v, qp, qp, causal=True, window=window,
                                                 scale=kw["scale"], block_k=blk),
                    **tolerances(torch.float32))
    if window:
        lib = sdpa_masked(torch, q, k, v, qp, qp, window)
    else:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    ms, plain_ms, lib_ms = (time_ms(f, iters=it, reps=3) for f, it in (
        (fwd, 5),
        (lambda: fa.flash_attention_fwd_torch(q, k, v, qp, qp, causal=True, window=window,
                                              scale=kw["scale"], block_k=blk), 1),
        (lib, 5)))
    (dms, dev_lib), how = device_times((fwd, 10 if big else 30), (lib, 5 if big else 30))
    nbytes, flops = flash_bytes_flops(q, k, qp, qp, True, window)
    bms, by = bound(nbytes, flops, "float32")
    rows["fwd"] = dict(ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=dev_lib, bound_ms=bms, bound_by=by,
                       max_abs_err=f_err, instance=finst, shape=label, timing=how,
                       device_kernel=f"rt::core::flash_fwd_core_kernel<float, {D}>")
    log(f"  A {label} [{finst}]: kernel {ms:.4f} ms (device {dms:.4f}), bound {bms:.4f} ms "
        f"({by}, 67 TFLOP/s float32; {ms / bms:.2f}x), {flops / ms / 1e9:.2f} TFLOP/s; plain "
        f"forward {plain_ms:.3f} ms, sdpa f32 forward {lib_ms:.4f} ms (device {dev_lib:.4f})")
    return rows


# The CUDA-core instances at their tiles' edges (`core_fwd_tiling`,
# `core_dq_tiling`, `core_dkv_tiling`), phases 3 and 7: id, (B, Sq, Sk, Hq,
# Hkv, D), dtype, layout, window; all causal.  101 and 109 are multiples of
# no tile (with queries 8 positions past the keys); a window of 20 is
# shorter than any key tile; recurrentgemma's GQA group 10 at D 256; bf16 at
# D 32, the only bf16 instance, widened on load.
CORE_EDGE_CASES = [case for D in (32, 64, 128, 256) for case in (
    (f"ragged D={D}", (2, 101, 109, 4, 2, D), "f32", "offset", None),
    (f"window=20 D={D}", (1, 256, 256, 2, 2, D), "f32", "contig", 20),
)] + [
    ("g10 D=256 window=100", (1, 300, 300, 10, 1, 256), "f32", "contig", 100),
    ("g10 D=256 ragged window=48", (2, 101, 109, 10, 1, 256), "f32", "offset", 48),
    ("bf16 ragged D=32", (2, 101, 109, 4, 2, 32), "bf16", "offset", None),
    ("bf16 window=20 D=32", (1, 256, 256, 2, 2, 32), "bf16", "contig", 20),
    ("bf16 dead rows D=32", (2, 256, 256, 4, 1, 32), "bf16", "dead", None),
]


def core_edge_inputs(torch, dev, case):
    """``(label, (q, k, v, q_pos, k_pos, dout, dlse), window)`` of one
    ``CORE_EDGE_CASES`` entry, from a generator seeded by the case."""
    case_id, (B, Sq, Sk, Hq, Hkv, D), dt, layout, window = case
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    gen = torch.Generator(device=dev).manual_seed(9 + CORE_EDGE_CASES.index(case))

    def rnd(shape, dtype=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, dout = (rnd(s) for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                                       (B, Sq, Hq, D)))
    qp, kp = bwd_positions(torch, dev, B, Sq, Sk, layout)
    return (f"{case_id} {(B, Sq, Sk, Hq, Hkv, D)}", (q, k, v, qp, kp, dout,
                                                     rnd((B, Sq, Hq), torch.float32)), window)


def phase_bwd_core_edges(torch, dev):
    """B1 and B2 on ``CORE_EDGE_CASES``, each run twice and required
    bitwise equal, against the plain backward at phase 7's float32 limit:
    the bf16 cases too, which both sides widen to float32 on load."""
    from repro_torch.kernels import flash_attention as fa

    for case in CORE_EDGE_CASES:
        label, (q, k, v, qp, kp, dout, dlse), window = core_edge_inputs(torch, dev, case)
        got, want, args, _ = run_bwd(torch, q, k, v, qp, kp, dout, dlse, True, window)
        inst = fa.flash_bwd_instance_built(q.dtype, q.shape[-1])
        compare_grads(torch, f"B1/B2 core edge {label} [{inst}]", got, want, atol=1e-4,
                      rtol=1e-4, dead=dead_masks(torch, args[6], qp, kp, True, window))


def phase_bwd(torch, dev, train_shape=TRAIN_SHAPE):
    from repro_torch.kernels import flash_attention as fa

    # each line names the instance the built library picks; the host's copy
    # of that rule (used where no library is built) must agree with it
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128, 256):
            built, host = fa.flash_bwd_instance_built(dtype, D), fa.flash_bwd_instance(dtype, D)
            if built != host:
                raise AssertionError(f"B1/B2 {dtype} D={D}: the library takes the {built} "
                                     f"instance, flash_bwd_instance says {host}")
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # float32: both sides sum float32 products of the same inputs, only in
    # another order, so 1e-4 absolute plus 1e-4 relative holds.
    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window in BWD_CASES:
        qp, kp = bwd_positions(torch, dev, B, Sq, Sk, layout)
        q, dout = rnd((B, Sq, Hq, D)), rnd((B, Sq, Hq, D))
        k, v = rnd((B, Sk, Hkv, D)), rnd((B, Sk, Hkv, D))
        dlse = rnd((B, Sq, Hq))  # the TokenRing partial's lse cotangent
        got, want, args, _ = run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window)
        inst = fa.flash_bwd_instance_built(q.dtype, D)
        compare_grads(torch, f"B1/B2 f32 {case_id} {(B, Sq, Sk, Hq, Hkv, D)} [{inst}]", got,
                      want, atol=1e-4, rtol=1e-4,
                      dead=dead_masks(torch, args[6], qp, kp, causal, window))

    rows = {"qwen3-1.7b": training_shape_rows(torch, dev, rnd, train_shape)}
    # qwen3-moe-30b-a3b's attention (32/4 heads), the main path's training
    # shape; a generator of its own keeps the data above as it was
    gen_moe = torch.Generator(device=dev).manual_seed(4)
    rows["qwen3-moe-30b-a3b"] = training_shape_rows(
        torch, dev, lambda shape, dtype=torch.float32: torch.randn(
            shape, generator=gen_moe, device=dev).to(dtype), MOE_TRAIN_SHAPE)
    gen_w = torch.Generator(device=dev).manual_seed(6)
    rows["whisper-base"] = {
        name: training_shape_rows(torch, dev, lambda shape, dtype=torch.float32: torch.randn(
            shape, generator=gen_w, device=dev).to(dtype), shape)
        for name, shape in WHISPER_TRAIN_SHAPES.items()}
    phase_bwd_bf16(torch, dev)
    phase_bwd_core_edges(torch, dev)
    rows["f32_step"] = {name: f32_step_rows(torch, dev, shape)
                        for name, shape in F32_CORE_CALLS.items()}
    return rows


def phase_bwd_bf16(torch, dev, cases=BWD_BF16_CASES):
    """B1 and B2 in bf16 against the plain backward (inputs widened from
    the same bf16 values) on the wgmma instances' edge cases, each run twice
    and required bitwise equal.  A generator of their own keeps the other
    cases' data as it was."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def rnd(shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window in cases:
        qp, kp = bwd_positions(torch, dev, B, Sq, Sk, layout)
        q, dout = rnd((B, Sq, Hq, D)), rnd((B, Sq, Hq, D))
        k, v = rnd((B, Sk, Hkv, D)), rnd((B, Sk, Hkv, D))
        dlse = rnd((B, Sq, Hq), torch.float32)
        got, want, args, _ = run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window)
        inst = fa.flash_bwd_instance_built(bf, D)
        label = f"{case_id} window={window}" if window else case_id
        compare_grads(torch, f"B1/B2 bf16 {label} {(B, Sq, Sk, Hq, Hkv, D)} [{inst}]", got,
                      want, dead=dead_masks(torch, args[6], qp, kp, causal, window),
                      **BWD_BF16_LIMIT)


# ---------------------------------------------------------------------------
# phases 8 and 9: training
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix=""):
    """``(name, tensor)`` in ``optim.adamw.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in named_leaves(tree[key], f"{prefix}.{key}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree) for x in named_leaves(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


TRAIN_KERNELS = {"flash_attention_fwd": "flash_attention_fwd_cuda",
                 "flash_attention_bwd_dq": "flash_attention_bwd_dq_cuda",
                 "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_cuda"}


def launch_counts():
    from repro_torch.kernels import flash_attention as fa

    return {name: getattr(fa, fn).launches for name, fn in TRAIN_KERNELS.items()}


def reset_launch_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    for fn in TRAIN_KERNELS.values():
        getattr(fa, fn).launches = 0
    pa.paged_decode_fwd_cuda.launches = 0


def attention_calls(cfg) -> int:
    """Attention calls of one forward: one a layer; an encoder-decoder's
    encoder layers one each, its decoder layers two (self and cross); none
    in an attention-free SSM; one a superblock in the hybrid."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":  # one local-attention layer a (rec, rec, attn) period
        return cfg.n_layers // (len(cfg.block_pattern) or 3)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def train_launches_per_step(cfg, computes: int = 1):
    """remat "full" and "dots" run A in the forward and again in each
    block's recompute; B1 and B2 once per attention call.  ``computes``:
    flash calls of one attention call (the ring schedule's Compute count; 1
    at SP 1)."""
    L = attention_calls(cfg) * computes
    return {"flash_attention_fwd": (2 if cfg.remat in ("full", "dots") else 1) * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L}


class FramesData:
    """The synthetic token stream (``data.synthetic``) with seeded frame
    embeddings ``(B, enc_seq, d_model)`` added to each batch: an
    encoder-decoder's training data (the train CLI has no frames source)."""

    def __init__(self, cfg, data_cfg):
        from repro_torch.data.synthetic import SyntheticDataset

        self.shape = (cfg.enc_seq, cfg.d_model)
        self.tokens = SyntheticDataset(data_cfg)

    def __iter__(self):
        return self

    def __next__(self):
        import numpy as np

        rng = np.random.default_rng((self.tokens.cfg.seed, self.tokens.step, 17))
        batch = next(self.tokens)
        batch["frames"] = rng.standard_normal((batch["tokens"].shape[0], *self.shape),
                                              dtype=np.float32)
        return batch


def train_data(cfg, data_cfg):
    """The training stream of ``cfg``: tokens, plus frames for an
    encoder-decoder."""
    from repro_torch.data.synthetic import SyntheticDataset

    return FramesData(cfg, data_cfg) if cfg.family == "encdec" else SyntheticDataset(data_cfg)


def kernels_vs_plain_step(torch, dev, cfg, B, S, **pctx_kw):
    """One loss-and-gradient step of ``cfg`` on the kernels and one on the
    plain path, from the same parameters and batch (``pctx_kw``: the SP
    degree and strategy of both).  Returns both losses, gradients and
    parameters, and the kernel launches of the first."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.trainer import batch_to_device

    kern = build_model(cfg, ParallelContext(device="cuda", **pctx_kw))
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda", **pctx_kw))
    P = kern.pctx.sp_degree
    computes = sp_computes(cfg, kern.pctx.strategy, P)
    p_kern = kern.init(0, training=True)
    p_plain = tree_map(lambda t: t.detach().clone(), p_kern)
    batch = batch_to_device(next(train_data(cfg, SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1, layout=cfg.layout,
        sp_degree=P))), dev)
    before = launch_counts()
    (l_kern, _), g_kern = value_and_grad(kern.loss, p_kern, batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    if ran != train_launches_per_step(cfg, computes):
        raise AssertionError(f"phase 8: kernel launches {ran}, expected "
                             f"{train_launches_per_step(cfg, computes)}")
    before = launch_counts()
    (l_plain, _), g_plain = value_and_grad(plain.loss, p_plain, batch)
    if launch_counts() != before:
        raise AssertionError("phase 8: the plain path launched a kernel")
    return l_kern, l_plain, g_kern, g_plain, p_kern, p_plain, ran


def worst_leaf(torch, g_kern, g_plain, limit):
    """Largest ``max|kernel - plain| / max|plain|`` over the gradient leaves;
    raises if a leaf is not finite or is above ``limit``."""
    worst = 0.0
    for (name, a), (_, b) in zip(named_leaves(g_kern), named_leaves(g_plain)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not (torch.isfinite(a).all() and rel <= limit):
            raise AssertionError(f"phase 8: gradient {name} off by {rel:.3e} of its max")
        worst = max(worst, rel)
    return worst


def phase_train_checked(torch, dev, cfg=None, B=2, S=512, label="phase 8", **pctx_kw):
    """One step at qwen3-1.7b widths, 2 layers, float32: kernels vs plain
    (``pctx_kw``: the SP degree and strategy of both sides)."""
    from repro_torch.configs import ARCHS
    from repro_torch.optim.adamw import adamw_init, adamw_update

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    l_kern, l_plain, g_kern, g_plain, p_kern, p_plain, ran = kernels_vs_plain_step(
        torch, dev, cfg, B, S, **pctx_kw)
    # Everything but attention runs the same float32 ops on both sides, and
    # attention differs only in the order of float32 sums: the loss is held
    # to 1e-5 relative, each gradient leaf to 1e-4 of its largest |value|.
    l_err = abs(float(l_kern) - float(l_plain))
    if not (math.isfinite(float(l_kern)) and l_err <= 1e-5 * abs(float(l_plain))):
        raise AssertionError(f"phase 8: loss {float(l_kern)} vs plain {float(l_plain)}")
    worst = worst_leaf(torch, g_kern, g_plain, 1e-4)
    # One AdamW step each.  A first Adam step moves each element by about
    # lr * sign(gradient), so an element whose gradient is within the error
    # above of 0 may step up to 2*lr apart on the two sides: every element is
    # held to 2*lr.  An element whose gradient is at least 1e-2 of its leaf's
    # largest (100x the gradient limit, so its sign is certain) is held to
    # 0.05*lr.
    lr = 1e-5
    adamw_update(g_kern, adamw_init(p_kern), p_kern, lr=lr)
    adamw_update(g_plain, adamw_init(p_plain), p_plain, lr=lr)
    p_err = sure_err = 0.0
    n_apart = 0
    for (name, a), (_, b), (_, g) in zip(named_leaves(p_kern), named_leaves(p_plain),
                                         named_leaves(g_plain)):
        d = (a.detach() - b.detach()).abs()
        sure = g.abs() >= 1e-2 * g.abs().max()
        d_sure = float(d[sure].max()) if sure.any() else 0.0
        if float(d.max()) > 2 * lr or d_sure > 0.05 * lr:
            raise AssertionError(f"phase 8: parameter {name} after AdamW off by "
                                 f"{float(d.max()):.3e} ({d_sure:.3e} where the gradient is sure)")
        p_err, sure_err = max(p_err, float(d.max())), max(sure_err, d_sure)
        n_apart += int((d > 0.05 * lr).sum())
    log(f"  ok {label}: loss {float(l_kern):.6f} vs plain {float(l_plain):.6f} (|err| "
        f"{l_err:.2e}); worst gradient leaf off by {worst:.2e} of its max; parameters after "
        f"AdamW (lr {lr}) within {p_err:.2e} ({sure_err:.2e} where the gradient is sure), "
        f"{n_apart} elements apart by more than 0.05*lr; launches {ran}")


def phase_train_checked_bf16(torch, dev, cfg=None, B=2, S=512):
    """One step at qwen3-1.7b widths, 2 layers, bf16 compute (float32
    parameters): kernel A's wgmma instance feeds B1/B2 on the training path;
    loss and gradients against the plain path."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2)
    inst = fa.flash_fwd_instance(torch.bfloat16, S, cfg.d_head)
    l_kern, l_plain, g_kern, g_plain, _, _, ran = kernels_vs_plain_step(torch, dev, cfg, B, S)
    # The two sides differ only in attention's forward: the wgmma instance
    # rounds P to bf16 for its P V product (2^-9 relative per term) where the
    # plain version multiplies float32 P, and sums in another order; both
    # round out to bf16, so out can land one bf16 step (2^-8 relative)
    # apart.  Every product around attention runs in bf16 on both sides and
    # carries such a flip on into the gradients, and the q/k-norm scales'
    # gradients (sums over every token and head) lose most to cancellation.
    # A CPU emulation of the instance's rounding
    # (tests/test_torch_flash_fwd_numerics.py) in this 2-layer step at d 512
    # and d 1024 put the loss 4e-6 and 1e-5 apart (relative) and the worst
    # leaf 1.0e-2 and 1.5e-2 of its largest value.  Limits: loss 1e-4
    # relative, every gradient leaf 5e-2 of its largest |value|.
    l_err = abs(float(l_kern) - float(l_plain))
    if not (math.isfinite(float(l_kern)) and l_err <= 1e-4 * abs(float(l_plain))):
        raise AssertionError(f"phase 8 bf16: loss {float(l_kern)} vs plain {float(l_plain)}")
    worst = worst_leaf(torch, g_kern, g_plain, 5e-2)
    log(f"  ok phase 8 bf16 [{inst}]: loss {float(l_kern):.6f} vs plain {float(l_plain):.6f} "
        f"(|err| {l_err:.2e}); worst gradient leaf off by {worst:.2e} of its max; "
        f"launches {ran}")


def profile_step(torch, fn, wall_s, cpu=True):
    """``fn`` once under torch.profiler: device busy share and the kernels
    that take the most device time (``cpu=False``: the device's activity
    only, whose events take seconds, not tens, to sum)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profiled step: wall {prof_wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / prof_wall:.1f}%); against the unprofiled step {wall_s:.3f} s: busy "
        f"{100 * busy_s / wall_s:.1f}%, idle {100 * (1 - busy_s / wall_s):.1f}%")
    for us, count, key in rows[:12]:
        log(f"    {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} {key[:90]}")
    return {"wall_s": prof_wall, "device_busy_s": busy_s, "unprofiled_wall_s": wall_s,
            "top": [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in rows[:12]],
            "port_kernels": port_kernel_rows(rows, busy_s)}


def phase_train_full(torch, dev, with_profile, cfg=None, B=2, S=4096, steps=3,
                     result="training"):
    """The training path: qwen3-1.7b (or ``cfg``) at full width through the
    Trainer, one warmup step and ``steps`` timed steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, n_params

    cfg = cfg or ARCHS["qwen3-1.7b"]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    trainer = Trainer(bundle, TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=1 + steps))
    data = train_data(cfg, SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                           global_batch=B, seed=0, layout=cfg.layout,
                                           sp_degree=bundle.pctx.sp_degree))
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params(state['params']) / 1e9:.3f}B "
        f"parameters in {cfg.param_dtype}, compute {cfg.dtype}, remat {cfg.remat}; batch {B} x "
        f"seq {S}; seeded init {time.perf_counter() - t0:.1f} s")
    step_log = lambda m: log("  " + m)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    peak_first = torch.cuda.max_memory_allocated()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, timed = trainer.run(state, data, steps=1 + steps, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    want = {k: v * steps for k, v in train_launches_per_step(cfg).items()}
    if got != want:
        raise AssertionError(f"training path: launches {got} over {steps} steps, expected {want}")
    losses = hist + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training path: losses {losses}")
    step_s = trainer.step_seconds[1:]
    med = statistics.median(step_s)
    res = {"arch": cfg.name, "batch": B, "seq": S, "steps_timed": steps, "step_s": step_s,
           "median_step_s": med, "tokens_per_s": B * S / med,
           "first_step_s": trainer.step_seconds[0], "losses": losses,
           "peak_bytes_timed_steps": peak, "peak_bytes_first_step": peak_first,
           "launches": got}
    log(f"  timed steps {[round(x, 4) for x in step_s]} s: median {med:.4f} s = "
        f"{B * S / med:.1f} tok/s; losses {[round(x, 4) for x in losses]}; peak memory "
        f"{peak / 2**30:.2f} GiB (first step {peak_first / 2**30:.2f} GiB); launches {got}")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: trainer.run(
            state, data, steps=2 + steps, log=lambda m: None), med)
    RESULTS[result] = res
    log(f"RESULT {result} " + json.dumps(res))
    return got


# ---------------------------------------------------------------------------
# phases 10 and 11: the ring (TokenRing and the ring baselines) on the
# virtual ring of P ranks folded into the batch dimension of one card
# ---------------------------------------------------------------------------

RING_VARIANTS = [  # (label, strategy, travel dtype of TokenRing's accumulator)
    ("tokenring", "tokenring", "float32"),
    ("tokenring travel bf16", "tokenring", "bfloat16"),
    ("tokenring_faithful", "tokenring_faithful", "float32"),
    ("ring", "ring", "float32"),
    ("ring_bidir", "ring_bidir", "float32"),
]
RING_HEADS = (16, 8, 128)  # qwen3-1.7b attention: Hq, Hkv, D
RING_S_LOC = {"bfloat16": 1024, "float32": 512}  # local rows a rank (bidir halves: 512, 256)


def ring_computes(strategy, P, pods=1):
    """Flash calls of one pass of the strategy's schedule at ring size P;
    with ``pods`` > 1 the hybrid's: ``pods`` outer steps, each a pass of
    ``strategy`` over the ``P // pods`` ranks of a pod.  Ulysses and the
    window halo make one flash call a pass."""
    from repro_torch.core.strategies import get_strategy

    if pods > 1:
        return pods * ring_computes(strategy, P // pods)
    if strategy in ("ulysses", "window"):
        return 1
    sched = get_strategy(strategy).schedule_spec(P).schedule
    return sum(len(st.computes) for st in sched.all_steps())


def sp_computes(cfg, strategy, P, pods=1):
    """Flash calls of one attention call of ``cfg`` at SP ``P``: 1 at SP 1;
    a windowed config's layers resolve to the window halo (one call, on
    one or two axes); the rest run ``strategy``'s schedule."""
    if P == 1 or cfg.window:
        return 1
    return ring_computes(strategy, P, pods)


def ring_positions(torch, dev, B, S, P):
    from repro_torch.core.zigzag import zigzag_positions

    pos = torch.cat([zigzag_positions(S, P, j, device=dev) for j in range(P)])
    return pos.expand(B, S).contiguous()


def ring_run(torch, strategy, travel, P, impl, overlap, q, k, v, pos, w, wl):
    """One ring forward ``(out, lse)`` on global tensors (the strategy's
    per-rank callable on the ranks folded into the batch dimension) and the
    gradients of ``sum(out*w) + sum(lse*wl)`` (live rows) for q, k and v.
    Returns them with the ring's forward link and position bytes."""
    from repro_torch.core.collectives import VirtualRing, fold_ranks, unfold_ranks
    from repro_torch.core.strategies import get_strategy

    ring = VirtualRing(P, q.device)
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fq, fk, fv, fp = (fold_ranks(x, P) for x in (*xs, pos))
    extra = {"travel_dtype": travel} if strategy == "tokenring" else {}
    out, lse = get_strategy(strategy).fn(fq, fk, fv, fp, fp, ring=ring, causal=True, impl=impl,
                                         overlap=overlap, return_lse=True, **extra)
    out, lse = unfold_ranks(out, P), unfold_ranks(lse, P)
    sent = (dict(ring.link_bytes), dict(ring.position_bytes))
    live = torch.where(torch.isneginf(lse), 0.0, lse)
    grads = torch.autograd.grad((out.float() * w).sum() + (live * wl).sum(), xs)
    return out.detach(), lse.detach(), grads, sent


def ring_inputs(torch, dev, gen, B, S, dtype):
    Hq, Hkv, D = RING_HEADS

    def rnd(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    return (rnd((B, S, Hq, D)), rnd((B, S, Hkv, D)), rnd((B, S, Hkv, D)),
            rnd((B, S, Hq, D), torch.float32), rnd((B, S, Hq), torch.float32))


class EachCall:
    """Inside a ring run on the kernels, hold every flash call against the
    plain version on the same inputs: kernel A's ``(out, lse)`` at phase
    3's limits, B1/B2's float32 ``(dq, dk, dv)`` at phase 7's (per row and
    per tensor in bf16, 1e-4 in float32; rows that see no key and keys that
    no query sees exactly 0).  These are the calls that pair one rank's
    query block with another rank's keys (Sq != Sk, whole blocks masked).
    Keeps the count and the worst readings."""

    def __init__(self, torch, name):
        self.torch, self.name = torch, name
        self.calls = {"fwd": 0, "bwd": 0}
        self.out_err = self.row = self.l2 = 0.0
        self.dead = 0

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.fwd, self.bwd = ops, ops._flash_fwd, ops._flash_bwd
        ops._flash_fwd, ops._flash_bwd = self._fwd, self._bwd
        return self

    def __exit__(self, *exc):
        self.ops._flash_fwd, self.ops._flash_bwd = self.fwd, self.bwd

    def _fwd(self, cfg, q, k, v, qp, kp):
        import dataclasses

        got = self.fwd(cfg, q, k, v, qp, kp)
        if cfg.resolve_impl(q.device) == "cuda":
            want = self.fwd(dataclasses.replace(cfg, impl="torch"), q, k, v, qp, kp)
            err = compare(f"{self.name} A call {self.calls['fwd']}", got, want,
                          **tolerances(q.dtype), quiet=True)
            self.out_err = max(self.out_err, err)
            self.calls["fwd"] += 1
        return got

    def _bwd(self, cfg, q, k, v, qp, kp, out, lse, dout, dlse):
        import dataclasses

        got = self.bwd(cfg, q, k, v, qp, kp, out, lse, dout, dlse)
        if cfg.resolve_impl(q.device) == "cuda":
            want = self.bwd(dataclasses.replace(cfg, impl="torch"), q, k, v, qp, kp, out, lse,
                            dout, dlse)
            limit = (BWD_BF16_LIMIT if q.dtype == self.torch.bfloat16
                     else dict(atol=1e-4, rtol=1e-4))
            dead = dead_masks(self.torch, lse, qp, kp, cfg.causal, cfg.window)
            _, pairs = compare_grads(self.torch, f"{self.name} B1/B2 call {self.calls['bwd']}",
                                     got, want, dead=dead, quiet=True, **limit)
            self.row = max([self.row] + [r for r, _ in pairs])
            self.l2 = max([self.l2] + [x for _, x in pairs])
            self.dead += int(dead[0].sum())
            self.calls["bwd"] += 1
        return got


def phase_ring(torch, dev, ps=(2, 4, 8), s_loc=RING_S_LOC, profile_shape=TRAIN_SHAPE):
    """Every ported strategy on the virtual ring, kernels against the same
    ring on the plain versions on the card; then the overlap trace.

    Limits.  Every kernel call inside the ring is held to phase 3's and
    phase 7's limits (:class:`EachCall`).  The ring's own forward (out, lse)
    is held to phase 3's limits, those of bf16 where the inputs or the
    travelling accumulator are bf16 (the accumulator is rounded to bf16 at
    every merge).  Its gradients: float32 within 1e-4 absolute plus 1e-4
    relative elementwise; bf16 (inputs or accumulator) within phase 7's
    per-tensor limit, ||err|| <= 5e-3 ||plain||, and not per row: the
    gradients of bf16 inputs are stored in bf16 (the flash Function returns
    them in the input's type, as the reference's VJP does) and summed over
    the P blocks in bf16, so one bf16 rounding of a large block term in a
    row whose sum nearly cancels is large against that row's final RMS.
    The phase logs the same per-row reading for one SP-1 flash call with
    bf16 gradients, which shows it too (PERF.md has the readings).
    """
    from repro_torch.analysis.comm_audit import AuditDims, audit_schedule
    from repro_torch.core.strategies import get_strategy, itemsize, strategy_cost
    from repro_torch.kernels.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(10)
    Hq, Hkv, D = RING_HEADS
    B = 1
    checked, worst = 0, {"calls_row": 0.0, "calls_l2": 0.0, "ring_l2_bf16": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for P in ps:
            S = s_loc[dname] * P
            pos = ring_positions(torch, dev, B, S, P)
            q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, dtype)
            for label, strategy, travel in RING_VARIANTS:
                name = f"ring {label} P={P} {dname} (B={B} S={S} S_loc={S // P})"
                n = ring_computes(strategy, P)
                reset_launch_counts()
                got = ring_run(torch, strategy, travel, P, "cuda", True, q, k, v, pos, w, wl)
                torch.cuda.synchronize()
                ran = launch_counts()
                want_launches = {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
                                 "flash_attention_bwd_dkv": n}
                if ran != want_launches:
                    raise AssertionError(f"{name}: launches {ran}, expected {want_launches} "
                                         f"(the schedule's {n} Computes)")
                with EachCall(torch, name) as each:
                    seq = ring_run(torch, strategy, travel, P, "cuda", False, q, k, v, pos, w,
                                   wl)
                if each.calls != {"fwd": n, "bwd": n}:
                    raise AssertionError(f"{name}: checked calls {each.calls}, expected {n}")
                for what, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                      (got[0], got[1], *got[2]), (seq[0], seq[1], *seq[2])):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: overlap=True and overlap=False differ "
                                             f"in {what}")
                plain = ring_run(torch, strategy, travel, P, "torch", True, q, k, v, pos, w, wl)
                # the ring is as precise as its least precise arithmetic: a
                # float32 ring whose accumulator travels in bf16 takes bf16 limits
                least = torch.bfloat16 if travel == "bfloat16" else dtype
                err = compare(f"{name} forward", got[:2], plain[:2], **tolerances(least),
                              quiet=True)
                grads = [g.float() for g in got[2]], [g.float() for g in plain[2]]
                if least == torch.float32:
                    _, pairs = compare_grads(torch, name, *grads, atol=1e-4, rtol=1e-4,
                                             quiet=True)
                else:
                    _, pairs = compare_grads(torch, name, *grads, l2=BWD_BF16_LIMIT["l2"],
                                             elementwise=False, quiet=True)
                    worst["ring_l2_bf16"] = max([worst["ring_l2_bf16"]] + [x for _, x in pairs])
                worst["calls_row"] = max(worst["calls_row"], each.row)
                worst["calls_l2"] = max(worst["calls_l2"], each.l2)
                (link, pos_bytes) = got[3]
                cost = strategy_cost(get_strategy(strategy), B, S, Hq, Hkv, D, P,
                                     bytes_per_elem=q.element_size(), travel_dtype=travel)
                model = {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}
                spec = get_strategy(strategy).schedule_spec(P, S_loc=S // P)
                audited = audit_schedule(spec, P, AuditDims(
                    B=B, S_loc=S // P, Hq=Hq, Hkv=Hkv, D=D, bytes_per_elem=q.element_size(),
                    travel_bytes=itemsize(travel)))
                audited = {"fwd": audited[0], "bwd": audited[1]}
                if audited != model:
                    raise AssertionError(f"{name}: comm_audit {audited}, cost model {model}")
                if strategy == "tokenring_faithful" and dtype != torch.float32:
                    bytes_note = ("link bytes not compared: the model and comm_audit price the "
                                  "partial at float32, it travels in bf16; comm_audit = cost "
                                  "model")
                elif link != model:
                    raise AssertionError(f"{name}: link bytes {link}, cost model and comm_audit "
                                         f"{cost.fwd_bytes}/{cost.bwd_bytes}")
                else:
                    bytes_note = (f"link bytes {link['fwd']:.0f}/{link['bwd']:.0f} = cost model "
                                  "= comm_audit")
                log(f"  ok {name}: launches {n}/{n}/{n} = Computes; {n}+{n} kernel calls vs "
                    f"plain (worst out {each.out_err:.2e}, grads row {each.row:.2e} / l2 "
                    f"{each.l2:.2e}, {each.dead} dead (row, head) exactly 0); ring vs plain ring:"
                    f" out {err:.2e}, grads row/l2 "
                    f"{' '.join(f'{r:.2e}/{x:.2e}' for r, x in pairs)}; overlap True/False "
                    f"bitwise equal; {bytes_note}, position bytes {pos_bytes['fwd']:.0f}/"
                    f"{pos_bytes['bwd']:.0f} apart")
                checked += 1
    log(f"  {checked} ring cases passed; worst kernel call: grads {worst['calls_row']:.2e} of "
        f"the row RMS, {worst['calls_l2']:.2e} relative L2; worst bf16 ring gradient "
        f"{worst['ring_l2_bf16']:.2e} relative L2")
    # the per-row reading of one SP-1 flash call whose gradients come back in
    # bf16 (the input's type), for comparison with the rings' (logged only)
    S = s_loc["bfloat16"] * 2
    qp = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, torch.bfloat16)
    sp1 = {}
    for impl in ("cuda", "torch"):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out, lse = flash_attention(*xs, q_pos=qp, k_pos=qp, causal=True, impl=impl)
        sp1[impl] = [g.float() for g in torch.autograd.grad(
            (out.float() * w).sum() + (lse * wl).sum(), xs)]
    _, pairs = compare_grads(torch, "SP-1 flash, bf16 gradients", sp1["cuda"], sp1["torch"],
                             l2=BWD_BF16_LIMIT["l2"], elementwise=False, quiet=True)
    worst["sp1_bf16_grads_row_l2"] = pairs
    log(f"  one SP-1 flash call (B={B} S={S}, bf16, causal), gradients in bf16, kernels vs "
        f"plain: row/l2 {' '.join(f'{r:.2e}/{x:.2e}' for r, x in pairs)}")
    return {**ring_overlap_trace(torch, dev, gen, **profile_shape), "worst": worst,
            "cases": checked}


def strategy_cases():
    """Phase 10's cases of the other strategies, qwen3-1.7b attention widths:
    bf16 at S_loc 1024 (phase 10's bf16 size), float32 at 512 on a subset
    (the CUDA-core instances); the prefill rings forward only, bf16, P = 4,
    cold (4096 queries and keys) and warm (the last 1024 queries against all
    4096 keys)."""
    out = []
    for dtype, s_loc in (("bfloat16", 1024), ("float32", 512)):
        bf16 = dtype == "bfloat16"
        base = dict(dtype=dtype, s_loc=s_loc, grad=True)
        out += [dict(base, kind="ulysses", P=P, layout="zigzag") for P in
                ((2, 4, 8) if bf16 else (4,))]
        out += [dict(base, kind="window", P=P, layout="contig", window=w)
                for P in ((4, 8) if bf16 else (4,)) for w in ((2048, 48) if bf16 else (48,))]
        for n in (2, 4) if bf16 else (2,):
            out.append(dict(base, kind="tokenring2d", P=2 * n, pods=2, layout="zigzag"))
            out += [dict(base, kind="hybrid", inner=inner, P=2 * n, pods=2, layout="zigzag")
                    for inner in ("tokenring", "ring", "ulysses")]
    for kind, travel in (("passkv_ring", "float32"), ("passq_ring", "float32"),
                         ("passq_ring", "bfloat16")):
        out += [dict(kind=kind, P=4, dtype="bfloat16", s_loc=1024, travel=travel, warm=warm,
                     layout="contig", grad=False) for warm in (False, True)]
    return out


def strategy_label(case):
    bits = [case["kind"] if case["kind"] != "hybrid" else f"hybrid[{case['inner']}]",
            f"P={case['P']}" if case.get("pods", 1) == 1 else f"{case['pods']}x"
            f"{case['P'] // case['pods']}", case["dtype"]]
    if "window" in case:
        bits.append(f"window={case['window']}")
    if case.get("travel", "float32") != "float32":
        bits.append(f"travel {case['travel']}")
    if "warm" in case:
        bits.append("warm" if case["warm"] else "cold")
    return " ".join(bits)


def strategy_inputs(torch, dev, gen, case):
    """q, k, v, positions and the gradient weights of one case (global
    tensors, B = 1; the warm prefill's queries are the context's last
    quarter)."""
    P, dtype = case["P"], getattr(torch, case["dtype"])
    S = case["s_loc"] * P
    q, k, v, w, wl = ring_inputs(torch, dev, gen, 1, S, dtype)
    if case["layout"] == "zigzag":
        pos = ring_positions(torch, dev, 1, S, P)
    else:
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None]
    qpos = pos
    if case.get("warm"):
        q, w, qpos = q[:, -S // 4:].contiguous(), w[:, -S // 4:].contiguous(), pos[:, -S // 4:]
    return q, k, v, qpos, pos, w, wl


def strategy_run(torch, case, impl, overlap, data):
    """One case, planned by its public planner (``plan`` for Ulysses, the
    window and the hybrid; ``plan(topology=two_pods)`` for TokenRing2D;
    ``plan_prefill(strategy=...)`` for the prefill rings) on global
    tensors.  The forward-only prefill rings run through their plan; the
    others run the plan's strategy on the plan's rings with its lse, as
    phase 10's rings do, for the q/k/v gradients of ``sum(out*w) +
    sum(lse*wl)`` (live rows: no query row's gradient is 0 by construction,
    as a row that sees one key has without the lse term).  Returns the
    output, the gradients, the bytes the forward handed the ring and the
    plan."""
    from repro_torch.core.api import AttnShapes, ParallelContext
    from repro_torch.core.collectives import fold_ranks, unfold_ranks
    from repro_torch.core.hybrid import hybrid_sp
    from repro_torch.core.strategies import get_strategy
    from repro_torch.core.topology import two_pods

    q, k, v, qpos, kpos, w, wl = data
    kind, P = case["kind"], case["P"]
    travel = case.get("travel", "float32")
    pctx = ParallelContext(device="cuda", impl=impl, sp_degree=P, pods=case.get("pods", 1),
                           strategy=case.get("inner", kind), layout=case["layout"],
                           overlap=overlap, travel_dtype=travel)
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    shapes = AttnShapes(B=B, Sq=Sq, Hq=Hq, Hkv=k.shape[2], D=D, Sk=Sk,
                        dtype_bytes=q.element_size())
    if kind in ("passkv_ring", "passq_ring"):
        plan = pctx.plan_prefill(strategy=kind, shapes=dataclasses.replace(shapes, Sq=Sk),
                                 prefix_hit_rate=1 - Sq / Sk)
    elif kind == "tokenring2d":
        plan = pctx.plan(shapes, topology=two_pods(P // 2))
    else:
        plan = pctx.plan(shapes, window=case.get("window"))
    want = {"hybrid": (case.get("inner"), case.get("inner"))}.get(kind, (kind, None))
    if (plan.strategy, plan.inner) != want:
        raise AssertionError(f"{strategy_label(case)}: planned {plan.strategy}/{plan.inner}")
    ring = pctx.ring
    xs = [x.detach().clone().requires_grad_(case["grad"]) for x in (q, k, v)]
    ring.reset_counts()
    if not case["grad"]:
        out = plan(*xs, qpos, kpos)
        return out.detach(), (), _sent(ring), plan
    kw = dict(causal=True, impl=impl, overlap=overlap, return_lse=True)
    if kind == "hybrid":
        pod_ring, inner_ring = pctx.axis_rings
        extra = {"travel_dtype": travel} if case["inner"] == "tokenring" else {}
        fn = lambda *a: hybrid_sp(*a, pod_ring=pod_ring, ring=inner_ring,  # noqa: E731
                                  inner=case["inner"], **kw, **extra)
    else:
        rings = pctx.axis_rings if kind == "tokenring2d" else ring
        extra = {"travel_dtype": travel} if kind == "tokenring2d" else {}
        fn = lambda *a: get_strategy(kind).fn(*a, ring=rings,  # noqa: E731
                                              window=case.get("window"), **kw, **extra)
    out, lse = fn(*(fold_ranks(x, P) for x in (*xs, qpos, kpos)))
    out, lse = unfold_ranks(out, P), unfold_ranks(lse, P)
    sent = _sent(ring)
    live = torch.where(torch.isneginf(lse), 0.0, lse)
    grads = torch.autograd.grad((out.float() * w).sum() + (live * wl).sum(), xs)
    return out.detach(), grads, sent, plan


def _sent(ring):
    return {"link": dict(ring.link_bytes),
            "class": {c: dict(d) for c, d in ring.class_bytes.items()},
            "positions": dict(ring.position_bytes), "lse": dict(ring.lse_bytes)}


def phase_strategies(torch, dev):
    """The other strategies (Ulysses, the window halo, the prefill rings,
    TokenRing2D, the multi-pod hybrid) on the virtual ring with phase 10's
    checks: every kernel call held against the plain version at phase 3's
    and phase 7's limits (:class:`EachCall`), the output against the same
    path on the plain versions at phase 3's limits and the gradients at
    phase 10's, ``overlap`` True and False bitwise equal, launches equal to
    the schedule's Computes, and the bytes of one forward pass equal to the
    plan's cost model (per link class for TokenRing2D)."""
    from repro_torch.core.api import AttnShapes, ParallelContext

    gen = torch.Generator(device=dev).manual_seed(11)
    rows, worst = [], {"calls_row": 0.0, "calls_l2": 0.0}
    for case in strategy_cases():
        name = strategy_label(case)
        data = strategy_inputs(torch, dev, gen, case)
        n = ring_computes(case.get("inner", case["kind"]), case["P"], case.get("pods", 1))
        nb = n if case["grad"] else 0
        t0 = time.perf_counter()
        reset_launch_counts()
        got = strategy_run(torch, case, "cuda", True, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = launch_counts()
        want_launches = {"flash_attention_fwd": n, "flash_attention_bwd_dq": nb,
                         "flash_attention_bwd_dkv": nb}
        if ran != want_launches:
            raise AssertionError(f"{name}: launches {ran}, expected {want_launches}")
        with EachCall(torch, name) as each:
            seq = strategy_run(torch, case, "cuda", False, data)
        if each.calls != {"fwd": n, "bwd": nb}:
            raise AssertionError(f"{name}: checked calls {each.calls}, expected {n}/{nb}")
        for what, a, b in zip(("out", "dq", "dk", "dv"), (got[0], *got[1]), (seq[0], *seq[1])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: overlap=True and overlap=False differ in {what}")
        plain = strategy_run(torch, case, "torch", True, data)
        least = torch.bfloat16 if torch.bfloat16 in (
            data[0].dtype, getattr(torch, case.get("travel", "float32"))) else torch.float32
        tol = tolerances(least)
        err = (got[0].float() - plain[0].float()).abs()
        if not (torch.isfinite(got[0].float()).all()
                and torch.all(err <= tol["atol"] + tol["rtol"] * plain[0].float().abs())):
            raise AssertionError(f"{name}: forward off the plain path by {float(err.max()):.3e}")
        pairs = []
        if case["grad"]:
            grads = [g.float() for g in got[1]], [g.float() for g in plain[1]]
            if least == torch.float32:
                _, pairs = compare_grads(torch, name, *grads, atol=1e-4, rtol=1e-4, quiet=True)
            else:
                _, pairs = compare_grads(torch, name, *grads, l2=BWD_BF16_LIMIT["l2"],
                                         elementwise=False, quiet=True)
        worst["calls_row"] = max(worst["calls_row"], each.row)
        worst["calls_l2"] = max(worst["calls_l2"], each.l2)
        sent, cost = got[2], got[3].cost
        if sent["link"] != {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}:
            raise AssertionError(f"{name}: link bytes {sent['link']}, cost model "
                                 f"{cost.fwd_bytes}/{cost.bwd_bytes}")
        if cost.links is not None:
            classes = {lc.cls: {"fwd": lc.fwd_bytes, "bwd": lc.bwd_bytes} for lc in cost.links}
            if sent["class"] != classes:
                raise AssertionError(f"{name}: bytes by class {sent['class']}, cost model "
                                     f"{classes}")
        row = {"case": name, "launches": n, "wall_s_kernels": wall, "out_err": float(err.max()),
               "grads_row_l2": pairs, "bytes": sent,
               "cost": {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}}
        rows.append(row)
        log(f"  ok {name}: launches {n}/{nb}/{nb} = Computes; {n}+{nb} kernel calls vs plain "
            f"(worst out {each.out_err:.2e}, grads row {each.row:.2e} / l2 {each.l2:.2e}); "
            f"vs the plain path: out {float(err.max()):.2e}"
            + (f", grads row/l2 {' '.join(f'{r:.2e}/{x:.2e}' for r, x in pairs)}" if pairs
               else "") + f"; overlap True/False bitwise equal; link bytes "
            f"{sent['link']['fwd']:.0f}/{sent['link']['bwd']:.0f} = cost model"
            + (f" (by class {sent['class']})" if cost.links is not None else "")
            + f", positions {sent['positions']['fwd']:.0f}/{sent['positions']['bwd']:.0f}"
            f" and lse {sent['lse']['fwd']:.0f}/{sent['lse']['bwd']:.0f} apart; "
            f"kernel path {wall:.3f} s")
        free_device_memory(torch)
    # what the reference refuses inside the hybrid, the port refuses too
    pctx = ParallelContext(device="cuda", sp_degree=4, pods=2, strategy="ring_bidir")
    try:
        pctx.plan(AttnShapes(B=1, Sq=4096, Hq=16, Hkv=8, D=128))
    except ValueError as e:
        log(f"  ok hybrid[ring_bidir] refused as in the reference: {e}")
    else:
        raise AssertionError("the hybrid took ring_bidir inside, which the reference refuses")
    log(f"  {len(rows)} strategy cases passed; worst kernel call: grads {worst['calls_row']:.2e} "
        f"of the row RMS, {worst['calls_l2']:.2e} relative L2")
    return {"cases": rows, "worst": worst}


def interval_union(spans):
    """Sorted, disjoint union of ``(start, end)`` spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(spans, cover):
    """Length of ``spans`` (a disjoint union) lying inside ``cover`` (one too)."""
    total, j = 0.0, 0
    for a, b in spans:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        i = j
        while i < len(cover) and cover[i][0] < b:
            total += min(b, cover[i][1]) - max(a, cover[i][0])
            i += 1
    return total


def stream_shares(trace_path):
    """From a torch.profiler chrome trace: the compute stream (the one that
    runs the port's kernels), the device time of the other streams (the
    ring's copies), the compute stream's kernel time, and the share of the
    copy time that lies under a running compute-stream kernel."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    stream = lambda e: e.get("args", {}).get("stream", e.get("tid"))  # noqa: E731
    mine = [stream(e) for e in gpu if "rt::" in e.get("name", "")]
    compute = max(set(mine), key=mine.count)
    side = [(e["ts"], e["ts"] + e["dur"]) for e in gpu if stream(e) != compute]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in gpu
            if stream(e) == compute and e.get("cat") == "kernel"]
    side_u, kern_u = interval_union(side), interval_union(kern)
    copy_us = sum(b - a for a, b in side_u)
    span_us = max(e["ts"] + e["dur"] for e in gpu) - min(e["ts"] for e in gpu)
    busy_us = sum(b - a for a, b in interval_union(side + kern))
    return {"compute_stream": compute, "gpu_span_ms": span_us / 1e3,
            "device_busy_share": busy_us / span_us,
            "side_streams": sorted({str(stream(e)) for e in gpu if stream(e) != compute}),
            "copy_ms": copy_us / 1e3, "copy_events": len(side),
            "kernel_ms": sum(b - a for a, b in kern_u) / 1e3,
            "copy_share_under_kernels": covered(side_u, kern_u) / copy_us if copy_us else 0.0}


def ring_overlap_trace(torch, dev, gen, B, S, Hq, Hkv, D, P=4):
    """TokenRing forward and backward at the training shape on the kernels:
    the overlap=True and overlap=False wall times, then one overlap=True run
    under torch.profiler: the side stream's copies against the compute
    stream's kernels.  One card's copy engines are no NVLink ring: this
    shows overlap, not link bandwidth."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity

    pos = ring_positions(torch, dev, B, S, P)
    q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, torch.bfloat16)

    def step(overlap):
        return ring_run(torch, "tokenring", "float32", P, "cuda", overlap, q, k, v, pos, w, wl)

    walls = {}
    for overlap in (True, False, True, False):
        step(overlap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(overlap)
        torch.cuda.synchronize()
        walls.setdefault(overlap, []).append((time.perf_counter() - t0) / 3)
    shape = f"B={B} S={S} P={P} Hq={Hq} Hkv={Hkv} D={D} bf16 causal zigzag, tokenring"
    log(f"  wall per forward and backward: overlap=True {[round(x, 5) for x in walls[True]]} s, "
        f"overlap=False {[round(x, 5) for x in walls[False]]} s")
    prof = profiled(lambda: step(True), [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    named="rt::")
    if prof is None:
        log("  trace: not measured (torch.profiler recorded no kernel of the port in "
            f"{PROFILER_TRIES} sessions)")
        return {"trace": "not measured", "shape": shape, "wall_s_overlap": walls[True],
                "wall_s_sequential": walls[False]}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        res = stream_shares(path)
    finally:
        os.unlink(path)
    res.update(shape=shape, wall_s_overlap=walls[True], wall_s_sequential=walls[False])
    log(f"  trace ({res['shape']}, forward and backward, overlap=True): {res['copy_events']} "
        f"copies on stream(s) {res['side_streams']} for {res['copy_ms']:.3f} ms, compute stream "
        f"{res['compute_stream']} kernels {res['kernel_ms']:.3f} ms; "
        f"{100 * res['copy_share_under_kernels']:.1f}% of the copy time under a running kernel; "
        f"the device busy {100 * res['device_busy_share']:.1f}% of the "
        f"{res['gpu_span_ms']:.3f} ms from its first to its last kernel")
    if res["copy_events"] == 0:
        raise AssertionError("ring trace: no copy ran on a side stream")
    return res


def sp1_loss(torch, dev, cfg, params, data_cfg):
    """The loss of ``params`` on the first batch of ``data_cfg`` at SP 1
    (kernels, no gradient): the yardstick of an SP run's first step."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import batch_to_device

    bundle = build_model(cfg, ParallelContext(device="cuda"))
    batch = batch_to_device(next(train_data(cfg, data_cfg)), dev)
    with torch.no_grad():
        loss, _ = bundle.loss(params, batch)
    return float(loss)


# A ring's first-step loss against SP 1's on the same weights and batch:
# the two differ only in attention's sums (another order, the partials
# merged in float32) and in where bf16 rounds them; 28 layers carry that
# into the loss far below 1e-3 of it (PR 16 logged equal losses to 4
# places).  Limit: 1e-3 relative.
SP1_LOSS_LIMIT = 1e-3


def phase_train_ring(torch, dev, with_profile=False, cfg=None, B=2, S=4096, steps=3, P=4,
                     strategy="tokenring", pods=1, sequential=True, result="training_ring",
                     sp1_limit=SP1_LOSS_LIMIT):
    """The ring training path: qwen3-1.7b at full width and depth through the
    Trainer with ``strategy`` over P virtual ranks on the card (with ``pods``
    > 1, the multi-pod hybrid with ``strategy`` inside each pod), one warmup
    step whose loss must be within ``SP1_LOSS_LIMIT`` of SP 1's on the same
    weights and batch, and ``steps`` timed steps whose launch counts must
    equal the schedule's Computes per layer (A twice under remat "full");
    with ``sequential``, the same steps with ``overlap=False``; with
    ``with_profile``, one more step under torch.profiler.  ``sp1_limit=None``
    reports the first loss's distance from SP 1's without a gate."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = cfg or ARCHS["qwen3-1.7b"]
    # a windowed config's layers take the window halo, which needs its
    # contiguous layout
    layout = cfg.layout if cfg.window else ParallelContext.layout
    pctx = ParallelContext(device="cuda", sp_degree=P, pods=pods, strategy=strategy,
                           layout=layout)
    bundle = build_model(cfg, pctx)
    trainer = Trainer(bundle, TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=1 + steps))
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0,
                               layout=cfg.layout, sp_degree=P)
    data = train_data(cfg, data_cfg)
    state = trainer.init_state(0)
    loss1 = sp1_loss(torch, dev, cfg, state["params"], data_cfg)
    free_device_memory(torch)
    step_log = lambda m: log("  " + m)  # noqa: E731
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    rel = abs(hist[0] - loss1) / abs(loss1)
    if sp1_limit is not None and not rel <= sp1_limit:
        raise AssertionError(f"{result}: first-step loss {hist[0]} against SP 1's {loss1} "
                             f"({rel:.2e} relative, limit {sp1_limit})")
    ring = pctx.ring
    reset_launch_counts()
    ring.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state, timed = trainer.run(state, data, steps=1 + steps, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    computes = sp_computes(cfg, strategy, P, pods)
    want = {k: v * steps for k, v in train_launches_per_step(cfg, computes).items()}
    if got != want:
        raise AssertionError(f"{result}: launches {got} over {steps} steps, expected {want}")
    losses = hist + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{result}: losses {losses}")
    step_s = trainer.step_seconds[1:]
    med = statistics.median(step_s)
    per_step = {k: v // steps for k, v in got.items()}
    per = lambda d: {k: v / steps for k, v in d.items()}  # noqa: E731
    sent = {"link_bytes_per_step": per(ring.link_bytes),
            "class_bytes_per_step": {c: per(d) for c, d in ring.class_bytes.items()},
            "position_bytes_per_step": per(ring.position_bytes),
            "lse_bytes_per_step": per(ring.lse_bytes)}
    if cfg.family == "ssm":  # no attention: the layers' scans run over the ring
        strategy, label = "sp_scan", "the chunked scan"
    elif cfg.family == "hybrid":  # windowed attention and recurrences
        strategy, label = "window+sp_scan", "the window halo and the scan"
    else:
        label = strategy if pods == 1 else f"the hybrid ({pods} pods, {strategy} inside)"
    res = {"arch": cfg.name, "strategy": strategy, "pods": pods, "sp_degree": P,
           "ring": "virtual, one card", "batch": B, "seq": S, "steps_timed": steps,
           "step_s": step_s, "median_step_s": med, "tokens_per_s": B * S / med,
           "first_step_s": trainer.step_seconds[0], "losses": losses, "sp1_first_loss": loss1,
           "first_loss_rel_err": rel, "peak_bytes_timed_steps": peak, "launches": got,
           "launches_per_step": per_step, **sent}
    log(f"  {label} over {P} virtual ranks: first loss {hist[0]:.6f} against SP 1's "
        f"{loss1:.6f} ({rel:.2e} relative); timed steps {[round(x, 4) for x in step_s]} s: "
        f"median {med:.4f} s = {B * S / med:.1f} tok/s; losses {[round(x, 4) for x in losses]}; "
        f"peak memory {peak / 2**30:.2f} GiB; launches per step {per_step}; bytes per step and "
        f"rank: link {sent['link_bytes_per_step']} by class {sent['class_bytes_per_step']}, "
        f"positions {sent['position_bytes_per_step']}, lse {sent['lse_bytes_per_step']}")
    if sequential:
        # the same steps with every send done before its step's computes,
        # from the state reached (same launches; recorded beside the
        # overlapped steps)
        seq = Trainer(build_model(cfg, dataclasses.replace(pctx, overlap=False)),
                      TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=2 + 2 * steps))
        seq.run(state, data, steps=2 + 2 * steps, log=lambda m: None)
        res["step_s_overlap_false"] = seq.step_seconds[1:]
        log(f"  the same steps with overlap=False: "
            f"{[round(x, 4) for x in res['step_s_overlap_false']]} s")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: trainer.run(
            state, data, steps=2 + steps, log=lambda m: None), med)
    log(f"RESULT {result} " + json.dumps(res))
    return got


def serve_cli_adaptive_prefill(torch, dev):
    """The serve CLI at full size with the prefix cache: its adaptive-prefill
    line must name what ``choose_prefill_strategy`` picks at the hit rate the
    engine measured."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import print_adaptive_prefill
    from repro_torch.serving.kv_cache import pages_for

    argv = ["--arch", "qwen3-1.7b", "--requests", "8", "--max-new", "8", "--max-batch", "4",
            "--max-len", "2048", "--prefill-chunk", "256", "--token-budget", "512",
            "--page-size", "16", "--prefix-cache", "--shared-prefix", "512",
            "--device", dev.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        stats = serve_main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue().splitlines()
    rate = stats["prefix"]["hit_rate"]
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        print_adaptive_prefill(ARCHS["qwen3-1.7b"], max_len=2048,
                               table_pages=pages_for(2048, 16), prefix_hit_rate=rate)
    line = want.getvalue().strip()
    if line not in out or not rate > 0:
        raise AssertionError(f"serve CLI: no adaptive-prefill line {line!r} at hit rate {rate} "
                             f"in {out}")
    for text in out:
        if text.startswith(("served", "prefix cache", "adaptive prefill")):
            log(f"  serve CLI: {text}")
    log(f"  serve CLI ({' '.join(argv)}): {wall:.1f} s")
    return {"argv": argv, "hit_rate": rate, "line": line, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 14: the prefix cache, the resilience layer and a snapshot restart at
# full width and depth (this slice's serving path)
# ---------------------------------------------------------------------------

PREFIX_ENGINE = dict(max_batch=8, max_len=2048, prefill_chunk=256, token_budget=512,
                     page_size=16, max_pages=1024)
SYSTEM_PROMPT = 512  # tokens of the shared system prompt (32 full pages)
COW_CUT = 520  # the COW request keeps request 0's first 520 tokens: 32 pages + 8 rows
# Run 5: run 2's requests and one that forks inside the system prompt (so
# that the cow point is reached while the index churns), on a pool cut to
# 200 pages, so that decode growth preempts, with one fault at each tick
# point.  The schedule does not depend on the logits (no request stops at
# EOS), so a run at any width reaches the same points: alloc at uid 2's first
# admission, prefill_tick at the 20th tick, sample at uid 1's 21st token,
# decode_once at the 45th decode call, evict at the first preemption (uid
# 6), admit at uid 13's first attempt, cow at uid 17's first; no three within
# the ladder's 16-tick window.
FAULT_MAX_PAGES = 200
FAULT_COW_CUT = 500  # 31 system-prompt pages + 4 rows
FAULT_PLAN = [("alloc", 0, 1, 2), ("prefill_tick", 19, 1, None), ("sample", 20, 1, 1),
              ("decode_once", 44, 1, None), ("evict", 0, 1, 6), ("admit", 0, 1, 13),
              ("cow", 0, 1, 17)]


def prefix_prompts(vocab, n=16, seed=5):
    """``n`` prompts: one seeded 512-token system prompt, then a seeded
    128-1024-token suffix each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    return [np.concatenate([system, rng.integers(0, vocab, int(rng.integers(128, 1025)))])
            .astype(np.int32) for _ in range(n)]


def cow_prompt(prompt0, vocab, cut=COW_CUT, seed=6):
    """``prompt0`` cut at ``cut`` with a new seeded 128-token tail: it
    diverges ``cut % 16`` rows into page ``cut // 16``."""
    import numpy as np

    tail = np.random.default_rng(seed).integers(0, vocab, 128)
    if tail[0] == prompt0[cut]:
        tail[0] = (tail[0] + 1) % vocab
    return np.concatenate([prompt0[:cut], tail]).astype(np.int32)


def counted_run(torch, eng, prompts, label, L):
    """Submit ``prompts`` to ``eng``, run it to the end and hold the kernel
    launches (counters set to 0 here) to 56 a prefill tick and 28 a decode
    step of this run; every step's logits must be finite.  Returns the
    requests, the stats (with ``wall_s``, ``tok_s``) and the launches."""
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda

    finite = torch.ones((), dtype=torch.bool, device=eng.device)

    def checked(step):
        def run(*args):
            logits, state = step(*args)
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, state
        return run

    if not hasattr(eng, "_checked"):
        eng._step, eng._chunk_step, eng._checked = checked(eng._step), checked(eng._chunk_step), 1
    ticks0, steps0 = eng.counters["prefill_steps"], eng.counters["decode_steps"]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {**launch_counts(), "paged_decode_fwd": paged_decode_fwd_cuda.launches}
    ticks = eng.counters["prefill_steps"] - ticks0
    steps = eng.counters["decode_steps"] - steps0
    want = serving_launches(L, ticks, steps, paged=True)
    if got != want:
        raise AssertionError(f"phase 14 {label}: launches {got}, expected {want} from {ticks} "
                             f"prefill ticks and {steps} decode steps")
    if not bool(finite):
        raise AssertionError(f"phase 14 {label}: a serving step gave non-finite logits")
    s = eng.stats()
    toks = sum(len(r.output) for r in reqs)
    ttft = [r.t_first - r.t_submit for r in reqs if r.t_first]
    s.update(wall_s=wall, tok_s=toks / wall, run_tokens=toks, run_ticks=ticks,
             run_steps=steps, run_mean_ttft_s=sum(ttft) / max(len(ttft), 1))
    return reqs, s, got


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_prefix_serving(torch, dev, launches):
    """qwen3-1.7b at full width and depth (bf16, seeded weights) through the
    paged engine with the prefix cache: the cold run, the prefix run, a warm
    repeat and a copy-on-write request on its engine, a run with a fault at
    every tick point on a cut pool, and a snapshot restart; launches counted
    per run into ``launches``."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.resilience import FaultPlan, FaultSpec

    cfg = ARCHS["qwen3-1.7b"]
    L = cfg.n_layers
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    params = bundle.init(0)
    prompts = prefix_prompts(cfg.vocab_size)
    res = {}

    def engine(**kw):
        return ServingEngine(bundle, params, device=dev, **{**PREFIX_ENGINE, **kw})

    def line(name, s):
        p = s.get("prefix") or {}
        log(f"  run {name}: {s['run_tokens']} tokens in {s['wall_s']:.3f} s = "
            f"{s['tok_s']:.2f} tok/s, mean TTFT {s['run_mean_ttft_s'] * 1e3:.1f} ms, "
            f"{s['run_ticks']} prefill ticks, {s['run_steps']} decode steps, prefill tokens "
            f"{s['prefill_tokens']}, {s['preemptions']} preemptions"
            + (f"; prefix hits {p['hit_tokens']} of {p['lookup_tokens']} tokens "
               f"({100 * p['hit_rate']:.1f}%), {p['indexed_pages']} pages indexed, "
               f"{p['cow_copies']} COW copies, {p['evictions']} evictions" if p else ""))

    # 1. cold
    cold, s1, launches["prefix_cold"] = counted_run(torch, engine(), prompts, "cold", L)
    line("cold", s1)
    res["cold"] = s1
    # 2. prefix
    eng2 = engine(prefix_cache=True, audit_every=8)
    reqs2, s2, launches["prefix"] = counted_run(torch, eng2, prompts, "prefix", L)
    line("prefix", s2)
    hit = s2["prefix"]["hit_tokens"]
    if hit < SYSTEM_PROMPT or eng2.auditor.violations():
        raise AssertionError(f"phase 14 prefix: {hit} hit tokens, auditor "
                             f"{eng2.auditor.violations()}")
    if s1["preemptions"] == s2["preemptions"] == 0 and \
            s2["prefill_tokens"] != s1["prefill_tokens"] - hit:
        raise AssertionError(f"phase 14 prefix: prefill tokens {s2['prefill_tokens']}, the cold "
                             f"run's {s1['prefill_tokens']} less {hit} hit tokens")
    pairs = [(a, b) for x, y in zip(reqs2, cold) for a, b in zip(x.output, y.output)]
    s2["tokens_equal_to_cold_share"] = sum(a == b for a, b in pairs) / len(pairs)
    log(f"    prefix: {100 * s2['tokens_equal_to_cold_share']:.1f}% of the tokens equal the "
        f"cold run's (the rest is gated by the witness below)")
    res["prefix"] = s2
    # 3. warm repeats of request 0's exact prompt on run 2's engine.  Its
    # full pages are resident; the partial last page's rows are prefilled
    # again, in a chunk that now starts at the hit, so kernel A's resident
    # and chunk-local calls split those rows' keys elsewhere than run 2's
    # chunk (which started at a multiple of 256) did: bitwise equality with
    # run 2 is logged, not gated (PERF.md §7).  Gated: the prefill
    # growth, a second repeat (same hit, split, slot and shapes) bitwise
    # the first, and the witness below.
    ps = PREFIX_ENGINE["page_size"]
    tail = (len(prompts[0]) - 1) % ps
    before = eng2.counters["prefill_tokens"]
    (warm,), s3, launches["prefix_warm"] = counted_run(torch, eng2, prompts[:1], "warm", L)
    grew = eng2.counters["prefill_tokens"] - before
    (warm2,), _, launches["prefix_warm_again"] = counted_run(torch, eng2, prompts[:1],
                                                             "warm again", L)
    first = next((i for i, (a, b) in enumerate(zip(warm.output, reqs2[0].output)) if a != b),
                 None)
    log(f"  run warm repeat: prefill grew by {grew} tokens (the prompt's partial last page: "
        f"{tail} rows); {s3['run_ticks']} prefill ticks, {s3['run_steps']} decode steps; tokens "
        + ("bitwise equal to request 0's in run 2" if first is None else
           f"equal to request 0's in run 2 up to token {first}, then not")
        + "; a second repeat "
        + ("bitwise equal to" if warm2.output == warm.output else "DIFFERENT from") + " the first")
    if grew > PREFIX_ENGINE["prefill_chunk"]:
        raise AssertionError(f"phase 14 warm repeat: prefill grew by {grew} tokens")
    if warm2.output != warm.output:
        raise AssertionError("phase 14 warm repeat: a second repeat with the same pages and the "
                             "same chunk split gave other tokens")
    res["warm"] = dict(prefill_growth=grew, tail_rows=tail, ticks=s3["run_ticks"],
                       steps=s3["run_steps"], first_difference_from_run2=first,
                       repeat_bitwise=True)
    # 4. copy-on-write on run 2's engine
    cow_p = cow_prompt(prompts[0], cfg.vocab_size)
    pages = sorted(eng2.prefix.pages)
    k_before, v_before = eng2.state["k"][:, pages].clone(), eng2.state["v"][:, pages].clone()
    copies = eng2.prefix.cow_copies
    (cow,), s4, launches["prefix_cow"] = counted_run(torch, eng2, [cow_p], "cow", L)
    if eng2.prefix.cow_copies != copies + 1:
        raise AssertionError(f"phase 14 COW: {eng2.prefix.cow_copies - copies} copies, not 1")
    if not (torch.equal(eng2.state["k"][:, pages], k_before)
            and torch.equal(eng2.state["v"][:, pages], v_before)):
        raise AssertionError("phase 14 COW: an index page's K/V changed")
    if eng2.auditor.violations():
        raise AssertionError(f"phase 14 COW: auditor {eng2.auditor.violations()}")
    log(f"  run COW: 1 copy-on-write (keep {COW_CUT % PREFIX_ENGINE['page_size']} rows); the "
        f"K/V of all {len(pages)} index pages bitwise unchanged; {s4['run_ticks']} prefill "
        f"ticks, {s4['run_steps']} decode steps")
    res["cow"] = dict(index_pages=len(pages), ticks=s4["run_ticks"], steps=s4["run_steps"])
    del eng2, k_before, v_before
    free_device_memory(torch)
    # 5. faults on a cut pool
    plan = FaultPlan([FaultSpec(*f) for f in FAULT_PLAN])
    eng5 = engine(prefix_cache=True, audit_every=8, max_pages=FAULT_MAX_PAGES, fault_plan=plan)
    fault_prompts = prompts + [cow_prompt(prompts[0], cfg.vocab_size, cut=FAULT_COW_CUT)]
    reqs5, s5, launches["prefix_faults"] = counted_run(torch, eng5, fault_prompts, "faults", L)
    line("faults", s5)
    fired = sorted(((p, uid) for p, _, uid in plan.fired), key=lambda f: f[0])
    want = sorted(((p, uid) for p, _, _, uid in FAULT_PLAN), key=lambda f: f[0])
    log(f"    faults: fired {plan.fired}; counters faults {s5['faults']}, quarantines "
        f"{s5['quarantines']}, recoveries {s5['recoveries']}, failures {s5['failures']}, "
        f"integrity errors {s5['integrity_errors']}; ladder {s5['degrade']}; "
        f"{s5['audits']['post_recovery']} post-recovery audits, "
        f"{s5['audits']['post_recovery_violations']} with a violation")
    n_attr = sum(1 for p, _, _, _ in FAULT_PLAN if p not in ("prefill_tick", "decode_once"))
    checks = {
        "every request done": all(r.status == "done" for r in reqs5),
        "fired is the plan": [p for p, _ in fired] == [p for p, _ in want] and all(
            w is None or f == w for (_, f), (_, w) in zip(fired, want)),
        "preemptions happened": s5["preemptions"] >= 1,
        "copy-on-write happened": s5["prefix"]["cow_copies"] >= 1,
        "ladder never escalated": s5["degrade"]["escalations"] == 0,
        "counters": (s5["faults"], s5["quarantines"], s5["recoveries"], s5["failures"],
                     s5["integrity_errors"]) == (len(want), n_attr, len(want) - n_attr, 0, 0),
        "auditor clean after each recovery": s5["audits"]["post_recovery"] >= 1
        and s5["audits"]["post_recovery_violations"] == 0,
        "auditor clean at the end": eng5.auditor.violations() == [],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 14 faults: {bad}")
    res["faults"] = {**{k: v for k, v in s5.items() if not isinstance(v, dict)},
                     "fired": plan.fired, "degrade": s5["degrade"], "audits": s5["audits"]}
    faults_chains = [r.output for r in reqs5]
    del eng5
    free_device_memory(torch)
    # 6. snapshot restart
    snap = ROOT / "build" / "phase14_snapshot"
    shutil.rmtree(snap, ignore_errors=True)
    eng6 = engine(prefix_cache=True, audit_every=8, snapshot_dir=str(snap))
    reset_launch_counts()
    for p in prompts:
        eng6.submit(p, max_new_tokens=32)
    while eng6.counters["decode_steps"] < s2["run_steps"] // 2:
        eng6.run(max_steps=1)
    at_step = eng6.counters["decode_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = eng6.snapshot()
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(snap)
    del eng6
    free_device_memory(torch)
    t0 = time.perf_counter()
    eng7 = ServingEngine.from_snapshot(bundle, params, str(snap), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    eng7.auditor.check()
    eng7.run()
    got = {**launch_counts(), "paged_decode_fwd": paged_decode_fwd_cuda.launches}
    wanted = serving_launches(L, eng7.counters["prefill_steps"], eng7.counters["decode_steps"],
                              paged=True)
    if got != wanted:
        raise AssertionError(f"phase 14 snapshot: launches {got}, expected {wanted}")
    launches["prefix_snapshot"] = got
    outs = {r.uid: r.output for r in eng7.done}
    if eng7.auditor.violations() or [outs.get(r.uid) for r in reqs2] != [r.output
                                                                        for r in reqs2]:
        raise AssertionError("phase 14 snapshot: the restarted engine's tokens differ from run "
                             f"2's or its auditor found {eng7.auditor.violations()}")
    log(f"  run snapshot: snapshot at tick {step} (decode step {at_step} of "
        f"{s2['run_steps']}): {nbytes} B on disk, save {save_s:.3f} s, restart "
        f"(from_snapshot) {restore_s:.3f} s; the restarted engine's tokens bitwise equal run "
        f"2's, auditor clean")
    res["snapshot"] = dict(bytes=nbytes, save_s=save_s, restore_s=restore_s, tick=step,
                           decode_step=at_step)
    del eng7
    shutil.rmtree(snap, ignore_errors=True)
    free_device_memory(torch)
    # witness: every token of runs 2, 4 and 5 against the cold run's bundle
    res["witness"] = {
        "prefix": witness_gate(torch, dev, bundle, params, prompts,
                               [r.output for r in reqs2], "prefix run"),
        "warm": witness_gate(torch, dev, bundle, params, prompts[:1], [warm.output],
                             "warm repeat"),
        "cow": witness_gate(torch, dev, bundle, params, [cow_p], [cow.output], "COW request"),
        "faults": witness_gate(torch, dev, bundle, params, fault_prompts, faults_chains,
                               "fault run"),
    }
    del bundle, params
    log("RESULT serving_prefix " + json.dumps(res))


# ---------------------------------------------------------------------------
# phase 15: checkpoint/restart training at full width, depth cut to CKPT_LAYERS
# ---------------------------------------------------------------------------

# Depth of phase 15: qwen3-1.7b cut from 28 layers to 8 (8.6 GB of state
# in place of 20.6 GB), so that the whole run stays near half its time
# limit: the checkpoint I/O scales with the state, the checks do not.
CKPT_LAYERS = 8


def timed_methods(obj, names, into):
    """Wrap ``obj``'s methods ``names`` to append their wall seconds (after a
    device sync) to ``into[name]``."""
    import torch

    for name in names:
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            into.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        setattr(obj, name, wrapped)


def phase_train_ckpt(torch, dev, cfg=None, B=2, S=4096, steps=5, fail_at=3):
    """qwen3-1.7b at full width through the Trainer with checkpoints every 2
    steps: an uninterrupted run (async saves) and a fault-tolerant run that
    fails at step ``fail_at`` and resumes from the step-2 checkpoint
    (blocking saves), bitwise equal; then one remat "dots" step beside a
    "full" one.  Returns each run's launches."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.fault_tolerance import FailureInjector, FaultTolerantRunner
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, batch_to_device, n_params

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=CKPT_LAYERS)
    root = ROOT / "build" / "phase15_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    bundle = build_model(cfg, ParallelContext(device="cuda"))

    def data():
        return SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                                global_batch=B, seed=0, layout=cfg.layout))

    def trainer(sub, hook=None, **kw):
        tcfg = TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=steps, checkpoint_every=2,
                             checkpoint_dir=str(root / sub), keep_checkpoints=1, **kw)
        t = Trainer(bundle, tcfg, step_hook=hook)
        t.losses = []
        step_fn = t._step

        def recorded(state, batch):
            new, metrics = step_fn(state, batch)
            t.losses.append((int(state["step"]), metrics["loss"]))
            return new, metrics
        t._step = recorded
        return t

    quiet = dict(log_every=10**6, log=lambda m: None)
    launches, times = {}, {}
    # uninterrupted, async saves
    t_ref = trainer("ref")
    timed_methods(t_ref.ckpt, ("save", "wait"), times.setdefault("async", {}))
    state = t_ref.init_state(0)
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    free = shutil.disk_usage(root).free
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params(state['params']) / 1e9:.3f}B "
        f"parameters; training state {state_bytes} B (parameters, AdamW moments, step); "
        f"{free} B free under {root.relative_to(ROOT)}; batch {B} x seq {S}, remat {cfg.remat}")
    if free < 2.2 * state_bytes:
        raise AssertionError(f"phase 15: {free} B free, two checkpoints need {2 * state_bytes}")
    reset_launch_counts()
    state, _ = t_ref.run(state, data(), steps=steps, **quiet)
    torch.cuda.synchronize()
    launches["train_ckpt"] = launch_counts()
    ref_losses = [(i, float(x)) for i, x in t_ref.losses]
    ref_params = state["params"]
    ckpt_bytes = dir_bytes(root / "ref")
    del state, t_ref
    shutil.rmtree(root / "ref", ignore_errors=True)
    free_device_memory(torch)
    # fault-tolerant, blocking saves, a failure before step `fail_at`
    inj = FailureInjector([fail_at])
    t_ft = trainer("ft", hook=inj, async_checkpoint=False)
    timed_methods(t_ft.ckpt, ("save", "restore"), times.setdefault("blocking", {}))
    runner = FaultTolerantRunner(t_ft, max_restarts=1, log=lambda m: log("  " + m))
    reset_launch_counts()
    ft_state, _ = runner.run(0, data(), steps=steps)
    torch.cuda.synchronize()
    launches["train_ft"] = launch_counts()
    ft_losses = [(i, float(x)) for i, x in t_ft.losses]
    ran = len(ft_losses)
    per_step = train_launches_per_step(cfg)
    want = {k: v * ran for k, v in per_step.items()}
    if launches["train_ft"] != want or launches["train_ckpt"] != {k: v * steps for k, v in
                                                                 per_step.items()}:
        raise AssertionError(f"phase 15: launches {launches}, expected {per_step} per step "
                             f"({steps} and {ran} steps)")
    ref_by_step = dict(ref_losses)
    same_losses = all(ref_by_step[i] == x for i, x in ft_losses)
    diff = [name for (name, a), (_, b) in zip(named_leaves(ref_params),
                                              named_leaves(ft_state["params"]))
            if not torch.equal(a, b)]
    log(f"  uninterrupted losses {[round(x, 6) for _, x in ref_losses]}; fault-tolerant run "
        f"steps {[i for i, _ in ft_losses]} (restarts {runner.restarts}) losses "
        f"{[round(x, 6) for _, x in ft_losses]}; {len(diff)} parameter leaves differ")
    if runner.restarts != 1 or not same_losses or diff or int(ft_state["step"]) != steps:
        raise AssertionError(f"phase 15: the fault-tolerant run is not bitwise the "
                             f"uninterrupted one (restarts {runner.restarts}, losses equal "
                             f"{same_losses}, leaves differing {diff[:5]})")
    a_save = times["async"]["save"]
    a_wait = times["async"]["wait"]
    b_save = times["blocking"]["save"]
    b_rest = times["blocking"]["restore"]
    log(f"  checkpoint {ckpt_bytes} B on disk; async save: {[round(x, 3) for x in a_save]} s "
        f"in the step loop (the host copy), final wait {[round(x, 3) for x in a_wait]} s; "
        f"blocking save {[round(x, 3) for x in b_save]} s; restore "
        f"{[round(x, 3) for x in b_rest]} s")
    del ft_state, runner, t_ft
    shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)
    # remat "dots" beside "full": one step's loss and gradients from the same
    # parameters and batch, then 3 timed training steps each
    batch = batch_to_device(next(data()), dev)
    grads = {}
    for remat in ("full", "dots"):
        b = build_model(cfg.with_(remat=remat), ParallelContext(device="cuda"))
        reset_launch_counts()
        (loss, _), g = value_and_grad(b.loss, ref_params, batch)
        torch.cuda.synchronize()
        grads[remat] = (loss, g, launch_counts())
    if not torch.equal(grads["full"][0], grads["dots"][0]):
        raise AssertionError(f"phase 15 dots: loss {float(grads['dots'][0])} vs full "
                             f"{float(grads['full'][0])}")
    worst = worst_leaf(torch, grads["dots"][1], grads["full"][1], 5e-2)
    if grads["dots"][2] != train_launches_per_step(cfg.with_(remat="dots")):
        raise AssertionError(f"phase 15 dots: launches {grads['dots'][2]}")
    launches["train_dots"] = grads["dots"][2]
    del grads
    free_device_memory(torch)
    timing = {}
    for remat in ("full", "dots"):
        b = build_model(cfg.with_(remat=remat), ParallelContext(device="cuda"))
        t = Trainer(b, TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=4))
        st = t.state_from_params(ref_params)
        torch.cuda.reset_peak_memory_stats()
        t.run(st, data(), steps=4, **quiet)
        timing[remat] = dict(median_step_s=statistics.median(t.step_seconds[1:]),
                             peak_bytes=torch.cuda.max_memory_allocated())
        del st, t
        free_device_memory(torch)
    log(f"  remat dots: loss bitwise equal to full's, worst gradient leaf {worst:.2e} of its "
        f"max (limit 5e-2); launches {launches['train_dots']}; median of 3 steps "
        f"{timing['dots']['median_step_s']:.4f} s (full {timing['full']['median_step_s']:.4f} s), "
        f"peak memory {timing['dots']['peak_bytes'] / 2**30:.2f} GiB (full "
        f"{timing['full']['peak_bytes'] / 2**30:.2f} GiB)")
    log("RESULT training_ckpt " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "state_bytes": state_bytes,
        "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": free, "ref_losses": ref_losses,
        "ft_losses": ft_losses, "async_save_s": a_save, "async_wait_s": a_wait,
        "blocking_save_s": b_save, "restore_s": b_rest, "dots_worst_leaf": worst,
        "timing": timing, "launches": launches}))
    return launches


# ---------------------------------------------------------------------------
# phase 17: the MoE and VLM families (qwen3-moe-30b-a3b, llama4-scout,
# pixtral-12b)
# ---------------------------------------------------------------------------

# Depth of qwen3-moe's training run: 4 of its 48 layers at full width are
# 3.12 B parameters, 16 B each with the float32 gradients and AdamW's two
# moments (about 50 GB on the 80 GB card).
MOE_TRAIN_LAYERS = 4
# Depth of llama4-scout: 4 of its 48 layers (10.9 B parameters, 21.8 GB in
# bf16); all 48 (about 106 B parameters) do not fit one card.
LLAMA4_LAYERS = 4
# pixtral-12b's one-shot prefill: 2 requests of 1024 patch embeddings and
# 256 text tokens, then 32 greedy decode steps
VLM_BATCH, VLM_TEXT, VLM_STEPS = 2, 256, 32


def no_drop(cfg):
    """``cfg`` with a capacity factor of E / K: an expert can take every
    token of a row (the dense dispatch's C = S), a rank's destination
    bucket every entry it holds and an expert every token of the batch
    (the expert-parallel C_sd and C_e at 4 ranks), so nothing drops and
    chunked and one-shot prefill, SP 4 and SP 1 compute the same function.
    (At 4, random routing already drops: the hidden states of a seeded
    model are alike across positions, so tokens crowd the same experts.)"""
    return cfg.with_(capacity_factor=cfg.n_experts / cfg.n_experts_per_token)


def moe_exchange_bytes(torch, dev, P=4, B=2, S=1024):
    """One forward of qwen3-moe's expert-parallel MoE at full width over P
    virtual ranks: the bytes each rank hands the ring against their closed
    form (token buffer out and results back, ``P*C_sd*d*b`` a direction;
    the router statistics' two all-reduces of E float32 at ``(P-1)/P``; the
    int32 expert-id table, ``P*C_sd*4/2``, apart in position_bytes)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.moe import _round8, moe_ffn, moe_init

    cfg = ARCHS["qwen3-moe-30b-a3b"]
    pctx = ParallelContext(device="cuda", sp_degree=P)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = moe_init(gen, cfg, device=dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    d, E, K = cfg.d_model, cfg.n_experts, cfg.n_experts_per_token
    C_sd = _round8(int(B * (S // P) * K / P * cfg.capacity_factor))
    pctx.ring.reset_counts()
    with torch.no_grad():
        y, _ = moe_ffn(params, x, cfg, pctx)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("phase 17 EP exchange: non-finite output")
    floats = P * C_sd * d * 2 + 2 * (P - 1) / P * E * 4
    ints = P * C_sd * 4 / 2
    got = (dict(pctx.ring.link_bytes), dict(pctx.ring.position_bytes))
    if got != ({"fwd": floats, "bwd": floats}, {"fwd": ints, "bwd": ints}):
        raise AssertionError(f"phase 17 EP exchange: bytes {got}, closed form {floats} float "
                             f"and {ints} int a direction")
    log(f"  ok phase 17 EP exchange (qwen3-moe, P={P}, B={B} x S={S}, C_sd={C_sd}): "
        f"{floats:.0f} float and {ints:.0f} int32 bytes a rank and direction, = closed form")
    return {"P": P, "C_sd": C_sd, "float_bytes": floats, "int_bytes": ints}


def phase_moe_checked(torch, dev):
    """Phase 17 (a): qwen3-moe widths, 2 layers, float32, no-drop capacity:
    one training step on the kernels against the plain path and the two
    engines teacher-forced against the plain SP-1 path (phase 8's and 5's
    gates), both again over 4 virtual ranks with expert parallelism, then
    the exchange's bytes."""
    from repro_torch.configs import ARCHS

    cfg = no_drop(ARCHS["qwen3-moe-30b-a3b"].with_(n_layers=2, dtype="float32"))
    phase_train_checked(torch, dev, cfg=cfg, label="phase 17 qwen3-moe step")
    free_device_memory(torch)
    phase_e2e_checked(torch, dev, label="phase 17 qwen3-moe", cfg=cfg)
    free_device_memory(torch)
    # S 128: the expert-parallel buffers at this capacity grow with S^2
    # (4.3 GB a layer in float32 at S 128)
    phase_train_checked(torch, dev, cfg=cfg, S=128,
                        label="phase 17 qwen3-moe step (tokenring, P=4, EP)", sp_degree=4,
                        strategy="tokenring")
    free_device_memory(torch)
    phase_e2e_checked(torch, dev, sp_degree=4, label="phase 17 qwen3-moe EP", cfg=cfg)
    free_device_memory(torch)
    return moe_exchange_bytes(torch, dev)


def phase_vlm(torch, dev):
    """Phase 17 (e): pixtral-12b at full width and depth: ``lm_prefill`` of
    VLM_BATCH requests (1024 seeded patch embeddings and VLM_TEXT text
    tokens each) into the dense slab, one kernel-A launch a layer (the
    wgmma instance, Sq = 1280); then VLM_STEPS greedy decode steps, one
    decode-instance launch a layer each.  Every token is fed back through
    the plain path and must lie within WITNESS_GAP of its row spread below
    the plain path's max logit."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model

    cfg = ARCHS["pixtral-12b"]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    t0 = time.perf_counter()
    params = bundle.init(0)
    gen = torch.Generator(device=dev).manual_seed(11)
    B, n_img = VLM_BATCH, cfg.frontend_tokens
    patches = (0.02 * torch.randn((B, n_img, cfg.d_model), generator=gen, device=dev)).to(
        torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (B, VLM_TEXT), generator=gen, device=dev,
                           dtype=torch.int32)
    S = n_img + VLM_TEXT
    positions = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    max_len = 2048
    torch.cuda.synchronize()
    log(f"  pixtral-12b: {cfg.n_layers} layers, bf16, seeded init "
        f"{time.perf_counter() - t0:.1f} s; prefill {B} x ({n_img} patches + {VLM_TEXT} tokens)")
    torch.cuda.reset_peak_memory_stats()

    def run(b, feed=None):
        """Prefill then VLM_STEPS decode steps on bundle ``b``: greedy, or
        fed ``feed``'s tokens.  Returns (tokens, logits a step, launches)."""
        state = b.init_serve_state(B, max_len, dev)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = b.prefill(params, tokens, positions, state, patches)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        launches = [launch_counts()["flash_attention_fwd"]]
        rows, chain = [logits.float()], []
        t0 = time.perf_counter()
        for step in range(VLM_STEPS):
            tok = rows[-1].argmax(-1) if feed is None else feed[:, step]
            chain.append(tok)
            reset_launch_counts()
            logits, state = b.decode_step(params, tok.to(torch.int32), state)
            launches.append(launch_counts()["flash_attention_fwd"])
            rows.append(logits.float())
        torch.cuda.synchronize()
        return torch.stack(chain, 1), torch.stack(rows[:-1], 1), launches, (
            t_prefill, (time.perf_counter() - t0) / VLM_STEPS)

    chain, logits, launches, (t_prefill, t_step) = run(bundle)
    peak = torch.cuda.max_memory_allocated()
    if launches != [cfg.n_layers] * (1 + VLM_STEPS):
        raise AssertionError(f"phase 17 pixtral: launches {launches}, expected {cfg.n_layers} "
                             "for the prefill and each decode step")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 17 pixtral: non-finite logits")
    _, ref, plain_launches, _ = run(plain, feed=chain)
    if any(plain_launches):
        raise AssertionError("phase 17 pixtral: the plain path launched a kernel")
    top = ref.max(-1).values
    gap = top - ref.gather(-1, chain[..., None].long())[..., 0]
    ratio = float((gap / (top - ref.mean(-1))).max())
    flips = int((gap > 0).sum())
    log(f"  pixtral-12b [{fa.flash_fwd_instance(torch.bfloat16, S, cfg.head_dim)} prefill, "
        f"{fa.flash_fwd_instance(torch.bfloat16, 1, cfg.head_dim)} decode]: prefill "
        f"{t_prefill * 1e3:.1f} ms ({B * S / t_prefill:.0f} tok/s), decode step "
        f"{t_step * 1e3:.2f} ms; launches {launches[0]} a prefill and {launches[1]} a decode "
        f"step; {chain.numel()} tokens fed back through the plain path, {flips} not its "
        f"argmax, largest gap {ratio:.4f} of the row spread (limit {WITNESS_GAP}); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if ratio > WITNESS_GAP:
        raise AssertionError(f"phase 17 pixtral: a token lies {ratio:.4f} of the row spread "
                             "below the plain path's max logit")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "prefill_tokens": S,
           "prefill_s": t_prefill, "decode_step_s": t_step, "launches_prefill": launches[0],
           "launches_per_decode_step": launches[1], "tokens": chain.numel(), "flips": flips,
           "max_gap_over_spread": ratio, "peak_bytes": peak}
    log("RESULT serving_vlm " + json.dumps(res))
    return {"flash_attention_fwd": sum(launches), "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "paged_decode_fwd": 0}


# ---------------------------------------------------------------------------
# phase 18: the encoder-decoder family (whisper-base)
# ---------------------------------------------------------------------------

WHISPER_CHECK_LAYERS = 2  # encoder and decoder layers of the checked float32 runs
WHISPER_CLIPS = 8  # clips encoded and decoded at once
WHISPER_STEPS = 128  # greedy decode steps a serving run
WHISPER_MAX_LEN = 448  # whisper's decoder context: the dense slab's slots
WHISPER_SOT = 50258  # <|startoftranscript|>, the first decoder token


def whisper_frames(torch, dev, cfg, B, seed):
    """Seeded frame embeddings ``(B, enc_seq, d_model)`` in float32 (the
    frontend stub's output; the encoder casts them to ``cfg.dtype``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)


def whisper_launches(cfg, P, steps):
    """Kernel A's launches of an encode and of each of ``steps`` decode
    steps: the encoder's self-attention once a layer (TokenRing's Computes
    on the virtual ring), then a decode-instance call a decoder layer for
    the self cache and one for the cross read, every rank's rows in one
    launch."""
    return [cfg.n_enc_layers * (ring_computes("tokenring", P) if P > 1 else 1)] + [
        2 * cfg.n_layers] * steps


def whisper_serve(torch, dev, bundle, params, frames, steps, feed=None):
    """``encode(frames)`` into a dense slab of WHISPER_MAX_LEN slots, then
    ``steps`` decode steps from WHISPER_SOT: greedy, or fed ``feed``'s
    tokens.  Returns the chain ``(B, steps)``, the logits of each step
    ``(B, steps, V)`` in float32, A's launches of the encode and of each
    step, the encode's seconds and each step's."""
    B = frames.shape[0]
    state = bundle.init_serve_state(B, WHISPER_MAX_LEN, dev)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle.encode(params, frames, state)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    launches = [launch_counts()["flash_attention_fwd"]]
    tok = torch.full((B,), WHISPER_SOT, dtype=torch.int32, device=dev)
    chain, rows, step_s = [], [], []
    for step in range(steps):
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, state = bundle.decode_step(params, tok, state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append(launch_counts()["flash_attention_fwd"])
        rows.append(logits.float())
        tok = (logits.argmax(-1) if feed is None else feed[:, step]).to(torch.int32)
        chain.append(tok)
    return torch.stack(chain, 1), torch.stack(rows, 1), launches, t_enc, step_s


def forced_gaps(torch, ref, chain):
    """Each token's gap below the reference logits' row max, and that gap
    over the row spread (max minus mean)."""
    top = ref.max(-1).values
    gap = top - ref.gather(-1, chain[..., None].long())[..., 0]
    return gap, gap / (top - ref.mean(-1))


def phase_whisper_checked(torch, dev, B=2, S=512, steps=16):
    """Phase 18 (a): whisper-base at full width, WHISPER_CHECK_LAYERS
    encoder and decoder layers, float32, at SP 1 and through TokenRing over
    4 virtual ranks: one training step on the kernels against the plain
    path (phase 8's gates: the decoder's S queries against the encoder's
    1536 keys in every cross-attention), then an encode and ``steps``
    greedy decode steps on the kernels, each token fed back through the
    plain path at SP 1 and held to phase 5's gate (within 1e-3 of its max
    logit), with A's launches counted."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model

    cfg = ARCHS["whisper-base"].with_(n_layers=WHISPER_CHECK_LAYERS,
                                      n_enc_layers=WHISPER_CHECK_LAYERS, dtype="float32")
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    for P in (1, 4):
        kw = dict(sp_degree=P, strategy="tokenring") if P > 1 else {}
        phase_train_checked(torch, dev, cfg=cfg, B=B, S=S,
                            label=f"phase 18 whisper step (SP {P})", **kw)
        free_device_memory(torch)
        bundle = build_model(cfg, ParallelContext(device="cuda", **kw))
        params = bundle.init(0)
        frames = whisper_frames(torch, dev, cfg, B, seed=13)
        chain, _, launches, _, _ = whisper_serve(torch, dev, bundle, params, frames, steps)
        if launches != whisper_launches(cfg, P, steps):
            raise AssertionError(f"phase 18 whisper decode (SP {P}): launches {launches}, "
                                 f"expected {whisper_launches(cfg, P, steps)}")
        _, ref, plain_launches, _, _ = whisper_serve(torch, dev, plain, params, frames, steps,
                                                     feed=chain)
        if any(plain_launches):
            raise AssertionError("phase 18 whisper decode: the plain path launched a kernel")
        gap, _ = forced_gaps(torch, ref, chain)
        worst = float(gap.max())
        if not worst <= 1e-3:
            raise AssertionError(f"phase 18 whisper decode (SP {P}): a token is {worst:.2e} "
                                 "below the plain path's max logit")
        log(f"  ok phase 18 whisper decode (SP {P}): encode + {steps} steps x {B} clips within "
            f"1e-3 of the plain SP-1 path (worst gap {worst:.2e}); launches A {launches[0]} "
            f"the encode, {launches[1]} a step")
        del bundle, params
        free_device_memory(torch)


def phase_whisper_serving(torch, dev, with_profile, sp_degree=1, result="serving_whisper"):
    """Phase 18 (c): whisper-base at full width and depth, bf16: WHISPER_CLIPS
    clips encoded, then WHISPER_STEPS greedy decode steps on the dense slab
    (12 decode-instance launches a step: 6 self, 6 cross), over
    ``sp_degree`` virtual ranks; every token fed back through the plain
    path at SP 1 and held within WITNESS_GAP of its row spread below the
    plain path's max logit.  With ``with_profile``, an encode and 16 steps
    once more under torch.profiler."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model

    cfg = ARCHS["whisper-base"]
    bundle = build_model(cfg, ParallelContext(device="cuda", sp_degree=sp_degree))
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    params = bundle.init(0)
    B, steps = WHISPER_CLIPS, WHISPER_STEPS
    frames = whisper_frames(torch, dev, cfg, B, seed=12)
    torch.cuda.reset_peak_memory_stats()
    whisper_serve(torch, dev, bundle, params, frames, 2)  # warmup
    chain, logits, launches, t_enc, step_s = whisper_serve(torch, dev, bundle, params, frames,
                                                           steps)
    peak = torch.cuda.max_memory_allocated()
    if launches != whisper_launches(cfg, sp_degree, steps):
        raise AssertionError(f"{result}: launches {launches[:3]}..., expected "
                             f"{whisper_launches(cfg, sp_degree, steps)[:3]}...")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{result}: non-finite logits")
    _, ref, plain_launches, _, _ = whisper_serve(torch, dev, plain, params, frames, steps,
                                                 feed=chain)
    if any(plain_launches):
        raise AssertionError(f"{result}: the plain path launched a kernel")
    gap, ratio = forced_gaps(torch, ref, chain)
    worst, flips = float(ratio.max()), int((gap > 0).sum())
    med = statistics.median(step_s)
    tok_s = B * steps / sum(step_s)
    log(f"  whisper-base SP {sp_degree} [{fa.flash_fwd_instance(torch.bfloat16, cfg.enc_seq, 64)}"
        f" encode, {fa.flash_fwd_instance(torch.bfloat16, 1, 64)} decode]: encode {B} x "
        f"{cfg.enc_seq} frames {t_enc * 1e3:.1f} ms; {steps} steps: median {med * 1e3:.2f} ms, "
        f"{tok_s:.0f} tok/s; launches {launches[0]} the encode, {launches[1]} a step; "
        f"{chain.numel()} tokens fed back through the plain path, {flips} not its argmax, "
        f"largest gap {worst:.4f} of the row spread (limit {WITNESS_GAP}); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if worst > WITNESS_GAP:
        raise AssertionError(f"{result}: a token lies {worst:.4f} of the row spread below the "
                             "plain path's max logit")
    res = {"arch": cfg.name, "sp_degree": sp_degree, "ring": "virtual, one card",
           "clips": B, "enc_seq": cfg.enc_seq, "max_len": WHISPER_MAX_LEN,
           "steps": steps, "encode_s": t_enc, "median_step_s": med, "tokens_per_s": tok_s,
           "launches_encode": launches[0], "launches_per_step": launches[1],
           "tokens": chain.numel(), "flips": flips, "max_gap_over_spread": worst,
           "peak_bytes": peak}
    if with_profile:
        res["profile"] = profile_step(
            torch, lambda: whisper_serve(torch, dev, bundle, params, frames, 16),
            t_enc + sum(step_s[:16]))
    log(f"RESULT {result} " + json.dumps(res))
    return {"flash_attention_fwd": sum(launches), "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "paged_decode_fwd": 0}


def serve_cli_whisper(torch, dev):
    """The serve CLI at full size on whisper-base: 4 requests through the
    engine's token-by-token prefill (no prefill chunk)."""
    import contextlib
    import io

    from repro_torch.launch.serve import main as serve_main

    argv = ["--arch", "whisper-base", "--requests", "4", "--max-new", "8", "--max-batch", "4",
            "--max-len", str(WHISPER_MAX_LEN), "--device", dev.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        stats = serve_main(argv)
    wall = time.perf_counter() - t0
    if (stats["requests"], stats["tokens"], stats["prefill_steps"]) != (4, 32, 0):
        raise AssertionError(f"serve CLI whisper: {stats['requests']} requests, "
                             f"{stats['tokens']} tokens, {stats['prefill_steps']} prefill steps")
    for text in buf.getvalue().splitlines():
        if text.startswith(("served", "steps")):
            log(f"  serve CLI: {text}")
    log(f"  serve CLI ({' '.join(argv)}): {wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the SSM family (falcon-mamba-7b: the two-pass chunked selective
# scan, sequence-parallel over the ring's shifts) and the one-shot prefill
# at SP > 1
# ---------------------------------------------------------------------------

MAMBA = "falcon-mamba-7b"
MAMBA_CHECK_LAYERS = 2  # layers of the checked float32 runs
# of 64: 64 layers of float32 parameters, gradients and AdamW moments take
# about 116 GB
MAMBA_TRAIN_LAYERS = 8
MAMBA_PROMPTS, MAMBA_PROMPT_LEN, MAMBA_STEPS = 8, 256, 64
PREFILL_SP_BATCH, PREFILL_SP_LEN, PREFILL_SP_STEPS = 2, 1024, 16


def sequential_scan(torch, a, b):
    """``h_t = a_t h_{t-1} + b_t`` by a loop over time: the plain version of
    the scan."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


def phase_mamba_scan(torch, dev):
    """Phase 19 (a): ``sp_scan`` on the virtual ring against the sequential
    loop at P = 2, 4, 8 and 2 x 2 pods: ``check_scan``'s and
    ``check_scan_hybrid``'s cases (seeds 17, 19) and one at falcon-mamba's
    state width (B 2, 256 steps, d_inner x N = 131072), float32, each run
    twice and bitwise equal.  The doubling rounds in another order than the
    loop: atol/rtol 1e-5, the reference's limits."""
    from repro_torch.core.api import ParallelContext, sp_scan

    cases = [(17, 2, 64, 8), (19, 2, 32, 4), (21, 2, 256, 8192 * 16)]
    for seed, B, S, D in cases:
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = 0.5 + 0.49 * torch.rand((B, S, D), generator=gen, device=dev)
        b = torch.randn((B, S, D), generator=gen, device=dev)
        want = sequential_scan(torch, a, b)
        for P, pods in ((2, 1), (4, 1), (8, 1), (4, 2)):
            pctx = ParallelContext(device="cuda", sp_degree=P, pods=pods, layout="contig")
            h = sp_scan(a, b, pctx=pctx)
            again = sp_scan(a, b, pctx=pctx)
            if not torch.equal(h, again):
                raise AssertionError(f"phase 19 sp_scan P={P} pods={pods}: not bitwise repeated")
            err = float((h - want).abs().max())
            if not bool(torch.isclose(h, want, atol=1e-5, rtol=1e-5).all()):
                raise AssertionError(f"phase 19 sp_scan (B {B}, S {S}, state {D}) P={P} "
                                     f"pods={pods}: off the sequential scan by {err:.3e}")
            log(f"  ok sp_scan B {B} S {S} state {D}, P={P} pods={pods}: max |err| {err:.2e} "
                "against the sequential loop, bitwise repeated")


def mamba_plain_scan(x_c, dt_in, Bs, Cs, dt_w, dt_b, A, D, *, pctx, chunk):
    """The plain path's selective scan (in place of
    ``models.mamba.selective_scan_sp``): the global sequence by a loop over
    time, float32, no chunks and no ring."""
    import torch
    import torch.nn.functional as F

    dt = F.softplus(dt_in.float() @ dt_w.float() + dt_b.float())
    Aneg = -torch.exp(A)
    h = torch.zeros((x_c.shape[0], x_c.shape[2], Bs.shape[-1]), dtype=torch.float32,
                    device=x_c.device)
    ys = []
    for t in range(x_c.shape[1]):
        xt = x_c[:, t].float()
        h = torch.exp(dt[:, t, :, None] * Aneg) * h + (dt[:, t] * xt)[..., None] * Bs[:, t, None, :]
        ys.append((h * Cs[:, t, None, :]).sum(-1) + D * xt)
    return torch.stack(ys, 1)


def phase_mamba_checked(torch, dev, cfg=None, B=2, S=512):
    """Phase 19 (a): falcon-mamba at full width, ``MAMBA_CHECK_LAYERS``
    layers, float32, remat "full": the loss and every gradient leaf at SP 1
    and through the scan over 4 virtual ranks against the plain path (the
    same model with its scan a loop over time), each run twice and bitwise
    equal (deterministic algorithms on); no kernel launch; at P = 4 the
    ring's bytes against ``scan_comm_bytes``'s closed form: a layer's scan
    in the forward and again in its remat recompute, the transposes in the
    backward."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.core.recurrence import scan_comm_bytes
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models import mamba as M
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import batch_to_device

    cfg = cfg or ARCHS[MAMBA].with_(n_layers=MAMBA_CHECK_LAYERS, dtype="float32")
    plain = build_model(cfg, ParallelContext(device="cuda"))
    params = plain.init(0, training=True)
    batch = batch_to_device(next(SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1, layout="contig"))), dev)
    real_scan = M.selective_scan_sp
    M.selective_scan_sp = mamba_plain_scan
    try:
        (l_plain, _), g_plain = value_and_grad(plain.loss, params, batch)
    finally:
        M.selective_scan_sp = real_scan
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for P in (1, 4):
            bundle = build_model(cfg, ParallelContext(device="cuda", sp_degree=P))
            ring = bundle.pctx.ring
            sent = {"fwd": 0, "bwd": 0}
            if ring is not None:  # each shift once, whatever its distance
                real_move = ring._move

                def counting_move(x, shift, real_move=real_move):
                    sent["fwd" if shift > 0 else "bwd"] += x.numel() * x.element_size() // P
                    return real_move(x, shift)

                ring._move = counting_move
            runs = []
            for _ in range(2):
                if ring is not None:
                    ring.reset_counts()
                    sent.update(fwd=0, bwd=0)
                reset_launch_counts()
                (loss, _), grads = value_and_grad(bundle.loss, params, batch)
                torch.cuda.synchronize()
                ledger = dict(ring.link_bytes) if ring is not None else {}
                runs.append((loss, grads, ledger, dict(sent)))
            if any(launch_counts().values()):
                raise AssertionError(f"phase 19 mamba P={P}: launches {launch_counts()}")
            (loss, grads, ledger, msgs), (loss2, grads2, _, _) = runs
            same = torch.equal(loss, loss2) and all(
                torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(grads),
                                                            named_leaves(grads2)))
            if not same:
                raise AssertionError(f"phase 19 mamba P={P}: loss or gradients not bitwise "
                                     "repeated")
            l_err = abs(float(loss) - float(l_plain))
            # the same float32 ops but the scan's, whose doubling and
            # cross-rank composition round in another order than the loop:
            # phase 8's float32 limits (loss 1e-5 relative, each leaf 1e-4
            # of its largest |value|)
            if not (math.isfinite(float(loss)) and l_err <= 1e-5 * abs(float(l_plain))):
                raise AssertionError(f"phase 19 mamba P={P}: loss {float(loss)} vs the plain "
                                     f"path's {float(l_plain)}")
            worst = worst_leaf(torch, grads, g_plain, 1e-4)
            line = (f"  ok phase 19 falcon-mamba {cfg.n_layers} layers f32 P={P}: loss "
                    f"{float(loss):.6f} vs plain {float(l_plain):.6f} (|err| {l_err:.2e}); worst "
                    f"gradient leaf off by {worst:.2e} of its max; bitwise repeated; 0 launches")
            if P > 1:
                per = scan_comm_bytes(P, B * cfg.d_inner * cfg.ssm_state * 4)
                L, remat = cfg.n_layers, (2 if cfg.remat != "none" else 1)
                want_link = {"fwd": remat * L * per["link_bytes"]["fwd"],
                             "bwd": L * per["link_bytes"]["bwd"]}
                want_msgs = {"fwd": remat * L * per["messages"]["fwd"],
                             "bwd": L * per["messages"]["bwd"]}
                if ledger != want_link or msgs != want_msgs:
                    raise AssertionError(f"phase 19 mamba P={P}: ring bytes {ledger} (messages "
                                         f"{msgs}), closed form {want_link} ({want_msgs})")
                line += (f"; ring bytes a rank: messages {msgs} = {per['rounds']} rounds x 2 "
                         f"tensors x {B * cfg.d_inner * cfg.ssm_state * 4} B a scan, ledger "
                         f"(hop-weighted) {ledger}, both the closed form")
            log(line)
    finally:
        torch.use_deterministic_algorithms(False)
    # the decode step at full width in float32, one token a step, against
    # the forward pass (the chunked scan) plus the head at every position:
    # the same float32 ops but the scan's order and the products' shapes
    # (limits 1e-3 absolute and relative)
    T = 64
    state = plain.init_serve_state(B, 0, dev)
    rows = [plain.decode_step(params, batch["tokens"][:, t], state)[0] for t in range(T)]
    with torch.no_grad():
        x = M.mamba_apply(params, batch["tokens"][:, :T], cfg=cfg, pctx=plain.pctx)
        fwd = x @ params["lm_head"]["w"]
    dec = torch.stack(rows, 1)
    err = float((dec - fwd).abs().max())
    if not bool(torch.isclose(dec, fwd, atol=1e-3, rtol=1e-3).all()):
        raise AssertionError(f"phase 19 mamba f32 decode: logits off the forward pass by {err}")
    log(f"  ok phase 19 falcon-mamba {cfg.n_layers} layers f32 decode: {B} x {T} steps, logits "
        f"within {err:.2e} of the forward pass at every position")


# A layer's output on the forward pass, fed the decode's own inputs to that
# layer (teacher-forced), against the decode step's output: the two differ
# only where cuBLAS sums a product of 8 rows in another order than one of
# 8 x 320 (a bf16 rounding flipped now and then) and in the float32 scan's
# order; a wrong state or window would put the layer's update off by its own
# size.  Limit: 1e-2 of the update's L2 norm, relative L2 over the layer.
MAMBA_LAYER_LIMIT = 1e-2
MAMBA_DEPTHS = (1, 2, 4, 8, 16, 32, 64)  # depths whose free-running divergence is logged


def phase_mamba_decode(torch, dev, prompts=MAMBA_PROMPTS, prompt_len=MAMBA_PROMPT_LEN,
                       steps=MAMBA_STEPS):
    """Phase 19 (c): falcon-mamba-7b at full width and depth (64 layers,
    bf16): ``prompts`` prompts of ``prompt_len`` tokens fed through
    ``bundle.decode_step`` one token a step (the reference's only serving
    path), then ``steps`` greedy tokens; no kernel launch; the engine
    refuses the bundle.

    The scan's parity at full width and depth: every layer's inputs are
    recorded during the run, and each layer's forward pass
    (``mamba_layer``, the chunked scan) over the same inputs must give the
    decode steps' outputs within ``MAMBA_LAYER_LIMIT``.  The end-to-end
    comparison with ``mamba_apply`` plus the head is logged, not gated: with
    seeded random weights, 64 bf16 layers amplify such rounding until the
    two forwards no longer agree (the divergence is logged by depth), which
    says nothing of the scan."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models import mamba as M
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving.engine import ServingEngine

    cfg = ARCHS[MAMBA]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, {weight_bytes / 1e9:.2f} GB of weights, seeded "
        f"init {time.perf_counter() - t0:.1f} s; {prompts} prompts of {prompt_len} tokens, then "
        f"{steps} greedy tokens, one token a step")
    gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (prompts, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    state = bundle.init_serve_state(prompts, 0, dev)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    # every layer's input of every step (and the last layer's output), kept
    # by reference: the forward pass is fed them afterwards
    seen = [[] for _ in range(cfg.n_layers + 1)]
    calls = [0]
    real_layer = M.mamba_layer_decode

    def recording_layer(p, x, ssm_state, conv_state, *, cfg, **kw):
        out = real_layer(p, x, ssm_state, conv_state, cfg=cfg, **kw)
        layer = calls[0] % cfg.n_layers
        calls[0] += 1
        seen[layer].append(x)
        if layer == cfg.n_layers - 1:
            seen[-1].append(out[0])
        return out

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, fed, marks = [], [], []

    def step(tok):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = bundle.decode_step(params, tok, state)
        end.record()
        marks.append((start, end))
        rows.append(logits.float())

    M.mamba_layer_decode = recording_layer
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt_len):
            step(tokens[:, t])
        torch.cuda.synchronize()
        t_prompt = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = rows[-1].argmax(-1).to(torch.int32)
            fed.append(tok)
            step(tok)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    finally:
        M.mamba_layer_decode = real_layer
    peak = torch.cuda.max_memory_allocated()
    if any(launch_counts().values()):
        raise AssertionError(f"phase 19 mamba decode: launches {launch_counts()}")
    step_ms = [s.elapsed_time(e) for s, e in marks]
    med = statistics.median(step_ms)
    dec = torch.stack(rows, 1)
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("phase 19 mamba decode: non-finite logits")
    seq = torch.cat([tokens, torch.stack(fed, 1)], dim=1)
    layer_err, drift = [], {}
    with torch.no_grad():
        x = params["embed"]["table"][seq.long()]
        for l, p_l in enumerate(params["layers"]):
            xin, xout = torch.cat(seen[l], 1), torch.cat(seen[l + 1], 1)
            forced = M.mamba_layer(p_l, xin, cfg=cfg, pctx=bundle.pctx).float()
            update = (xout.float() - xin.float()).norm()
            layer_err.append(float((forced - xout.float()).norm() / update))
            x = M.mamba_layer(p_l, x, cfg=cfg, pctx=bundle.pctx)
            if l + 1 in MAMBA_DEPTHS:
                drift[l + 1] = float((x.float() - xout.float()).norm() / xout.float().norm())
            seen[l] = None
        x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        fwd = (x @ params["lm_head"]["w"]).float()
    top = fwd.max(-1).values
    gap = top - fwd.gather(-1, dec.argmax(-1, keepdim=True))[..., 0]
    ratio = float((gap / (top - fwd.mean(-1))).max())
    flips = int((gap > 0).sum())
    del fwd, x, seen
    worst = max(layer_err)
    log(f"  decode: prompt fed at {prompts * prompt_len / t_prompt:.1f} tok/s, greedy "
        f"{prompts * steps / t_gen:.1f} tok/s; median step {med:.3f} ms (CUDA events; weight-read "
        f"bound {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); state {state_bytes / 2**20:.1f} "
        f"MiB; peak {peak / 2**30:.2f} GiB")
    log(f"  each layer's forward pass fed the decode's inputs ({dec.shape[0] * dec.shape[1]} "
        f"positions): worst {worst:.2e} of the layer's update (layer {layer_err.index(worst)}; "
        f"limit {MAMBA_LAYER_LIMIT}), median {statistics.median(layer_err):.2e}")
    log(f"  free-running forward against the decode, relative L2 by depth: "
        + ", ".join(f"{d}: {v:.2e}" for d, v in drift.items())
        + f"; at the head {flips} of {dec.shape[0] * dec.shape[1]} positions not the forward's "
        f"argmax, largest gap {ratio:.4f} of the row spread (logged, not gated)")
    if not worst <= MAMBA_LAYER_LIMIT:
        raise AssertionError(f"phase 19 mamba decode: layer {layer_err.index(worst)}'s forward "
                             f"pass is {worst:.3e} of its update off the decode steps")
    try:
        ServingEngine(bundle, params, max_batch=prompts, max_len=512, device=dev)
    except NotImplementedError as e:
        if "rolled back" not in str(e):
            raise
        log(f"  the engine refuses the bundle: {e}")
    else:
        raise AssertionError("phase 19: the engine served a recurrent family")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": prompts, "prompt_len": prompt_len,
           "steps": steps, "prompt_tokens_per_s": prompts * prompt_len / t_prompt,
           "tokens_per_s": prompts * steps / t_gen, "median_step_ms": med,
           "weight_bytes": weight_bytes,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "state_bytes": state_bytes, "peak_bytes": peak,
           "positions": dec.shape[0] * dec.shape[1], "layer_rel_err_max": worst,
           "layer_rel_err_median": statistics.median(layer_err), "drift_by_depth": drift,
           "head_flips": flips, "head_max_gap_over_spread": ratio}
    log("RESULT decoding_mamba " + json.dumps(res))
    return {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "paged_decode_fwd": 0}


def phase_prefill_sp(torch, dev, P=4, cfg=None, B=PREFILL_SP_BATCH, S=PREFILL_SP_LEN,
                     steps=PREFILL_SP_STEPS):
    """Phase 19 (d): ``lm_prefill`` at SP > 1 (ROADMAP item 9c) on
    qwen3-1.7b at full width and depth: ``B`` x ``S`` tokens prefilled
    through TokenRing over P virtual ranks (kernel A: the schedule's
    Computes a layer, counted from zero), then ``steps`` greedy decode
    steps at SP P; every token fed back through SP 1's ``lm_prefill`` and
    decode steps must lie within ``WITNESS_GAP`` of the row spread below
    SP 1's max logit."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model

    cfg = cfg or ARCHS["qwen3-1.7b"]
    sp = build_model(cfg, ParallelContext(device="cuda", sp_degree=P, strategy="tokenring"))
    sp1 = build_model(cfg, ParallelContext(device="cuda"))
    params = sp1.init(0)
    gen = torch.Generator(device=dev).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    positions = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    max_len = 2 * S

    def run(bundle, feed=None):
        state = bundle.init_serve_state(B, max_len, dev)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = bundle.prefill(params, tokens, positions, state)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        launches = [launch_counts()["flash_attention_fwd"]]
        rows, chain = [logits.float()], []
        reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(steps):
            tok = rows[-1].argmax(-1).to(torch.int32) if feed is None else feed[:, i]
            chain.append(tok)
            logits, state = bundle.decode_step(params, tok, state)
            rows.append(logits.float())
        torch.cuda.synchronize()
        launches.append(launch_counts()["flash_attention_fwd"])
        return (torch.stack(chain, 1), torch.stack(rows[:-1], 1), launches,
                (t_prefill, (time.perf_counter() - t0) / steps))

    chain, logits, launches, (t_prefill, t_step) = run(sp)
    computes = ring_computes("tokenring", P)
    want = [cfg.n_layers * computes, cfg.n_layers * steps]
    if launches != want:
        raise AssertionError(f"phase 19 prefill SP {P}: A launches {launches} (prefill, "
                             f"decode), expected {want}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase 19 prefill SP {P}: non-finite logits")
    chain1, _, launches1, (t_prefill1, t_step1) = run(sp1)
    _, ref, _, _ = run(sp1, feed=chain)
    top = ref.max(-1).values
    gap = top - ref.gather(-1, chain[..., None].long())[..., 0]
    ratio = float((gap / (top - ref.mean(-1))).max())
    flips = int((gap > 0).sum())
    same = int((chain == chain1).sum())
    log(f"  lm_prefill SP {P} (tokenring, {computes} Computes a layer): {B} x {S} tokens in "
        f"{t_prefill * 1e3:.1f} ms (SP 1: {t_prefill1 * 1e3:.1f} ms), decode step "
        f"{t_step * 1e3:.2f} ms (SP 1: {t_step1 * 1e3:.2f} ms); A launches {launches[0]} a prefill "
        f"= {cfg.n_layers} x {computes}, {launches[1]} in {steps} decode steps (SP 1: "
        f"{launches1}); {chain.numel()} tokens fed back through SP 1, {flips} not its argmax, "
        f"largest gap {ratio:.4f} of the row spread (limit {WITNESS_GAP}); {same} of "
        f"{chain.numel()} equal to SP 1's greedy tokens")
    if ratio > WITNESS_GAP:
        raise AssertionError(f"phase 19 prefill SP {P}: a token lies {ratio:.4f} of the row "
                             "spread below SP 1's max logit")
    res = {"arch": cfg.name, "sp_degree": P, "strategy": "tokenring", "batch": B, "prefill": S,
           "steps": steps, "prefill_s": t_prefill, "prefill_s_sp1": t_prefill1,
           "decode_step_s": t_step, "decode_step_s_sp1": t_step1,
           "launches_prefill": launches[0], "computes_per_layer": computes,
           "launches_decode": launches[1], "tokens": chain.numel(), "flips": flips,
           "max_gap_over_spread": ratio, "equal_to_sp1_greedy": same}
    log("RESULT prefill_sp " + json.dumps(res))
    return {"flash_attention_fwd": launches[0], "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "paged_decode_fwd": 0}


# the phases with a profiled pass (``--profile`` runs them all, and adds
# tens of minutes; ``--profile=18`` only phase 18's)
# ---------------------------------------------------------------------------
# phase 20: the hybrid family (recurrentgemma-2b) and the head-dim-256
# instances of kernels A, B1, B2 and the decode core
# ---------------------------------------------------------------------------

RG = "recurrentgemma-2b"
RG_HEADS = (10, 1, 256)  # recurrentgemma's local attention: Hq, Hkv, D (MQA, group 10)
RG_WINDOW = 2048
RG_TRAIN_SHAPE = dict(B=2, S=4096)  # the training path's batch x seq
RG_CHECK_LAYERS = 5  # one superblock and the 2-layer tail: every block kind
RG_PROMPTS, RG_PROMPT_LEN, RG_STEPS = 8, 256, 64
RG_WRAP_TOKENS = 2112  # one row fed past the 2048-slot ring buffer by 64 tokens


def rg_ring_positions(torch, dev, lengths, slots=RG_WINDOW):
    """``(q_pos (B,1), k_pos (B, slots))`` of a ring buffer after each row's
    ``length`` tokens: slot ``p % slots`` holds the last position written to
    it, unwritten slots ``PAD_POS``; the query is the last token (a row of
    length 0 has only padding and a query at 0: it sees no key)."""
    rows = []
    for n in lengths:
        kp = torch.full((slots,), PAD_POS, dtype=torch.int32)
        p = torch.arange(max(0, n - slots), n, dtype=torch.int32)
        kp[p.long() % slots] = p
        rows.append(kp)
    qp = torch.tensor([[max(n - 1, 0)] for n in lengths], dtype=torch.int32)
    return qp.to(dev).contiguous(), torch.stack(rows).to(dev).contiguous()


def rg_kernel_cases(torch, dev):
    """Phase 20 (a)'s cases for A and B1/B2, each in float32 (the CUDA-core
    instances) and bf16 (the wgmma instances) at 10/1 heads and D 256
    (label, B, Sq, Sk, q_pos, k_pos, window): the main path's training call
    (causal, window 2048), a ragged 37 x 45 edge (queries offset by 8,
    window 24) and dead rows (queries before every key; a batch row of
    padding keys)."""
    B, S = RG_TRAIN_SHAPE["B"], RG_TRAIN_SHAPE["S"]
    ar = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    qr = (torch.arange(37, device=dev, dtype=torch.int32) + 8).expand(2, 37).contiguous()
    kr = torch.arange(45, device=dev, dtype=torch.int32).expand(2, 45).contiguous()
    qd, kd = bwd_positions(torch, dev, 2, 256, 256, "dead")
    return [(f"training B={B} S={S} window={RG_WINDOW}", B, S, S, ar, ar, RG_WINDOW),
            ("ragged 37x45 window=24", 2, 37, 45, qr, kr, 24),
            ("dead rows 256x256", 2, 256, 256, qd, kd, None)]


def rg_timed(fns, iters):
    """CUDA-event medians of the kernel, its plain version and the library
    call (``fns``, each run ``iters[i]`` times a repetition)."""
    return [time_ms(f, iters=it, reps=3) for f, it in zip(fns, iters)]


def pick_block_for(S):
    """The plain versions' tile along a sequence of ``S``."""
    from repro_torch.kernels.ops import pick_block

    return pick_block(S, 512)


def sdpa_masked(torch, q, k, v, qp, kp, window):
    """The library yardstick: SDPA on the same call, its boolean mask built
    from the positions (causal, window, padding), KV repeated for the group."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import visibility_mask

    mask = visibility_mask(qp, kp, causal=True, window=window)[:, None]
    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def phase_rg_kernels(torch, dev):
    """Phase 20 (a): the D-256 instances against their plain versions.  A and
    B1/B2 on ``rg_kernel_cases`` in float32 (the CUDA-core instances, 1e-4)
    and bf16 (the wgmma instances; phase 3's forward limits, phase 7's
    ``BWD_BF16_LIMIT``), the decode core at group 10 x Sq 1 over a 2048-slot
    ring buffer (wrapped rows, a half-filled row with slots at PAD_POS, a
    row that sees no key), every case run twice and bitwise equal, dead rows
    exactly (0, -inf), each line naming the instance the built library
    picks, which must be the one ``flash_fwd_instance`` and
    ``flash_bwd_instance`` name; then each timed at the main path's shapes
    in bf16 beside its plain version, SDPA on the same masked call and its
    bound.  Returns the summary's rows: ``wgmma`` (A), ``decode`` (A),
    ``dq`` and ``dkv``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import visibility_mask

    Hq, Hkv, D = RG_HEADS
    scale = 1.0 / D ** 0.5
    gen = torch.Generator(device=dev).manual_seed(23)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype in (f32, bf):
        built, host = fa.flash_bwd_instance_built(dtype, D), fa.flash_bwd_instance(dtype, D)
        if built != host:
            raise AssertionError(f"B1/B2 {dtype} D={D}: the library takes the {built} "
                                 f"instance, flash_bwd_instance says {host}")
        for d in fa.FLASH_DIMS:
            for sq in (1, 4, 5, 37, RG_TRAIN_SHAPE["S"]):
                built, host = fa.flash_fwd_instance_built(dtype, sq, d), fa.flash_fwd_instance(
                    dtype, sq, d)
                if built != host:
                    raise AssertionError(f"A {dtype} D={d} Sq={sq}: the library takes the "
                                         f"{built} instance, flash_fwd_instance says {host}")
            built, host = fa.decode_core_instance_built(dtype, d), fa.decode_core_instance(dtype, d)
            if built != host:
                raise AssertionError(f"decode core {dtype} D={d}: the library takes the {built} "
                                     f"kernel, decode_core_instance says {host}")
    if fa.flash_fwd_instance_built(bf, RG_TRAIN_SHAPE["S"], D) != "wgmma":
        raise AssertionError("A bf16 D=256: the training call does not go to the wgmma instance")
    if fa.decode_core_instance_built(bf, D) != "cluster":
        raise AssertionError("A bf16 D=256: the decode calls do not go to the cluster instance")
    log(f"  the built library and flash_fwd_instance / flash_bwd_instance / decode_core_instance "
        f"agree on every (dtype, D in {fa.FLASH_DIMS}, Sq); A bf16 D=256 Sq>4 [wgmma], f32 "
        "[cuda_core]; decode bf16 D=256 [cluster], f32 [split]")

    def fwd_pair(q, k, v, qp, kp, window):
        got = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=window,
                                          scale=scale)
        again = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=window,
                                            scale=scale)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("A D=256: two runs on the same inputs differ")
        want = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=True, window=window,
                                            scale=scale, block_k=pick_block_for(k.shape[1]))
        return got, want

    rows, main = {}, None
    for label, B, Sq, Sk, qp, kp, window in rg_kernel_cases(torch, dev):
        q32, do32 = rnd((B, Sq, Hq, D)), rnd((B, Sq, Hq, D))
        k32, v32 = rnd((B, Sk, Hkv, D)), rnd((B, Sk, Hkv, D))
        dlse = rnd((B, Sq, Hq))
        for dtype in (f32, bf):
            q, k, v, dout = (x.to(dtype) for x in (q32, k32, v32, do32))
            name = {f32: "f32", bf: "bf16"}[dtype]
            inst = fa.flash_fwd_instance_built(dtype, Sq, D)
            got, want = fwd_pair(q, k, v, qp, kp, window)
            a_err = compare(f"A {name} D=256 {label} [{inst}] bitwise repeatable", got, want,
                            **tolerances(dtype))
            out, lse = got
            g, w, args, kw = run_bwd(torch, q, k, v, qp, kp, dout, dlse, True, window, out,
                                     lse.contiguous())
            binst = fa.flash_bwd_instance_built(dtype, D)
            lim = dict(atol=1e-4, rtol=1e-4) if dtype == f32 else BWD_BF16_LIMIT
            b_err, _ = compare_grads(torch, f"B1/B2 {name} D=256 {label} [{binst}]", g, w,
                                     dead=dead_masks(torch, lse, qp, kp, True, window), **lim)
            if label.startswith("training") and dtype == bf:
                main = (q, k, v, qp, kp, dout, dlse, out, lse, args, kw, a_err, b_err)
            del g, w, args
    free_device_memory(torch)

    # the main path's training call in bf16, timed
    q, k, v, qp, kp, dout, dlse, out, lse, args, kw, a_err, b_err = main
    blk = pick_block_for(q.shape[1])
    a_fns = (lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True,
                                                 window=RG_WINDOW, scale=scale),
             lambda: fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=True,
                                                  window=RG_WINDOW, scale=scale, block_k=blk),
             sdpa_masked(torch, q, k, v, qp, kp, RG_WINDOW))
    ms, plain_ms, lib_ms = rg_timed(a_fns, (20, 1, 20))
    nbytes, flops = flash_bytes_flops(q, k, qp, kp, True, RG_WINDOW)
    bms, by = bound(nbytes, flops, "bfloat16")
    shape = (f"B={q.shape[0]} S={q.shape[1]} Hq={Hq} Hkv={Hkv} D={D} bf16 causal "
             f"window={RG_WINDOW}")
    ainst = fa.flash_fwd_instance_built(bf, q.shape[1], D)
    rows["wgmma"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, max_abs_err=a_err, instance=ainst,
                         device_kernel=f"rt::wg::flash_fwd_wgmma_kernel<{D}>", shape=shape,
                         flops=flops, bytes=nbytes)
    log(f"  A {shape} [{ainst}]: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}; {ms / bms:.2f}x), "
        f"{flops / ms / 1e9:.2f} TFLOP/s; plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms on the "
        f"same masked call ({ms / lib_ms:.3f}x)")
    if not ms < lib_ms:
        raise AssertionError(f"A bf16 D=256 at the training call: {ms:.4f} ms, not faster than "
                             f"sdpa's {lib_ms:.4f} ms on the same masked call")
    # yardstick only: SDPA on the masked call, KV repeated for the group
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2).detach().requires_grad_(True)
              for x in (k, v))
    mask = visibility_mask(qp, kp, causal=True, window=RG_WINDOW)[:, None]
    o_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    do_t = dout.transpose(1, 2)
    b_fns = (lambda: fa.flash_attention_bwd_dq_cuda(*args, **kw),
             lambda: fa.flash_attention_bwd_dkv_cuda(*args, **kw),
             lambda: fa.flash_attention_bwd_torch(q, k, v, qp, kp, out, lse, dout, dlse,
                                                  causal=True, window=RG_WINDOW, scale=scale,
                                                  block_q=blk, block_k=blk),
             lambda: torch.autograd.grad(o_t, (qt, kt, vt), do_t, retain_graph=True))
    ms_dq, ms_dkv, plain_bwd, lib_bwd = rg_timed(b_fns, (3, 3, 1, 3))
    binst = fa.flash_bwd_instance_built(bf, D)
    for name, ms_, per_pair, outs in (("dq", ms_dq, 6, (q,)), ("dkv", ms_dkv, 8, (k, v))):
        outs = [torch.empty(t.shape, device=dev) for t in outs]  # float32 gradients
        nbytes, flops = bwd_bytes_flops(q, k, qp, kp, True, RG_WINDOW, per_pair, outs)
        bms, by = bound(nbytes, flops, "bfloat16")
        rows[name] = dict(ms=ms_, plain_ms=plain_bwd, library_ms=lib_bwd, bound_ms=bms,
                          bound_by=by, max_abs_err=b_err, instance=binst,
                          device_kernel=f"rt::wgb::flash_bwd_{name}_wgmma_kernel<{D}>",
                          shape=shape, plain_and_library_compute="dq, dk and dv in one call",
                          flops=flops, bytes=nbytes)
        log(f"  B {name} {shape} [{binst}]: kernel {ms_:.3f} ms, bound {bms:.4f} ms "
            f"({by}; {ms_ / bms:.2f}x), {flops / ms_ / 1e9:.2f} TFLOP/s; plain backward "
            f"{plain_bwd:.3f} ms, sdpa backward {lib_bwd:.3f} ms")
    log(f"  B1 + B2 {shape} [{binst}]: {ms_dq + ms_dkv:.3f} ms against sdpa's whole backward "
        f"{lib_bwd:.3f} ms on the same masked call ({(ms_dq + ms_dkv) / lib_bwd:.3f}x)")
    del main, args, o_t, qt, kt, vt, mask, b_fns
    free_device_memory(torch)

    rows.update(rg_decode_rows(torch, dev, rnd, fwd_pair))
    free_device_memory(torch)
    return rows


# Kernel A's D-256 decode beyond recurrentgemma's 10/1 heads (B, Sq, Sk,
# Hq, Hkv, window): 1 to 16 rows a KV head, an Sk that is no multiple of a
# tile, a window, a batch row of padding keys.
RG_DECODE_CASES = [(3, 1, 296, 1, 1, None), (3, 4, 296, 4, 1, 128), (2, 1, 296, 16, 1, None),
                   (3, 3, 328, 8, 2, 64)]
# Phase 20 (d)'s decode reads 256 to 320 live keys of the 2048 slots
RG_DECODE_SHORT = [RG_PROMPT_LEN + 9 * i for i in range(RG_PROMPTS)]


def rg_decode_rows(torch, dev, rnd, fwd_pair):
    """Phase 20 (a)'s decode part: A's D-256 decode instances (float32: the
    split kernel; bf16: the cluster instance) at group 10 x Sq 1 over a
    2048-slot ring buffer (wrapped rows, a half-filled row, a row that sees
    no key) and on ``RG_DECODE_CASES``, each run twice and bitwise equal
    (``fwd_pair``), then the main path's call timed in bf16 over a full
    buffer and at phase 20 (d)'s lengths, beside the plain version, SDPA's
    masked call and the bound; fails unless the full-buffer call beats
    SDPA.  Returns the rows ``decode`` and ``decode_short``."""
    from repro_torch.kernels import flash_attention as fa

    Hq, Hkv, D = RG_HEADS
    scale = 1.0 / D ** 0.5
    bf, f32 = torch.bfloat16, torch.float32
    lengths = [3000, 700, 2100, 0, 2048, 1]
    qp, kp = rg_ring_positions(torch, dev, lengths)
    B = len(lengths)
    q32, k32, v32 = rnd((B, 1, Hq, D)), rnd((B, RG_WINDOW, Hkv, D)), rnd((B, RG_WINDOW, Hkv, D))
    for dtype in (f32, bf):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        got, want = fwd_pair(q, k, v, qp, kp, RG_WINDOW)
        name = {f32: "f32", bf: "bf16"}[dtype]
        compare(f"A {name} D=256 decode g10 Sq=1 ring buffer of {RG_WINDOW} slots, lengths "
                f"{lengths} [{fa.decode_core_instance(dtype, D)}] bitwise repeatable", got,
                want, **tolerances(dtype))
        if not torch.isneginf(got[1][3]).all():
            raise AssertionError("A D=256 decode: the row with no key is not dead")
    # the main path's decode call, timed: its 8 rows against a full, wrapped
    # buffer of 2048 slots (the steady state of a long decode), then at the
    # lengths of phase 20 (d)'s own steps
    Bd = RG_PROMPTS
    rows = {}
    for key, lens in (("decode", [RG_WINDOW + 37 * i for i in range(Bd)]),
                      ("decode_short", RG_DECODE_SHORT)):
        qp, kp = rg_ring_positions(torch, dev, lens)
        q, k, v = (rnd(s, bf) for s in ((Bd, 1, Hq, D), (Bd, RG_WINDOW, Hkv, D),
                                       (Bd, RG_WINDOW, Hkv, D)))
        got, want = fwd_pair(q, k, v, qp, kp, RG_WINDOW)
        fill = "full" if key == "decode" else f"lengths {lens[0]}-{lens[-1]}"
        shape = f"B={Bd} Sq=1 Sk={RG_WINDOW} Hq={Hq} Hkv={Hkv} D={D} bf16 ring buffer {fill}"
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per, g = fa.decode_rule_d256(RG_WINDOW, fa.decode_units(Bd, Hq, Hkv, 1), sms)
        err = compare(f"A bf16 D=256 decode main path {shape} [cluster: {g} blocks a unit, "
                      f"{per} tiles each] bitwise repeatable", got, want, **tolerances(bf))
        fns = (lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True,
                                                   window=RG_WINDOW, scale=scale),
               lambda: fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=True,
                                                    window=RG_WINDOW, scale=scale, block_k=512),
               sdpa_masked(torch, q, k, v, qp, kp, RG_WINDOW))
        ev = rg_timed(fns, (10, 3, 10))
        (ms, plain_ms, lib_ms), how = device_times(*zip(fns, (30, 3, 30)))
        nbytes, flops = flash_bytes_flops(q, k, qp, kp, True, RG_WINDOW)
        bms, by = bound(nbytes, flops, "bfloat16")
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, max_abs_err=err, instance="decode",
                         core=fa.decode_core_instance(bf, D), blocks_per_unit=g,
                         tiles_per_block=per, shape=shape, timing=how, event_ms=ev[0],
                         event_plain_ms=ev[1], event_library_ms=ev[2], bytes=nbytes)
        log(f"  A {shape} [decode, cluster]: device kernel {ms:.4f} ms ({ms / bms:.2f}x its "
            f"bound), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.3f}x); events "
            f"kernel {ev[0]:.4f} ms, sdpa {ev[2]:.4f} ms; bound {bms:.4f} ms ({by}) at {how}")
        del q, k, v, got, want, fns
    d = rows["decode"]
    if not d["ms"] < d["library_ms"]:
        raise AssertionError(f"A bf16 D=256 decode over a full buffer: {d['ms']:.4f} ms, not "
                             f"faster than sdpa's {d['library_ms']:.4f} ms on the same masked "
                             "call")
    free_device_memory(torch)
    # 1 to 16 rows a KV head, ragged Sk, windows, a batch row of padding keys
    for B, Sq, Sk, hq, hkv, window in RG_DECODE_CASES:
        q32, k32, v32 = rnd((B, Sq, hq, D)), rnd((B, Sk, hkv, D)), rnd((B, Sk, hkv, D))
        kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
        kp[-1] = PAD_POS
        qp = (Sk - Sq + torch.arange(Sq, device=dev, dtype=torch.int32)).expand(B, Sq)
        qp = qp.contiguous()
        for dtype in (f32, bf):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            got, want = fwd_pair(q, k, v, qp, kp, window)
            compare(f"A {str(dtype)[6:]} D=256 decode B={B} Sq={Sq} Sk={Sk} {hq}/{hkv} heads "
                    f"({hq // hkv * Sq} rows a KV head) window={window}, a row of padding keys "
                    f"[{fa.decode_core_instance(dtype, D)}] bitwise repeatable", got, want,
                    **tolerances(dtype))
    return rows

def phase_rg_checked(torch, dev, cfg=None, B=2, S=4096):
    """Phase 20 (b): recurrentgemma at full width, ``RG_CHECK_LAYERS``
    layers (one superblock and the 2-layer tail), float32, remat "full":
    the loss and every gradient leaf on the kernels at SP 1 and through 4
    virtual ranks (the window halo over two predecessor shards, the
    RG-LRU's scan) against the plain path at SP 1, each kernel run twice and
    bitwise equal (deterministic algorithms on), launches as
    ``train_launches_per_step``; phase 8's float32 limits."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import batch_to_device

    cfg = cfg or ARCHS[RG].with_(n_layers=RG_CHECK_LAYERS, dtype="float32")
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    params = plain.init(0, training=True)
    batch = batch_to_device(next(SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1, layout=cfg.layout))), dev)
    (l_plain, _), g_plain = value_and_grad(plain.loss, params, batch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for P in (1, 4):
            bundle = build_model(cfg, ParallelContext(device="cuda", sp_degree=P,
                                                      layout=cfg.layout))
            want = train_launches_per_step(cfg, sp_computes(cfg, "tokenring", P))
            runs = []
            for _ in range(2):
                reset_launch_counts()
                (loss, _), grads = value_and_grad(bundle.loss, params, batch)
                torch.cuda.synchronize()
                if launch_counts() != want:
                    raise AssertionError(f"phase 20 (b) P={P}: launches {launch_counts()}, "
                                         f"expected {want}")
                runs.append((loss, grads))
            (loss, grads), (loss2, grads2) = runs
            if not (torch.equal(loss, loss2) and all(
                    torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(grads),
                                                                named_leaves(grads2)))):
                raise AssertionError(f"phase 20 (b) P={P}: loss or gradients not bitwise "
                                     "repeated")
            l_err = abs(float(loss) - float(l_plain))
            # the same float32 ops but attention's sums (and at P = 4 the
            # scan's cross-rank composition) in another order: phase 8's
            # float32 limits
            if not (math.isfinite(float(loss)) and l_err <= 1e-5 * abs(float(l_plain))):
                raise AssertionError(f"phase 20 (b) P={P}: loss {float(loss)} vs the plain "
                                     f"path's {float(l_plain)}")
            worst = worst_leaf(torch, grads, g_plain, 1e-4)
            halo = (f", window halo {math.ceil((cfg.window - 1) / (S // P))} shards and the "
                    "scan over the ring" if P > 1 else "")
            log(f"  ok phase 20 recurrentgemma {cfg.n_layers} layers f32 B={B} S={S} P={P}"
                f"{halo}: loss {float(loss):.6f} vs plain {float(l_plain):.6f} (|err| "
                f"{l_err:.2e}); worst gradient leaf off by {worst:.2e} of its max; bitwise "
                f"repeated; launches {want}")
            del runs, grads, grads2
            free_device_memory(torch)
    finally:
        torch.use_deterministic_algorithms(False)


def rg_blocks(params):
    """``(kind, temporal block, mlp block)`` of every layer in order."""
    out = []
    for p_s in params["supers"]:
        out += [("rec", p_s["rec1"], p_s["mlp1"]), ("rec", p_s["rec2"], p_s["mlp2"]),
                ("attn", p_s["attn"], p_s["mlp3"])]
    out += [("rec", p_t["rec"], p_t["mlp"]) for p_t in params.get("tail", ())]
    return out


# A layer's forward pass fed the decode's own inputs, against the decode:
# as MAMBA_LAYER_LIMIT (cuBLAS sums a product of 8 rows in another order
# than one of 8 x 320, the float32 scan's order, and the attention layer's
# decode core, with float32 P, against the wgmma instance, which rounds P
# to bf16 for its P V product, over the same keys).
RG_LAYER_LIMIT = MAMBA_LAYER_LIMIT


def phase_rg_decode(torch, dev, prompts=RG_PROMPTS, prompt_len=RG_PROMPT_LEN, steps=RG_STEPS,
                    cfg=None):
    """Phase 20 (d): recurrentgemma-2b at full width and depth (bf16):
    ``prompts`` prompts of ``prompt_len`` tokens fed through
    ``bundle.decode_step`` one token a step, then ``steps`` greedy tokens; 8
    launches of A's D-256 decode instance a step; every layer's forward
    pass (its temporal block, then its MLP block) fed the decode's own
    inputs within ``RG_LAYER_LIMIT`` of the decode's outputs; the
    end-to-end logits against the forward pass logged, not gated (as phase
    19's); the engine refuses the bundle."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models import rglru as R
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serving.engine import ServingEngine

    cfg = cfg or ARCHS[RG]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, {weight_bytes / 1e9:.2f} GB of weights, seeded "
        f"init {time.perf_counter() - t0:.1f} s; {prompts} prompts of {prompt_len} tokens, then "
        f"{steps} greedy tokens, one token a step")
    gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (prompts, prompt_len), generator=gen, device=dev,
                           dtype=torch.int32)
    state = bundle.init_serve_state(prompts, 0, dev)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    blocks = rg_blocks(params)
    L = len(blocks)
    # every MLP block's input and output of every step, kept by reference:
    # layer l's temporal block maps its input (layer l-1's MLP output, the
    # embedding at l = 0) to MLP l's input
    mlp_in, mlp_out = [[] for _ in range(L)], [[] for _ in range(L)]
    calls = [0]
    real_mlp = R._mlp_block

    def recording_mlp(p, x, *, cfg):
        out = real_mlp(p, x, cfg=cfg)
        layer = calls[0] % L
        calls[0] += 1
        mlp_in[layer].append(x)
        mlp_out[layer].append(out)
        return out

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, fed, marks = [], [], []

    def step(tok):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = bundle.decode_step(params, tok, state)
        end.record()
        marks.append((start, end))
        rows.append(logits.float())

    R._mlp_block = recording_mlp
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt_len):
            step(tokens[:, t])
        torch.cuda.synchronize()
        t_prompt = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = rows[-1].argmax(-1).to(torch.int32)
            fed.append(tok)
            step(tok)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    finally:
        R._mlp_block = real_mlp
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    n_attn = attention_calls(cfg)
    want = {"flash_attention_fwd": n_attn * (prompt_len + steps), "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    if got != want:
        raise AssertionError(f"phase 20 decode: launches {got}, expected {want}")
    step_ms = [s.elapsed_time(e) for s, e in marks]
    med = statistics.median(step_ms)
    dec = torch.stack(rows, 1)
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError("phase 20 decode: non-finite logits")
    seq = torch.cat([tokens, torch.stack(fed, 1)], dim=1)
    T = seq.shape[1]
    positions = torch.arange(T, device=dev, dtype=torch.int32).expand(prompts, T).contiguous()
    dt = torch.bfloat16
    layer_err, drift = [], {}
    with torch.no_grad():
        x = params["embed"]["table"][seq.long()].to(dt)
        xin = x
        for l, (kind, p_t, p_m) in enumerate(blocks):
            mid, xout = torch.cat(mlp_in[l], 1), torch.cat(mlp_out[l], 1)
            if kind == "rec":
                forced = R._rec_block(p_t, xin, cfg=cfg, pctx=bundle.pctx)
            else:
                forced = R._attn_block(p_t, xin, positions, cfg=cfg, pctx=bundle.pctx)
            forced = R._mlp_block(p_m, forced, cfg=cfg).float()
            update = (xout.float() - xin.float()).norm()
            layer_err.append(float((forced - xout.float()).norm() / update))
            x = (R._rec_block(p_t, x, cfg=cfg, pctx=bundle.pctx) if kind == "rec" else
                 R._attn_block(p_t, x, positions, cfg=cfg, pctx=bundle.pctx))
            x = R._mlp_block(p_m, x, cfg=cfg)
            drift[l + 1] = float((x.float() - xout.float()).norm() / xout.float().norm())
            xin = xout
            mlp_in[l] = mlp_out[l] = None
        x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        fwd = (x @ params["embed"]["table"].T.to(dt)).float()
    top = fwd.max(-1).values
    gap = top - fwd.gather(-1, dec.argmax(-1, keepdim=True))[..., 0]
    ratio = float((gap / (top - fwd.mean(-1))).max())
    flips = int((gap > 0).sum())
    del fwd, x
    worst = max(layer_err)
    kinds = [k for k, _, _ in blocks]
    log(f"  decode: prompt fed at {prompts * prompt_len / t_prompt:.1f} tok/s, greedy "
        f"{prompts * steps / t_gen:.1f} tok/s; median step {med:.3f} ms (CUDA events; weight-read "
        f"bound {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); state {state_bytes / 2**20:.1f} "
        f"MiB (ring buffers of {cfg.window} slots); peak {peak / 2**30:.2f} GiB; launches {got}")
    log(f"  each layer's forward pass fed the decode's inputs ({dec.shape[0] * dec.shape[1]} "
        f"positions): worst {worst:.2e} of the layer's update (layer {layer_err.index(worst)}, "
        f"{kinds[layer_err.index(worst)]}; limit {RG_LAYER_LIMIT}), median "
        f"{statistics.median(layer_err):.2e}; attention layers "
        + ", ".join(f"{e:.1e}" for e, k in zip(layer_err, kinds) if k == "attn"))
    log("  free-running forward against the decode, relative L2 by depth: "
        + ", ".join(f"{d}: {v:.2e}" for d, v in drift.items() if d in (1, 2, 3, 6, 12, 24, L))
        + f"; at the head {flips} of {dec.shape[0] * dec.shape[1]} positions not the forward's "
        f"argmax, largest gap {ratio:.4f} of the row spread (logged, not gated)")
    if not worst <= RG_LAYER_LIMIT:
        raise AssertionError(f"phase 20 decode: layer {layer_err.index(worst)}'s forward pass "
                             f"is {worst:.3e} of its update off the decode steps")
    try:
        ServingEngine(bundle, params, max_batch=prompts, max_len=512, device=dev)
    except NotImplementedError as e:
        if "rolled back" not in str(e):
            raise
        log(f"  the engine refuses the bundle: {e}")
    else:
        raise AssertionError("phase 20: the engine served a recurrent family")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": prompts, "prompt_len": prompt_len,
           "steps": steps, "prompt_tokens_per_s": prompts * prompt_len / t_prompt,
           "tokens_per_s": prompts * steps / t_gen, "median_step_ms": med,
           "weight_bytes": weight_bytes,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "state_bytes": state_bytes, "peak_bytes": peak, "launches": got,
           "positions": dec.shape[0] * dec.shape[1], "layer_rel_err_max": worst,
           "layer_rel_err_median": statistics.median(layer_err), "drift_by_depth": drift,
           "head_flips": flips, "head_max_gap_over_spread": ratio}
    log("RESULT decoding_rg " + json.dumps(res))
    return {**got, "paged_decode_fwd": 0}


def phase_rg_wrap(torch, dev, cfg=None, n_tokens=RG_WRAP_TOKENS):
    """Phase 20 (e): the ring buffer wraps on the card.  recurrentgemma at
    full width, one superblock, float32: one row fed ``n_tokens`` tokens by
    ``decode_step`` (past slot 2048 each step overwrites the token 2048
    positions back), every step's logits against the windowed forward pass
    over the same tokens at the same position (atol and rtol 1e-3, phase
    19's float32 decode limit)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models import rglru as R
    from repro_torch.models.registry import build_model

    cfg = cfg or ARCHS[RG].with_(n_layers=3, dtype="float32")
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    params = bundle.init(0)
    gen = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (1, n_tokens), generator=gen, device=dev,
                           dtype=torch.int32)
    state = bundle.init_serve_state(1, 0, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = [bundle.decode_step(params, tokens[:, t], state)[0] for t in range(n_tokens)]
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if launch_counts()["flash_attention_fwd"] != n_tokens * attention_calls(cfg):
        raise AssertionError(f"phase 20 (e): launches {launch_counts()}")
    wrapped = int((state["pos"][0] >= cfg.window).sum())
    if not (int(state["len"][0]) == n_tokens and wrapped == n_tokens - cfg.window
            and int(state["pos"][0].min()) == n_tokens - cfg.window):
        raise AssertionError(f"phase 20 (e): ring buffer holds positions "
                             f"{int(state['pos'][0].min())}..{int(state['pos'][0].max())}")
    positions = torch.arange(n_tokens, device=dev, dtype=torch.int32)[None].contiguous()
    worst, worst_at, chunk = 0.0, -1, 256
    with torch.no_grad():
        x = R.rg_apply(params, tokens, positions, cfg=cfg, pctx=bundle.pctx)
        w = params["embed"]["table"].T
        for c0 in range(0, n_tokens, chunk):
            fwd = x[0, c0:c0 + chunk] @ w
            dec = torch.cat(rows[c0:c0 + chunk], 0)
            err = (dec - fwd).abs() / (1e-3 + 1e-3 * fwd.abs())
            e, at = err.max(-1).values.max(0)
            if float(e) > worst:
                worst, worst_at = float(e), c0 + int(at)
    if not worst <= 1.0:
        raise AssertionError(f"phase 20 (e): decode logits off the windowed forward at position "
                             f"{worst_at} ({worst:.3f} of the limit 1e-3 + 1e-3 |logit|)")
    log(f"  ok phase 20 ring buffer: {cfg.n_layers} layers f32, one row fed {n_tokens} tokens "
        f"by decode_step ({t_dec:.1f} s), {wrapped} slots overwritten past {cfg.window}; every "
        f"step's logits within {worst:.3f} of the limit (1e-3 + 1e-3 |logit|) of the windowed "
        f"forward pass (worst at position {worst_at}); launches {launch_counts()}")


def phase_build(torch, dev):
    """Phase 2: build every kernel, log ptxas's registers and spills, and
    fail on a spill or a C7512 in any wgmma instance of A, B1 or B2, or a
    spill in the decode core's cluster instance or in A's, B1's and B2's
    CUDA-core instances (each instance found at every head dim); log the cluster instance's
    registers, shared memory and the clusters the card admits at once."""
    from repro_torch.kernels._build import build_all

    info = build_all()
    log(f"  built {info['built']} in {info['seconds']:.2f} s")
    for name, text in info["ptxas"].items():
        for line in text.splitlines():
            if any(x in line for x in ("registers", "spill", "Compiling entry", "C75")):
                log(f"  ptxas {name}: {line.strip()}")
    faults = ptxas_wgmma_faults(info["ptxas"])
    if faults:
        raise AssertionError("ptxas: a gated instance spills or serialises its wgmma:\n  "
                             + "\n  ".join(faults))
    wgmma = {n: f for t in info["ptxas"].values() for n, f in ptxas_functions(t).items()
             if "wgmma_kernel" in n}
    bwd_regs = {n.split("_wgmma_kernel")[0].rsplit("flash_bwd_", 1)[-1]: f["registers"]
                for n, f in wgmma.items() if "bwd" in n and "ILi256E" in n}
    if "flash_bwd" in info["ptxas"] and len(bwd_regs) != 2:
        raise AssertionError(f"ptxas: expected B1's and B2's D-256 wgmma instances, found "
                             f"{sorted(bwd_regs)}")
    fwd_regs = [f["registers"] for n, f in wgmma.items() if "flash_fwd" in n and "ILi256E" in n]
    if "flash_fwd" in info["ptxas"] and len(fwd_regs) != 1:
        raise AssertionError(f"ptxas: expected one D-256 wgmma instance of A, found "
                             f"{len(fwd_regs)}")
    log(f"  ptxas: no spill and no C7512 in the {len(wgmma)} wgmma instances of A, B1 and B2 "
        "built here")
    core = {(lib, n.split("_core_kernel")[0].rsplit("flash_", 1)[-1],
             "bf16" if "bfloat16" in n else "f32", int(n.split("Li")[1].split("E")[0])):
            f["registers"] for lib, t in info["ptxas"].items()
            for n, f in ptxas_functions(t).items() if any(k in n for k in CORE_KERNELS)}
    want = {(lib, kern, dt, D)
            for lib, kern in (("flash_fwd", "fwd"), ("flash_bwd", "bwd_dq"),
                              ("flash_bwd", "bwd_dkv"))
            if lib in info["ptxas"] for dt, D in (("f32", 32), ("f32", 64), ("f32", 128),
                                                  ("f32", 256), ("bf16", 32))}
    if set(core) != want:
        raise AssertionError(f"ptxas: expected A's, B1's and B2's CUDA-core instances "
                             f"{sorted(want)}, found {sorted(core)}")
    log("  A's, B1's and B2's CUDA-core instances (256 threads, register-tiled FFMA, 2-stage "
        "cp.async ring), no spill; ptxas registers " + ", ".join(
            f"{kern} {dt} D={D}: {r}" for (_, kern, dt, D), r in sorted(core.items())))
    from repro_torch.kernels import flash_attention as fa

    log("  kernel A wgmma instance at D=64/128: 384 threads (producer warpgroup at 40 "
        "registers, two consumer warpgroups at 232 by setmaxnreg), 128-key tiles; dynamic "
        f"shared memory {fa.flash_fwd_smem_bytes(128, 4096)} B at D=128, "
        f"{fa.flash_fwd_smem_bytes(64, 4096)} B at D=64 (Sk=4096)")
    S_rg = RG_TRAIN_SHAPE["S"]
    tiling = fa.wgmma_fwd_tiling(256)
    log(f"  kernel A wgmma instance at D=256 (column split): 384 threads, ptxas registers "
        f"{fwd_regs} (the launch bound; producer warpgroup at 24, two consumer warpgroups at "
        f"240 by setmaxnreg), {tiling['q_rows']}-row q-tiles held by both consumers, each "
        f"forming S and {tiling['o_cols']} of O's columns, {tiling['keys']}-key tiles; dynamic "
        f"shared memory {fa.flash_fwd_smem_bytes(256, S_rg)} B at Sk={S_rg} (limit 232448)")
    log("  kernels B1/B2 wgmma instances: 384 threads (producer warpgroup at 24 registers, two "
        "consumer warpgroups at 240 by setmaxnreg)")
    log(f"  B1/B2 wgmma at D=256 (column split): 384 threads, ptxas registers {bwd_regs} "
        "(the launch bound; consumers 240 by setmaxnreg); B1 64-row q-tiles, each consumer "
        "warpgroup 128 of dQ's columns, dynamic shared memory "
        f"{fa.flash_bwd_smem_bytes('dq', 256, S_rg)} B at Sk={S_rg}; B2 two blocks a 64-key "
        "tile, each 128 of dK's and dV's columns, dynamic shared memory "
        f"{fa.flash_bwd_smem_bytes('dkv', 256, S_rg)} B at Sq={S_rg} (limit 232448)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("  decode core (A's decode instance, kernel C; csrc/decode.cuh): 128 threads a block, "
        "32-key tiles through a 3-stage cp.async ring, splits aiming at "
        f"{fa.DECODE_BLOCKS_PER_SM} blocks per SM ({sms} SMs)")
    cluster = {lib: [f["registers"] for n, f in ptxas_functions(t).items()
                     if CLUSTER_KERNEL in n] for lib, t in info["ptxas"].items()}
    for lib in ("flash_fwd", "paged_decode"):
        if lib in info["ptxas"] and len(cluster[lib]) != 1:
            raise AssertionError(f"ptxas: expected one cluster instance of the decode core in "
                                 f"{lib}, found {len(cluster[lib])}")
    admitted = {}
    from repro_torch.analysis.kernel_lint import CLUSTER_SIZES

    for g in CLUSTER_SIZES:
        admitted[g], smem = fa.decode_cluster_occupancy(g)
    per, g = fa.decode_rule_d256(RG_WINDOW, RG_PROMPTS, sms)
    log(f"  decode core's cluster instance (bf16 D=256; csrc/decode_d256.cuh): 160 threads (a "
        f"producer warp, four mma.sync consumer warps), ptxas registers {cluster}, no spill; "
        f"dynamic shared memory {smem} B (a 4-stage TMA ring of 32-key K and V tiles); the card "
        f"holds {admitted} clusters of {list(admitted)} blocks at once; the main call "
        f"(B={RG_PROMPTS}, {RG_WINDOW} keys) takes {RG_PROMPTS} clusters of {g} blocks, "
        f"{per} tiles each")
    if admitted[g] < RG_PROMPTS:
        raise AssertionError(f"the card holds {admitted[g]} clusters of {g} blocks of the decode "
                             f"core's cluster instance at once: the main call's {RG_PROMPTS} do "
                             "not fit one wave")
    smem_against_library(torch, dev, sms)


def smem_against_library(torch, dev, sms):
    """Phase 2 (b): the kernel lint's closed form of every instance's shared
    memory (``kernel_lint.smem_estimate``) equal, byte for byte, to the
    built library's own figure: the wgmma instances of A, B1 and B2 at the
    main paths' lengths (``launch.analyze.FLASH_CALLS``), at the longest each
    admits (``kernel_lint.max_length``) and one tile past it, where the
    figure passes the opt-in maximum and A, B1 and B2 at D 256 refuse the
    launch (``cudaErrorInvalidValue``); A's, B1's and B2's CUDA-core
    instances at every head dim they are built for; the cluster instance; the split
    decode kernel, dense and paged, at every row layout and split it takes."""
    from repro_torch.analysis import kernel_lint as kl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.analyze import FLASH_CALLS, PAGED_CALLS

    budget = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    lib = {"fwd_wgmma": lambda D, S: fa.flash_fwd_smem_bytes(D, S),
           "bwd_dq_wgmma": lambda D, S: fa.flash_bwd_smem_bytes("dq", D, S),
           "bwd_dkv_wgmma": lambda D, S: fa.flash_bwd_smem_bytes("dkv", D, S)}
    checked, mismatches, longest = 0, [], {}

    def hold(what, closed, built):
        nonlocal checked
        checked += 1
        if closed != built:
            mismatches.append(f"{what}: closed form {closed} B, library {built} B")

    for inst, figure in lib.items():
        for D in (64, 128, 256):
            calls = [c for c in FLASH_CALLS if c[2] == D and fa.flash_fwd_instance(
                c[1], c[4], D) == "wgmma" and (inst == "fwd_wgmma" or c[8])]
            lengths = {c[5] if inst != "bwd_dkv_wgmma" else c[4] for c in calls}
            top = kl.max_length(inst, D, min(budget, kl.KMAX_SMEM))
            longest[f"{inst}[D={D}]"] = top
            for S in sorted(lengths) + [1, top, top + 1]:
                hold(f"{inst} D={D} S={S}", kl.smem_estimate(inst, D, S), figure(D, S))
            if figure(D, top) > kl.KMAX_SMEM or figure(D, top + 1) <= kl.KMAX_SMEM:
                mismatches.append(f"{inst} D={D}: {top} is not the longest length the library "
                                  "admits")
    for kern, inst in (("fwd", "fwd_cuda_core"), ("dq", "bwd_dq_cuda_core"),
                       ("dkv", "bwd_dkv_cuda_core")):
        for dt, D in ((torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
                      (torch.float32, 256), (torch.bfloat16, 32)):
            hold(f"{inst} {str(dt)[6:]} D={D}", kl.smem_estimate(inst, D, dtype=dt),
                 fa.core_smem_bytes(kern, dt, D))
    hold("decode_cluster", kl.smem_estimate("decode_cluster", 256), fa.decode_cluster_occupancy(
        fa.DECODE_D256_MAX_CLUSTER)[1])
    splits = {(c[1], c[2], c[6] // c[7] * c[4], False,
               fa.decode_split_rule(c[5], fa.decode_units(c[3], c[6], c[7], c[4]), sms)[0])
              for c in FLASH_CALLS if c[4] <= fa.DECODE_MAX_SQ}
    splits |= {(c[1], c[2], c[4] // c[5], True,
                fa.decode_split_rule(c[7] * c[6], fa.decode_units(c[3], c[4], c[5], 1), sms)[0])
               for c in PAGED_CALLS}
    for dt in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128, 256):
            for rows in (1, 2, 3, 4, 8, 10, 16, 32, 64):
                for paged in (False, True):
                    for tps in (1, 7, fa.DECODE_MAX_SPLIT_TILES):
                        splits.add((dt, D, rows, paged, tps))
    for dt, D, rows, paged, tps in sorted(splits, key=str):
        if fa.decode_core_instance(dt, D) == "cluster" or (D == 256 and rows > 16):
            continue
        hold(f"decode_split {str(dt)[6:]} D={D} rows={rows} paged={paged} tps={tps}",
             kl.smem_estimate("decode_split", D, tps * fa.DECODE_TILE_KEYS, dtype=dt, rows=rows,
                              paged=paged),
             fa.decode_split_smem_bytes(dt, D, rows, tps, paged=paged))
    if mismatches:
        raise AssertionError("phase 2: the kernel lint's shared memory disagrees with the built "
                             "library:\n  " + "\n  ".join(mismatches))
    # One tile past the longest length, the library refuses the launch.
    refused = []
    bf = torch.bfloat16
    for inst, (Sq, Sk) in (("fwd_wgmma", (64, longest["fwd_wgmma[D=256]"] + 1)),
                           ("bwd_dq_wgmma", (64, longest["bwd_dq_wgmma[D=256]"] + 1)),
                           ("bwd_dkv_wgmma", (longest["bwd_dkv_wgmma[D=256]"] + 1, 64))):
        q = torch.zeros((1, Sq, 1, 256), dtype=bf, device=dev)
        k = torch.zeros((1, Sk, 1, 256), dtype=bf, device=dev)
        qp = torch.zeros((1, Sq), dtype=torch.int32, device=dev)
        kp = torch.zeros((1, Sk), dtype=torch.int32, device=dev)
        rows = torch.zeros((1, Sq, 1), dtype=torch.float32, device=dev)
        try:
            if inst == "fwd_wgmma":
                fa.flash_attention_fwd_cuda(q, k, k, qp, kp, causal=False, window=None,
                                            scale=1.0)
            elif inst == "bwd_dq_wgmma":
                fa.flash_attention_bwd_dq_cuda(q, k, k, qp, kp, q, rows, rows, rows,
                                               causal=False, window=None, scale=1.0)
            else:
                fa.flash_attention_bwd_dkv_cuda(q, k, k, qp, kp, q, rows, rows, rows,
                                                causal=False, window=None, scale=1.0)
        except RuntimeError as e:
            if not str(e).endswith("cudaError_t 1"):
                raise
            refused.append(f"{inst} at {Sk if inst != 'bwd_dkv_wgmma' else Sq}")
        else:
            raise AssertionError(f"phase 2: {inst} at D 256 launched one tile past the longest "
                                 "length the kernel lint admits")
        del q, k, qp, kp, rows
    torch.cuda.synchronize()
    log(f"  kernel lint: {checked} shared-memory figures of the built library equal to the "
        f"closed forms (opt-in maximum {budget} B); longest admitted lengths {longest}; one "
        f"tile past them the D-256 launches refuse ({', '.join(refused)})")


def phase_analysis(torch, dev):
    """Phase 21: the static analysis gate on the card: every pass of
    ``repro_torch.launch.analyze`` with the card's limits and the build's
    ptxas report; fails on any finding."""
    from repro_torch.launch.analyze import run_analysis

    t0 = time.perf_counter()
    report = run_analysis(device="cuda")
    seconds = time.perf_counter() - t0
    log("  " + report.render().replace("\n", "\n  "))
    if not report.ok:
        raise AssertionError(f"phase 21: {len(report.findings)} finding(s) of the static "
                             "analysis gate")
    log("RESULT analysis " + json.dumps({"checked": dict(report.checked),
                                         "findings": len(report.findings),
                                         "seconds": round(seconds, 3)}))


# ---------------------------------------------------------------------------
# phase 22: data parallelism with FSDP storage over the virtual (data, model)
# mesh, each layer gathered just in time inside its remat region
# ---------------------------------------------------------------------------

DP_MESH = dict(data_degree=2, sp_degree=4)  # the virtual (data 2, model 4) mesh
DP_BATCH = 4  # global batch: 2 rows a data rank
DP_CHECK_LAYERS = 2
DP_CHECK_SEQ = 512
DP_STEPS = 2  # timed steps of (b), after one warmup
DP_ELASTIC_SEQ = 512
# (a)'s configs, one a layer loop, at full width: lm_apply's, the encoder's
# and decoder's, the SSM's, and the hybrid's (one superblock and the 2-layer
# tail)
DP_CHECK_CASES = (("qwen3-1.7b", dict(n_layers=DP_CHECK_LAYERS)),
                  ("whisper-base", dict(n_layers=DP_CHECK_LAYERS,
                                        n_enc_layers=DP_CHECK_LAYERS)),
                  (MAMBA, dict(n_layers=DP_CHECK_LAYERS)),
                  (RG, dict(n_layers=RG_CHECK_LAYERS)))
DP_LLAMA_LAYERS = 18  # of llama2-7b's 32: the whole-tree gather's step cannot fit
DP_LLAMA_BATCH = 2  # one row a data rank


def dp_trainer(torch, cfg, **pctx_kw):
    """A ``Trainer`` of ``cfg`` through TokenRing on the virtual mesh
    ``pctx_kw`` (``DP_MESH`` by default), on the card; a windowed config's
    layers take the window halo in its contiguous layout."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    layout = cfg.layout if cfg.window else ParallelContext.layout
    pctx = ParallelContext(device="cuda", strategy="tokenring", layout=layout,
                           **(pctx_kw or DP_MESH))
    return Trainer(build_model(cfg, pctx), TrainerConfig(lr=3e-4, warmup_steps=1,
                                                         total_steps=1 + DP_STEPS))


def dp_loss_and_grads(trainer, state, batch):
    """The FSDP step's loss and its gradients (the leaves outside the layer
    stacks gathered, each layer gathered in its loop, loss, backward,
    reduce-scatters), the gradients assembled into the full tree."""
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.sharding import unshard_tree

    (_, m), grads = value_and_grad(trainer._loss, state["params"], batch)
    return m["loss"], unshard_tree(grads, trainer.params_layout)


def dp_gates(label, pctx, layout, cfg, steps=1):
    """The mesh ledger against the closed forms: the data-axis bytes a step,
    rank and direction (``fsdp_comm_bytes`` at ``cfg.remat``) and the
    high-water of the gathered bytes alive (``fsdp_gathered_bytes``: the
    leaves outside the layer stacks and one layer).  Returns ``(bytes a
    step, high-water)``."""
    from repro_torch.sharding import fsdp_comm_bytes, fsdp_gathered_bytes

    ledger = pctx.storage.ledger
    step = {w: v / steps for w, v in ledger.class_bytes["data"].items()}
    closed = fsdp_comm_bytes(layout, cfg.remat)
    if any(abs(step[w] - closed[w]) > 1e-9 * closed[w] for w in ("fwd", "bwd")):
        raise AssertionError(f"{label}: data-axis bytes a step {step}, closed form {closed}")
    if ledger.gathered_high != fsdp_gathered_bytes(layout):
        raise AssertionError(f"{label}: {ledger.gathered_high} gathered bytes alive at once, "
                             f"closed form {fsdp_gathered_bytes(layout)}")
    return step, ledger.gathered_high


def phase_dp_checked(torch, dev, cfg, B=DP_BATCH, S=DP_CHECK_SEQ):
    """Phase 22 (a): one FSDP loss-and-gradient pass of ``cfg`` (full
    width, a few layers, float32, remat "full") on the virtual (2, 4) mesh
    through TokenRing (the window halo for a windowed config) on the
    kernels, twice (bitwise equal, deterministic algorithms on), against
    the plain path on one rank and the whole batch (phase 8's limits);
    launches equal to the ring's Computes; the data-axis ledger equal to
    ``fsdp_comm_bytes`` (each layer gathered again in its recompute) and
    the gathered high-water to ``fsdp_gathered_bytes``."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.trainer import batch_to_device

    trainer = dp_trainer(torch, cfg)
    pctx = trainer.bundle.pctx
    params = trainer.bundle.init(0, training=True)
    p_plain = tree_map(lambda t: t.detach().clone(), params)
    state = trainer.state_from_params(params)
    del params
    batch = batch_to_device(next(train_data(cfg, SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1, layout=cfg.layout,
        sp_degree=pctx.sp_degree))), dev)
    label = f"phase 22 (a) {cfg.name}"
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            pctx.storage.ledger.reset()
            before = launch_counts()
            loss, grads = dp_loss_and_grads(trainer, state, batch)
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in launch_counts().items()}
            runs.append((loss, grads, ran))
    finally:
        torch.use_deterministic_algorithms(False)
    (l_kern, g_kern, ran), (l_again, g_again, _) = runs
    if not (torch.equal(l_kern, l_again) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g_kern), tree_leaves(g_again)))):
        raise AssertionError(f"{label}: the second FSDP pass is not bitwise the first")
    want = train_launches_per_step(cfg, sp_computes(cfg, "tokenring", pctx.sp_degree))
    if ran != want:
        raise AssertionError(f"{label}: launches {ran}, expected {want}")
    data_bytes, high = dp_gates(label, pctx, trainer.params_layout, cfg)
    del runs, g_again, state, trainer
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    before = launch_counts()
    (l_plain, _), g_plain = value_and_grad(plain.loss, p_plain, batch)
    if launch_counts() != before:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    # phase 8's limits: the loss 1e-5 relative, each gradient leaf 1e-4 of
    # its largest |value| (attention and the scan differ only in the order
    # of float32 sums; the gathers and reduce-scatters move values
    # unchanged)
    l_err = abs(float(l_kern) - float(l_plain))
    if not (math.isfinite(float(l_kern)) and l_err <= 1e-5 * abs(float(l_plain))):
        raise AssertionError(f"{label}: loss {float(l_kern)} vs plain {float(l_plain)}")
    worst = worst_leaf(torch, g_kern, g_plain, 1e-4)
    log(f"  ok {label}: {cfg.n_layers} layers float32 on the virtual (2, 4) mesh, FSDP "
        f"storage, batch {B} x seq {S}: loss {float(l_kern):.6f} vs plain SP 1 "
        f"{float(l_plain):.6f} (|err| {l_err:.2e}); worst gathered gradient leaf off by "
        f"{worst:.2e} of its max; the second pass bitwise equal; launches {ran}; data-axis "
        f"bytes a rank {data_bytes['fwd']:.0f} a direction = fsdp_comm_bytes (remat "
        f"{cfg.remat}); gathered high-water {high} B = fsdp_gathered_bytes")


def phase_train_dp(torch, dev, cfg=None, B=DP_BATCH, S=4096, steps=DP_STEPS):
    """Phase 22 (b): qwen3-1.7b at full width and depth through the
    ``Trainer`` with FSDP storage on the virtual (2, 4) mesh, each layer
    gathered just in time inside its remat region, one warmup and ``steps``
    timed steps, one more under torch.profiler (the idle share); then the
    same global batch through the (1, 4) mesh, phase 11's path, each step's
    loss bitwise equal to it.

    The (1, 4) run is a gate, not a timing: its steps run after the FSDP
    run's, on a card whose clocks moved between them, so the two step times
    cannot resolve a difference of a few percent.  On the virtual mesh the
    data axis's gather and reduce-scatter hand back their input and charge
    the ledger, so the data-axis bytes reported are the ledger's count: the
    gate against ``fsdp_comm_bytes`` shows that every leaf outside the layer
    stacks was gathered once a step and every layer's leaf twice (the
    forward and the recompute), each reduce-scattered once, not what a link
    would carry.  The gathered high-water (``fsdp_gathered_bytes``) is what
    a rank of a real mesh holds at once beyond its blocks."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.runtime.trainer import n_params
    from repro_torch.sharding import state_bytes, tree_bytes

    cfg = cfg or ARCHS["qwen3-1.7b"]
    trainer = dp_trainer(torch, cfg)
    pctx = trainer.bundle.pctx
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0,
                               layout=cfg.layout, sp_degree=pctx.sp_degree)
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    free_device_memory(torch)
    per_rank = state_bytes(trainer.layout, 0)
    whole = tree_bytes(trainer.layout.meta)
    p_meta = trainer.params_layout.meta
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params(p_meta) / 1e9:.3f}B "
        f"parameters, FSDP storage on {dict(pctx.mesh.shape)}: state {whole / 1e9:.2f} GB, "
        f"{per_rank / 1e9:.3f} GB a rank by the rules; batch {B} x seq {S}; init and shard "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticDataset(data_cfg)
    step_log = lambda m: log("  " + m)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    peak_first = torch.cuda.max_memory_allocated()
    reset_launch_counts()
    pctx.storage.ledger.reset()
    torch.cuda.reset_peak_memory_stats()
    state, timed = trainer.run(state, data, steps=1 + steps, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    want = {k: v * steps for k, v in train_launches_per_step(
        cfg, sp_computes(cfg, "tokenring", pctx.sp_degree)).items()}
    if got != want:
        raise AssertionError(f"training_dp: launches {got} over {steps} steps, expected {want}")
    ledger = pctx.storage.ledger.class_bytes
    data_step, high = dp_gates("training_dp", pctx, trainer.params_layout, cfg, steps)
    params_b = tree_bytes(p_meta)
    losses = hist + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training_dp: losses {losses}")
    step_s = trainer.step_seconds[1:]
    med = statistics.median(step_s)
    t0 = time.perf_counter()
    prof = profile_step(torch, lambda: trainer.run(state, data, steps=2 + steps,
                                                   log=lambda m: None), med, cpu=False)
    prof["seconds"] = time.perf_counter() - t0
    res = {"arch": cfg.name, "mesh": dict(pctx.mesh.shape), "strategy": "tokenring",
           "storage": "fsdp", "batch": B, "seq": S, "steps_timed": steps, "step_s": step_s,
           "median_step_s": med, "tokens_per_s": B * S / med,
           "first_step_s": trainer.step_seconds[0], "losses": losses,
           "peak_bytes_timed_steps": peak, "peak_bytes_first_step": peak_first,
           "launches": got, "launches_per_step": {k: v // steps for k, v in got.items()},
           "data_bytes_per_step_counted": data_step,
           "gathered_bytes_high_water": high, "params_bytes": params_b,
           "ring_bytes_per_step": {w: v / steps for w, v in ledger.get("link", {}).items()},
           "state_bytes_per_rank": per_rank, "state_bytes": whole,
           "idle_share": 1 - prof["device_busy_s"] / med, "profile": prof}
    log(f"  FSDP over (data 2, model 4): timed steps {[round(x, 4) for x in step_s]} s: median "
        f"{med:.4f} s = {B * S / med:.1f} tok/s; losses {[round(x, 4) for x in losses]}; peak "
        f"memory {peak / 2**30:.2f} GiB (first step {peak_first / 2**30:.2f} GiB); data-axis "
        f"bytes a step, rank and direction counted by the ledger {data_step['fwd'] / 1e9:.4f} GB "
        f"= fsdp_comm_bytes; gathered at once {high / 1e9:.3f} GB = fsdp_gathered_bytes (the "
        f"whole tree {params_b / 1e9:.3f} GB); "
        f"state {per_rank / 1e9:.3f} GB a rank of a real 8-rank mesh; launches {got}")
    del state
    trainer = None
    free_device_memory(torch)
    # the same global batch through the (1, 4) mesh: phase 11's path at batch B
    ring = dp_trainer(torch, cfg, sp_degree=pctx.sp_degree)
    state = ring.init_state(0)
    state, ring_hist = ring.run(state, SyntheticDataset(data_cfg), steps=1 + steps,
                                log=lambda m: None)
    del state
    free_device_memory(torch)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ring_hist)]
    bitwise = [a == b for a, b in zip(losses, ring_hist)]
    if not all(r <= SP1_LOSS_LIMIT for r in rel):
        raise AssertionError(f"training_dp: losses {losses} against the (1, 4) mesh's "
                             f"{ring_hist} ({rel} relative, limit {SP1_LOSS_LIMIT})")
    # The fold keeps the summation order: the data ranks' rows sit in the
    # batch of the same ring, the gather moves values unchanged and AdamW is
    # elementwise on the blocks, so the losses are the (1, 4) mesh's bit for
    # bit (the global norm of the blocks sums in another order; it moves no
    # parameter while the clip scale is 1)
    if not all(bitwise):
        raise AssertionError(f"training_dp: losses {losses} not bitwise the (1, 4) mesh's "
                             f"{ring_hist}")
    res["mesh_1x4"] = {"losses": ring_hist, "loss_rel_err": rel, "bitwise": bitwise}
    log(f"  the (1, 4) mesh at batch {B}: losses {[round(x, 4) for x in ring_hist]}, every one "
        f"bitwise equal to the FSDP run's (the fold keeps the summation order); not timed")
    log("RESULT training_dp " + json.dumps(res))
    return got


def phase_train_dp_llama(torch, dev, layers=DP_LLAMA_LAYERS, B=DP_LLAMA_BATCH, S=4096,
                         ring_steps=2):
    """Phase 22 (d): llama2-7b at full width, ``layers`` of its 32, through
    the ``Trainer`` with FSDP storage on the virtual (2, 4) mesh (bf16,
    float32 AdamW, remat "full"), one warmup and one timed step: a model
    whose step the whole-tree gather cannot fit on the card (state plus the
    gathered copy, its gradient and the block gradients, the closed form
    logged, must read above the card's memory) trains with the per-layer
    gather (the measured peak below it).  Then the same global batch for
    ``ring_steps`` steps on the (1, 4) mesh without FSDP, each loss bitwise
    equal to the FSDP run's, as (b) gates."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.runtime.trainer import n_params
    from repro_torch.sharding import fsdp_gathered_bytes, tree_bytes

    cfg = ARCHS["llama2-7b"].with_(n_layers=layers)
    card = torch.cuda.get_device_properties(0).total_memory
    trainer = dp_trainer(torch, cfg)
    pctx = trainer.bundle.pctx
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0,
                               layout=cfg.layout, sp_degree=pctx.sp_degree)
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    p_meta = trainer.params_layout.meta
    params_b, state_b = tree_bytes(p_meta), tree_bytes(trainer.layout.meta)
    # the whole-tree gather's step: the state, the gathered copy, its
    # gradient and the gradient's blocks, before any activation
    whole_tree = state_b + 3 * params_b
    gathered = fsdp_gathered_bytes(trainer.params_layout)
    if not whole_tree > card:
        raise AssertionError(f"training_dp_llama: the whole-tree gather's {whole_tree} B fit "
                             f"the card's {card} B")
    log(f"  {cfg.name}: {cfg.n_layers} of 32 layers, {n_params(p_meta) / 1e9:.3f}B parameters, "
        f"FSDP storage on {dict(pctx.mesh.shape)}: card {card / 1e9:.2f} GB; state "
        f"{state_b / 1e9:.2f} GB; the whole-tree gather's step {whole_tree / 1e9:.2f} GB before "
        f"activations (above the card); gathered at once {gathered / 1e9:.3f} GB of "
        f"{params_b / 1e9:.2f}; batch {B} x seq {S}; init and shard {t_init:.1f} s")
    data = SyntheticDataset(data_cfg)
    step_log = lambda m: log("  " + m)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    reset_launch_counts()
    pctx.storage.ledger.reset()
    state, timed = trainer.run(state, data, steps=2, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    want = train_launches_per_step(cfg, sp_computes(cfg, "tokenring", pctx.sp_degree))
    if got != want:
        raise AssertionError(f"training_dp_llama: launches {got}, expected {want}")
    data_step, high = dp_gates("training_dp_llama", pctx, trainer.params_layout, cfg)
    losses = hist + timed
    if not (all(math.isfinite(x) for x in losses) and peak < card):
        raise AssertionError(f"training_dp_llama: losses {losses}, peak {peak} B of {card}")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": dict(pctx.mesh.shape),
           "strategy": "tokenring", "storage": "fsdp", "batch": B, "seq": S,
           "step_s": trainer.step_seconds, "tokens_per_s": B * S / trainer.step_seconds[1],
           "losses": losses, "card_bytes": card, "state_bytes": state_b,
           "params_bytes": params_b, "whole_tree_gather_bytes": whole_tree,
           "fsdp_gathered_bytes": gathered, "gathered_bytes_high_water": high,
           "peak_bytes": peak, "launches": got, "data_bytes_per_step_counted": data_step}
    log(f"  FSDP over (data 2, model 4), per-layer gather: steps "
        f"{[round(x, 4) for x in trainer.step_seconds]} s ({B * S / trainer.step_seconds[1]:.1f} "
        f"tok/s timed); losses {[round(x, 4) for x in losses]}; peak {peak / 1e9:.2f} GB "
        f"({peak / 2**30:.2f} GiB) of the card's {card / 1e9:.2f} GB; gathered at once "
        f"{high / 1e9:.3f} GB = fsdp_gathered_bytes; data-axis bytes a step, rank and direction "
        f"{data_step['fwd'] / 1e9:.4f} GB = fsdp_comm_bytes; launches {got}")
    del state
    trainer = None
    free_device_memory(torch)
    # the same global batch through the (1, 4) mesh: every parameter and
    # its gradient whole on the card
    ring = dp_trainer(torch, cfg, sp_degree=pctx.sp_degree)
    state = ring.init_state(0)
    torch.cuda.reset_peak_memory_stats()
    state, ring_hist = ring.run(state, SyntheticDataset(data_cfg), steps=ring_steps,
                                log=lambda m: None)
    ring_peak = torch.cuda.max_memory_allocated()
    del state
    free_device_memory(torch)
    if ring_hist != losses[:ring_steps]:
        raise AssertionError(f"training_dp_llama: losses {losses} not bitwise the (1, 4) "
                             f"mesh's {ring_hist}")
    res["mesh_1x4"] = {"losses": ring_hist, "peak_bytes": ring_peak, "bitwise": True}
    log(f"  the (1, 4) mesh without FSDP at batch {B}: losses "
        f"{[round(x, 4) for x in ring_hist]}, bitwise the FSDP run's; peak "
        f"{ring_peak / 1e9:.2f} GB; not timed")
    log("RESULT training_dp_llama " + json.dumps(res))
    return got


def phase_dp_elastic(torch, dev, cfg=None, B=DP_BATCH, S=DP_ELASTIC_SEQ):
    """Phase 22 (c): qwen3-1.7b at full width, 2 layers: the state migrated
    from (2, 4) to ``shrink_mesh(4, model_axis=4)``'s (1, 4) (bitwise),
    one step there; saved on (2, 4) and restored onto (4, 2) (bitwise);
    ``compressed_psum_ef`` over a virtual data axis of 8 ranks on the
    model's gradient tree, at the reference's limits."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.core.collectives import VirtualRing
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.compress import compressed_psum_ef
    from repro_torch.runtime.elastic import ElasticState, shrink_mesh
    from repro_torch.runtime.trainer import batch_to_device
    from repro_torch.sharding import shard_tree, unshard_tree

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2)
    trainer = dp_trainer(torch, cfg)
    state = trainer.init_state(0)
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=2,
                               layout=cfg.layout, sp_degree=4)
    state, _ = trainer.run(state, SyntheticDataset(data_cfg), steps=1, log=lambda m: None)
    full = unshard_tree(state, trainer.layout)

    def same(tree, layout):
        return all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                       tree_leaves(unshard_tree(tree, layout))))

    # elastic: lose half the ranks, keep the model axis
    t0 = time.perf_counter()
    es = ElasticState(trainer.layout)
    moved, mesh = es.migrate(state, 4, model_axis=4)
    torch.cuda.synchronize()
    t_move = time.perf_counter() - t0
    if mesh.shape != {"data": 1, "model": 4} or not same(moved, es.layout):
        raise AssertionError(f"phase 22 (c): migrate to {mesh.shape} not bitwise")
    small = dp_trainer(torch, cfg, mesh=mesh, data_degree=1, sp_degree=4)
    small.layout = es.layout
    data = SyntheticDataset(data_cfg)
    data.load_state_dict({"step": 1})
    moved, hist = small.run(moved, data, steps=2, log=lambda m: None)
    if not (int(moved["step"]) == 2 and math.isfinite(hist[0])):
        raise AssertionError(f"phase 22 (c): the step on {mesh.shape}: {hist}")
    del moved
    # checkpoint: saved on (2, 4), restored onto (4, 2)
    d = tempfile.mkdtemp(prefix="phase22_ckpt_")
    try:
        t0 = time.perf_counter()
        mgr = CheckpointManager(d, keep=1)
        mgr.save(1, state, layout=trainer.layout)
        t_save = time.perf_counter() - t0
        lay_b = trainer.layout.with_mesh(Mesh(("data", "model"), (4, 2)))
        template = shard_tree(full, lay_b)
        for x in tree_leaves(template):
            x.zero_()
        t0 = time.perf_counter()
        restored = mgr.restore(1, template, layout=lay_b)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(Path(d))
        if not same(restored, lay_b):
            raise AssertionError("phase 22 (c): the (4, 2) restore is not bitwise the state")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del restored, template, state
    # compressed psum over 8 virtual data ranks: rank r's gradient is the
    # model's scaled by (4 + r) / 8
    batch = batch_to_device(next(SyntheticDataset(data_cfg)), dev)
    _, grads = value_and_grad(trainer.bundle.loss, full["params"], batch)
    del full
    free_device_memory(torch)
    axis = VirtualRing(8, dev, link_class="data")
    worst1 = worst30 = 0.0
    t0 = time.perf_counter()
    for g in tree_leaves(grads):
        rows = torch.cat([g.float() * ((4 + r) / 8) for r in range(8)])
        exact = sum(part.double() for part in rows.chunk(8)) / 8
        scale = float(rows.abs().max()) / 127.0
        e = torch.zeros_like(rows)
        out, e = (x["w"] for x in compressed_psum_ef({"w": rows}, {"w": e}, axis=axis))
        err1 = float((out[:g.shape[0]].double() - exact).abs().max())
        acc = torch.zeros_like(exact)
        for _ in range(30):
            out, e = (x["w"] for x in compressed_psum_ef({"w": rows}, {"w": e}, axis=axis))
            acc += out[:g.shape[0]].double()
        err30 = float((acc / 30 - exact).abs().max())
        if not (err1 <= scale + 1e-6 and err30 <= scale / 4 + 1e-6):
            raise AssertionError(f"phase 22 (c): compressed psum off by {err1:.3e} after one "
                                 f"step, {err30:.3e} over 30 (step {scale:.3e})")
        worst1, worst30 = max(worst1, err1 / scale), max(worst30, err30 / scale)
        del rows, exact, e, out, acc
    t_comp = time.perf_counter() - t0
    log(f"  ok phase 22 (c): migrate (2, 4) -> {dict(mesh.shape)} bitwise in {t_move:.2f} s, "
        f"one step there (loss {hist[0]:.4f}); saved on (2, 4) ({ckpt_bytes / 1e9:.2f} GB of "
        f"full arrays, {t_save:.1f} s), restored onto (4, 2) bitwise ({t_restore:.1f} s); "
        f"compressed psum over 8 virtual data ranks on {len(tree_leaves(grads))} gradient "
        f"leaves: worst error {worst1:.3f} of a step after one step (limit 1), {worst30:.3f} "
        f"after 30 (limit 0.25), {t_comp:.1f} s")


# ---------------------------------------------------------------------------
# phase 23: the decode step under serve-mode (Megatron) storage
# ---------------------------------------------------------------------------

SERVE_CHECK_ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b")
SERVE_CHECK_MESHES = ((1, 4), (2, 4))  # virtual (data, model) meshes
SERVE_CHECK_LAYERS = 2
SERVE_CHECK_BATCH, SERVE_CHECK_PROMPT, SERVE_CHECK_STEPS = 4, 256, 8
# (a)'s logit limit, phase 8's: attention and the row projections' sums
# differ only in the order of float32 sums
SERVE_LOGIT_LIMIT = 1e-4
SERVE_TP_ARCH = "qwen2-72b"
SERVE_TP_LAYERS = 8  # of 80: 9.5 B parameters, 19.0 GB in bf16
SERVE_TP_BATCH, SERVE_TP_PROMPT, SERVE_TP_STEPS = 8, 2048, 32
# (b)'s qkv biases, drawn at random so that their split is exercised (the
# seeded init makes them zero), and its limit on each logit's distance from
# the replicated decode, a share of the reference row's spread.  At std 2
# the blocks read 0.0104 of it and the blocks with those biases zeroed
# 0.1042 (std 1: 0.0111 and 0.0544; H100, phase 23 (b)): the limit sits
# ~5x above the first and ~2x below the second.
SERVE_TP_BIAS_STD = 2.0
SERVE_TP_LOGIT_GAP = 0.05


def serve_prompts(torch, dev, cfg, B, S, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    return tokens, torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()


def serve_mesh(shape):
    """The virtual mesh of ``shape``: ``(data, model)``, or ``(pod, data,
    model)``."""
    from repro_torch.launch.mesh import data_mesh

    *pods, D, G = shape
    return data_mesh(D, G, *pods)


def sp_size(mesh) -> int:
    """The SP degree of a mesh: its sequence axes, ``pod`` and ``model``."""
    return mesh.shape["model"] * mesh.shape.get("pod", 1)


def serve_decode(torch, bundle, params, state, tok, steps, feed=None, timed=False, final=None):
    """``steps`` decode steps of ``bundle`` on a copy of ``state`` from the
    tokens ``tok (B,)``: greedy, or fed ``feed (B, steps)``.  Returns the
    tokens fed ``(B, steps)``, the logits ``(B, steps, V)`` in float32,
    each step's CUDA-event milliseconds (``timed``), A's launches counted
    from zero and the mesh ledger's bytes by class (``{}`` without a
    mesh); ``final`` (a dict) receives the state after the last step."""
    state = {k: v.clone() for k, v in state.items()}
    storage = bundle.pctx.storage
    if storage is not None:
        storage.ledger.reset()
    reset_launch_counts()
    chain, rows, times = [], [], []
    for i in range(steps):
        if feed is not None:
            tok = feed[:, i]
        chain.append(tok)
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        logits, state = bundle.decode_step(params, tok, state)
        if timed:
            end.record()
            times.append((start, end))
        rows.append(logits.float())
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    if final is not None:
        final.update(state)
    ledger = ({c: dict(v) for c, v in storage.ledger.class_bytes.items()}
              if storage is not None else {})
    return (torch.stack(chain, 1), torch.stack(rows, 1), [a.elapsed_time(b) for a, b in times],
            launch_counts()["flash_attention_fwd"], ledger)


def draw_qkv_biases(torch, dev, params, std, seed):
    """Each layer's q, k and v biases drawn from N(0, std^2), in place."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for layer in params["layers"]:
        for k in ("wq", "wk", "wv"):
            b = layer["attn"][k]["b"]
            b.copy_(torch.randn(b.shape, generator=gen, device=dev) * std)


@contextlib.contextmanager
def recorded_a_calls(into):
    """Kernel A's wrapper as the dispatcher (``kernels.ops``) calls it, the
    first call of each signature (shapes, dtype, mask) kept in ``into``
    with copies of its inputs; the launch and its count as before."""
    from repro_torch.kernels import ops

    launch = ops.flash_attention_fwd_cuda

    def record(q, k, v, q_pos, k_pos, **kw):
        key = (tuple(q.shape), tuple(k.shape), q.dtype, kw["causal"], kw["window"])
        if key not in into:
            into[key] = ([t.clone() for t in (q, k, v, q_pos, k_pos)], kw)
        return launch(q, k, v, q_pos, k_pos, **kw)

    ops.flash_attention_fwd_cuda = record
    try:
        yield into
    finally:
        ops.flash_attention_fwd_cuda = launch


def replay_a_calls(torch, calls, label):
    """Each recorded call of kernel A through its wrapper twice (bitwise
    equal) and through its plain version at phase 3's limits.  Returns the
    largest |out err|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    worst = 0.0
    for (qs, ks, dtype, causal, window), (args, kw) in calls.items():
        inst = fa.flash_fwd_instance(dtype, qs[1], qs[-1])
        name = f"A {label} call q{qs} k{ks} causal={causal} window={window} [{inst}]"
        got, again = (fa.flash_attention_fwd_cuda(*args, **kw) for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
        want = fa.flash_attention_fwd_torch(*args, **kw, block_k=pick_block(ks[1], 512))
        worst = max(worst, compare(name + " bitwise repeatable", got, want,
                                   **tolerances(dtype)))
        del got, again, want
    return worst


def closed_form(cfg):
    """The closed form of ``cfg``'s decode step's bytes on serve storage."""
    from repro_torch.models.encdec import encdec_serve_comm_bytes
    from repro_torch.models.mamba import mamba_serve_comm_bytes
    from repro_torch.models.rglru import rg_serve_comm_bytes
    from repro_torch.models.transformer import serve_comm_bytes

    return {"encdec": encdec_serve_comm_bytes, "ssm": mamba_serve_comm_bytes,
            "hybrid": rg_serve_comm_bytes}.get(cfg.family, serve_comm_bytes)


def serve_bytes_gate(label, ledger, layout, cfg, rows, steps):
    """The ledger's bytes over ``steps`` decode steps against the family's
    closed form a step (:func:`closed_form`), every class (relative
    1e-9)."""
    closed = closed_form(cfg)(layout, cfg, rows)
    for cls in set(closed) | set(ledger):
        want = closed.get(cls, {"fwd": 0.0, "bwd": 0.0})
        got = ledger.get(cls, {"fwd": 0.0, "bwd": 0.0})
        if any(abs(got[w] - steps * want[w]) > 1e-9 * steps * want[w] for w in ("fwd", "bwd")):
            raise AssertionError(f"{label}: {cls} bytes over {steps} steps {got}, closed form "
                                 f"{want} a step")
    return closed


def serve_blocks_gate(label, params, blocks, layout):
    """Each split leaf's blocks are ``cut_blocks`` of the full leaf by
    ``param_pspec(mode="serve")`` of its path (every rank's: the virtual
    mesh), every other leaf the full one.  Returns the split leaves'
    count."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import ServeBlocks, cut_blocks, param_pspec
    from repro_torch.sharding.rules import map_with_path

    paths, split = [], 0
    map_with_path(lambda path, x: paths.append(path), params)
    for path, full, leaf in zip(paths, tree_leaves(params), tree_leaves(blocks)):
        if isinstance(leaf, ServeBlocks):
            spec = param_pspec(path, tuple(full.shape), layout.mesh, "serve")
            if leaf.spec != spec or not bool((leaf.blocks == cut_blocks(full, spec,
                                                                        layout.mesh)).all()):
                raise AssertionError(f"{label}: the blocks of {path} are not the rule's {spec}")
            split += 1
        elif not bool((leaf == full).all()):
            raise AssertionError(f"{label}: the whole leaf {path} differs from the tree's")
    return split


def class_line(closed) -> str:
    """A closed form's bytes a step and direction, by class."""
    return ", ".join(f"{cls} {closed[cls]['fwd']:.0f}" for cls in closed)


def swapped_ep_slices(blocks, pods):
    """``blocks`` with the first layer's expert stacks' EP slices of pods 0
    and 1 swapped inside every model block (the fault phase 25 (c)
    plants)."""
    order = [1, 0, *range(2, pods)]

    def swap(b):
        return dataclasses.replace(b, blocks=b.blocks.unflatten(1, (pods, -1))[:, order]
                                   .flatten(1, 2))

    first = blocks["layers"][0]
    moe = {**first["moe"], **{k: swap(first["moe"][k]) for k in ("wg", "wu", "wd")}}
    return {**blocks, "layers": [{**first, "moe": moe}, *blocks["layers"][1:]]}


def phase_serve_checked(torch, dev, name, mesh_shape, layers=SERVE_CHECK_LAYERS,
                        B=SERVE_CHECK_BATCH, S=SERVE_CHECK_PROMPT, steps=SERVE_CHECK_STEPS,
                        phase=23):
    """Phase 23 (a), and 25 (a) on a pod mesh: ``name`` at full width,
    ``layers`` layers, float32 (an MoE at capacity factor E / K), prefilled
    once on the plain path at SP 4; the replicated SP-4 decode on the plain
    path (greedy) against the decode step on serve blocks over the virtual
    ``mesh_shape`` on the kernels, fed the same tokens, twice.  An MoE on a
    pod mesh then takes phase 25 (c): the chain fed once more with the EP
    slices of pods 0 and 1 swapped in its first layer's expert stacks, which
    must fail the logit limit."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.mesh import make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import layout_for, shard_tree

    cfg = ARCHS[name].with_(n_layers=layers, dtype="float32")
    cfg = no_drop(cfg) if cfg.n_experts else cfg
    mesh = serve_mesh(mesh_shape)
    label = f"phase {phase} (a) {name} {mesh_shape}"
    P = sp_size(mesh)
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda", sp_degree=P))
    params = plain.init(0)
    tokens, positions = serve_prompts(torch, dev, cfg, B, S, seed=31)
    state = plain.init_serve_state(B, S + steps, dev)
    logits, state = plain.prefill(params, tokens, positions, state)
    tok = logits.argmax(-1).to(torch.int32)
    chain, ref, _, ran, _ = serve_decode(torch, plain, params, state, tok, steps)
    if ran:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    pctx = make_pctx(mesh, device="cuda", global_batch=B)
    bundle = build_model(cfg, pctx)
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)
    split = serve_blocks_gate(label, params, blocks, layout)
    del params
    free_device_memory(torch)
    runs = [serve_decode(torch, bundle, blocks, state, tok, steps, feed=chain) for _ in range(2)]
    (_, got, _, ran, ledger), (_, again, _, _, _) = runs
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: the second run is not bitwise the first")
    if ran != cfg.n_layers * steps:
        raise AssertionError(f"{label}: A launches {ran}, expected {cfg.n_layers * steps}")
    err = float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
    gap, _ = forced_gaps(torch, ref, got.argmax(-1))
    if not (bool(torch.isfinite(got).all()) and err <= SERVE_LOGIT_LIMIT
            and float(gap.max()) <= 1e-3):
        raise AssertionError(f"{label}: logits off by {err:.2e} of the row's max, a token "
                             f"{float(gap.max()):.2e} below the plain path's max logit")
    closed = serve_bytes_gate(label, ledger, layout, cfg, B // pctx.data_degree, steps)
    fault = ""
    pods = mesh.shape.get("pod", 1)
    if cfg.n_experts and pods > 1:
        _, wrong, _, _, _ = serve_decode(torch, bundle, swapped_ep_slices(blocks, pods), state,
                                         tok, steps, feed=chain)
        bad = float(((wrong - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
        if not bad > SERVE_LOGIT_LIMIT:
            raise AssertionError(f"{label}: with the EP slices of pods 0 and 1 swapped the "
                                 f"logits stay within {bad:.2e} of the row's max: the limit "
                                 f"{SERVE_LOGIT_LIMIT} would not see them")
        fault = (f"; (c) the EP slices of pods 0 and 1 swapped in layer 0: logits {bad:.2e} of "
                 f"the row's max (fails the limit, as it must)")
        del wrong
    log(f"  ok {label}: float32, batch {B}, prompt {S}, {steps} steps on serve blocks ("
        f"{split} leaves split over model, each the rule's) against the replicated SP-{P} "
        f"decode on the plain path: logits within {err:.2e} of the row's max (limit "
        f"{SERVE_LOGIT_LIMIT}), tokens within {float(gap.max()):.2e} of its max logit; the second "
        f"run bitwise equal; A launches {ran} = {cfg.n_layers} x {steps}; bytes a step and "
        f"direction = serve_comm_bytes: {class_line(closed)}{fault}")
    del runs, blocks, state
    free_device_memory(torch)
    return ran


def phase_serve_tp(torch, dev, with_profile=False, layers=SERVE_TP_LAYERS, B=SERVE_TP_BATCH,
                   S=SERVE_TP_PROMPT, steps=SERVE_TP_STEPS):
    """Phase 23 (b): qwen2-72b at full width, ``layers`` of its 80, bf16,
    on the virtual (1, 4) mesh: ``B`` prompts of ``S`` prefilled through
    the replicated ``lm_prefill`` at SP 4 (TokenRing), ``steps`` greedy
    steps on the replicated tree (the reference), the tree cut to serve
    blocks and freed (the weights held at most twice), the reference's
    tokens fed through the blocks (each token within ``WITNESS_GAP`` and
    each logit within ``SERVE_TP_LOGIT_GAP`` of the reference row's
    spread), then ``steps`` greedy
    steps timed; the ledger's bytes = ``serve_comm_bytes``; ``state_bytes``
    of the whole model for a model axis of 4 and 8.  The qkv biases are
    drawn at random first; the chain fed with them zeroed on the blocks
    must fail the logit limit.  Kernel A's calls of the prefill
    and of the blocks' decode, the first of each shape, are replayed
    against its plain version.  ``with_profile``: 4 steps on the blocks
    once more under torch.profiler (the idle share)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import data_mesh, make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import init_lm, serve_comm_bytes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import ServeBlocks, layout_for, shard_tree, state_bytes

    full_cfg = ARCHS[SERVE_TP_ARCH]
    cfg = full_cfg.with_(n_layers=layers)
    mesh = data_mesh(1, 4)
    pctx = make_pctx(mesh, device="cuda", global_batch=B)
    bundle = build_model(cfg, pctx)
    label = "serving_tp"
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(0)
    draw_qkv_biases(torch, dev, params, SERVE_TP_BIAS_STD, seed=41)
    weight_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    tokens, positions = serve_prompts(torch, dev, cfg, B, S, seed=37)
    state = bundle.init_serve_state(B, S + steps, dev)
    calls = {}
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_a_calls(calls):
        logits, state = bundle.prefill(params, tokens, positions, state)
    torch.cuda.synchronize()
    t_prefill, prefill_a = time.perf_counter() - t0, launch_counts()["flash_attention_fwd"]
    replay_err, replayed = replay_a_calls(torch, calls, label), list(calls)
    calls.clear()
    tok = logits.argmax(-1).to(torch.int32)
    chain, ref, ref_ms, ref_a, _ = serve_decode(torch, bundle, params, state, tok, steps,
                                                timed=True)
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)
    del params
    free_device_memory(torch)
    cut_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with recorded_a_calls(calls):
        _, forced, _, _, _ = serve_decode(torch, bundle, blocks, state, tok, steps, feed=chain)
    own, got, ms, ran, ledger = serve_decode(torch, bundle, blocks, state, tok, steps,
                                             timed=True)
    serve_peak = torch.cuda.max_memory_allocated()
    if ran != cfg.n_layers * steps:
        raise AssertionError(f"{label}: A launches {ran}, expected {cfg.n_layers * steps}")
    closed = serve_bytes_gate(label, ledger, layout, cfg, B, steps)
    top = ref.amax(-1)
    spread = top - ref.mean(-1)
    gap = top - ref.gather(-1, forced.argmax(-1, keepdim=True))[..., 0]
    tok_ratio = float((gap / spread).max())
    logit_diff = (forced - ref).abs().amax(-1)
    logit_ratio = float((logit_diff / spread).max())

    def zeroed(b):
        return (dataclasses.replace(b, blocks=torch.zeros_like(b.blocks))
                if isinstance(b, ServeBlocks) else torch.zeros_like(b))

    faulty = {**blocks, "layers": [
        {**layer, "attn": {**layer["attn"], **{k: {**layer["attn"][k],
                                                    "b": zeroed(layer["attn"][k]["b"])}
                                               for k in ("wq", "wk", "wv")}}}
        for layer in blocks["layers"]]}
    _, wrong, _, _, _ = serve_decode(torch, bundle, faulty, state, tok, steps, feed=chain)
    del faulty
    fault_ratio = float(((wrong - ref).abs().amax(-1) / spread).max())
    log(f"  {label} gates: forced tokens {tok_ratio:.4f} of the row spread below the replicated "
        f"max (limit {WITNESS_GAP}), logits {logit_ratio:.4f} of it (max |diff| "
        f"{float(logit_diff.max()):.4f}; limit {SERVE_TP_LOGIT_GAP}); the qkv biases (std "
        f"{SERVE_TP_BIAS_STD}) zeroed on the blocks: logits {fault_ratio:.4f} of the row spread "
        f"(must fail the limit)")
    if not (bool(torch.isfinite(got).all()) and tok_ratio <= WITNESS_GAP
            and logit_ratio <= SERVE_TP_LOGIT_GAP):
        raise AssertionError(f"{label}: a token {tok_ratio:.4f} and a logit {logit_ratio:.4f} "
                             f"of the row spread from the replicated decode (limits "
                             f"{WITNESS_GAP}, {SERVE_TP_LOGIT_GAP})")
    if not fault_ratio > SERVE_TP_LOGIT_GAP:
        raise AssertionError(f"{label}: the chain fed with the qkv biases zeroed stays within "
                             f"{fault_ratio:.4f} of the row spread: the limit "
                             f"{SERVE_TP_LOGIT_GAP} would not see a dropped bias")
    replay_err = max(replay_err, replay_a_calls(torch, calls, label))
    replayed += list(calls)
    del calls
    blocks_bytes = sum(x.blocks.numel() * x.blocks.element_size() if isinstance(x, ServeBlocks)
                       else x.numel() * x.element_size() for x in tree_leaves(blocks))
    cache_bytes = sum(state[k].numel() * state[k].element_size() for k in ("k", "v"))
    med, ref_med = statistics.median(ms), statistics.median(ref_ms)
    full_meta = init_lm(full_cfg, None, device="meta")
    full_state = {m: state_bytes(layout_for(full_meta, data_mesh(1, m), mode="serve"))
                  for m in (4, 8)}
    full_tp = serve_comm_bytes(layout_for(full_meta, mesh, mode="serve"), full_cfg, B)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": dict(mesh.shape),
           "storage": "serve", "batch": B, "prompt": S, "steps": steps,
           "prefill_s": t_prefill, "prefill_launches": prefill_a,
           "median_step_ms": med, "step_ms": ms, "replicated_median_step_ms": ref_med,
           "weight_bytes": weight_bytes, "blocks_bytes": blocks_bytes,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "cache_bytes": cache_bytes,
           "read_bound_ms": (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
           "tp_bytes_per_step": closed["tp"]["fwd"], "link_bytes_per_step":
           closed["link"]["fwd"], "peak_bytes_cut": cut_peak, "peak_bytes_serve": serve_peak,
           "state_bytes_80_layers": full_state, "tp_bytes_per_step_80_layers":
           full_tp["tp"]["fwd"], "launches": ran, "replicated_launches": ref_a,
           "max_token_gap_over_spread": tok_ratio, "max_logit_diff_over_spread": logit_ratio,
           "max_logit_abs_diff": float(logit_diff.max()), "logit_limit": SERVE_TP_LOGIT_GAP,
           "qkv_bias_std": SERVE_TP_BIAS_STD, "fault_logit_diff_over_spread": fault_ratio,
           "a_calls_replayed": len(replayed),
           "a_calls_max_abs_err": replay_err,
           "median_spread": float(spread.median()),
           "greedy_equal_to_replicated": int((own == chain).sum()), "tokens": chain.numel()}
    log(f"  {cfg.name}: {layers} of {full_cfg.n_layers} layers, {weight_bytes / 1e9:.2f} GB in "
        f"bf16, serve blocks over {dict(mesh.shape)}; batch {B} x prompt {S} prefilled at SP 4 in "
        f"{t_prefill:.2f} s; decode step median {med:.3f} ms (replicated {ref_med:.3f} ms), "
        f"weight-read bound {res['weight_read_bound_ms']:.3f} ms ({res['read_bound_ms']:.3f} "
        f"with the cache); TP bytes a step, rank and direction {closed['tp']['fwd']:.0f} = "
        f"serve_comm_bytes (link {closed['link']['fwd']:.0f}); peak {cut_peak / 1e9:.2f} GB at "
        f"the cut, {serve_peak / 1e9:.2f} GB serving; A launches {ran}; forced tokens within "
        f"{tok_ratio:.4f} and logits within {logit_ratio:.4f} of the row spread (limits "
        f"{WITNESS_GAP} and {SERVE_TP_LOGIT_GAP}, median spread {res['median_spread']:.3f}); "
        f"greedy tokens equal to the "
        f"replicated decode's {res['greedy_equal_to_replicated']} of {chain.numel()}; "
        f"qkv biases zeroed on the blocks: logits {fault_ratio:.4f} of the row spread (fails "
        f"the limit, as it must); A's {len(replayed)} call shapes replayed "
        f"against the plain version, max |out err| {replay_err:.3e}; "
        f"state_bytes at 80 layers {full_state[4] / 1e9:.2f} GB (model 4), "
        f"{full_state[8] / 1e9:.2f} GB (model 8)")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: serve_decode(torch, bundle, blocks, state,
                                                                  tok, 4), 4 * med / 1e3)
    log("RESULT serving_tp " + json.dumps(res))
    del blocks, state
    free_device_memory(torch)
    return ran


# ---------------------------------------------------------------------------
# phase 24: the encoder-decoder, SSM and hybrid decode steps under serve-mode
# (Megatron) storage
# ---------------------------------------------------------------------------

FAMILY_CHECKS = (("whisper-base", dict(n_layers=WHISPER_CHECK_LAYERS,
                                       n_enc_layers=WHISPER_CHECK_LAYERS)),
                 (MAMBA, dict(n_layers=MAMBA_CHECK_LAYERS)),
                 (RG, dict(n_layers=RG_CHECK_LAYERS)))
FAMILY_CHECK_BATCH, FAMILY_CHECK_STEPS = 4, 16
# the synthetic start's length: the ring buffer's 2048 slots hold positions
# 0..2039, so (a)'s 16 steps wrap slot 2047 (rank 3 at SP 4) to slot 0
RG_SYNTH_LEN = 2040
# the dense slab of a synthetic start at RG_SYNTH_LEN (phase 25 (b)): room
# for 32 steps, a multiple of every SP degree up to 16
SYNTH_MAX_LEN = 2080
FAMILY_TP_BATCH, FAMILY_TP_STEPS = 8, 32
FAMILY_TP_ARCHS = (RG, MAMBA, "whisper-base")
MAMBA_SERVE_LAYERS = 64  # falcon-mamba-7b's layers in (b): all of them
# (b)'s float32 gate at 32 of falcon-mamba's 64 layers: the whole float32
# tree and its blocks at 64 (59.4 GB) would pass the phase's ~35 GB peak
FAMILY_F32_LAYERS = {MAMBA: 32}
FAMILY_GATE_STEPS = 16  # the float32 gate's steps (the timed bf16 runs take 32)
FAULT_STEPS = 4
# (batch dim, split dim) of each state leaf that serve_state_shardings
# splits: the caches by sequence, the recurrent state by its width
STATE_DIMS = {"k": (1, 2), "v": (1, 2), "pos": (0, 1), "xk": (1, 2), "xv": (1, 2),
              "enc_pos": (0, 1), "ssm": (1, 2), "conv": (1, 3), "rec_h": (2, 3),
              "rec_conv": (2, 4), "tail_h": (1, 2), "tail_conv": (1, 3)}
RECURRENT = ("ssm", "conv", "rec_h", "rec_conv", "tail_h", "tail_conv")


def decode_a_calls(cfg) -> int:
    """Kernel A's launches of one decode step: a whisper decoder layer's
    self and cross reads, a recurrentgemma superblock's local attention,
    a transformer layer's read, none for falcon-mamba (every rank's rows
    in one launch)."""
    return 2 * cfg.n_layers if cfg.family == "encdec" else attention_calls(cfg)


def synthetic_state(torch, dev, cfg, B, seed):
    """A seeded global decode state of ``B`` rows: falcon-mamba's ``ssm``
    and ``conv``; recurrentgemma's recurrent state and a ring buffer at
    length ``RG_SYNTH_LEN``, its positions in ring order (``PAD_POS`` in
    the slots not yet written); a transformer's dense slab of
    ``SYNTH_MAX_LEN`` slots at length ``RG_SYNTH_LEN``."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.rglru import rg_layout

    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)

    def rnd(*shape, dtype=dt, std=0.5):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    K = cfg.ssm_conv
    if cfg.family in ("dense", "moe"):
        slots = torch.arange(SYNTH_MAX_LEN, device=dev, dtype=torch.int32)
        kv = (cfg.n_layers, B, SYNTH_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
        return {"k": rnd(*kv, std=1.0), "v": rnd(*kv, std=1.0),
                "pos": torch.where(slots < RG_SYNTH_LEN, slots, PAD_POS).expand(
                    B, SYNTH_MAX_LEN).contiguous(),
                "len": torch.full((B,), RG_SYNTH_LEN, dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        di, L = cfg.d_inner, cfg.n_layers
        return {"ssm": rnd(L, B, di, cfg.ssm_state, dtype=torch.float32),
                "conv": rnd(L, B, K - 1, di)}
    n_super, n_tail = rg_layout(cfg)
    lru, W = cfg.lru_width or cfg.d_model, cfg.window
    slots = torch.arange(W, device=dev, dtype=torch.int32)
    glob = {"rec_h": rnd(n_super, 2, B, lru, dtype=torch.float32),
            "rec_conv": rnd(n_super, 2, B, K - 1, lru),
            "k": rnd(n_super, B, W, cfg.n_kv_heads, cfg.head_dim, std=1.0),
            "v": rnd(n_super, B, W, cfg.n_kv_heads, cfg.head_dim, std=1.0),
            "pos": torch.where(slots < RG_SYNTH_LEN, slots, PAD_POS).expand(B, W).contiguous(),
            "len": torch.full((B,), RG_SYNTH_LEN, dtype=torch.int32, device=dev)}
    if n_tail:
        glob["tail_h"] = rnd(n_tail, B, lru, dtype=torch.float32)
        glob["tail_conv"] = rnd(n_tail, B, K - 1, lru)
    return glob


def placed_state(bundle, glob, B, dev):
    """``bundle``'s serve state of ``B`` rows holding the global state
    ``glob`` in its layout: each leaf's ranks rank-major in its batch dim,
    each with its slice of the split dim (as many ranks as the layout has
    row blocks: 1 where the leaf is whole)."""
    state = bundle.init_serve_state(B, glob["pos"].shape[1] if "pos" in glob else 0, dev)
    for key, x in glob.items():
        if key == "len":
            state[key].copy_(x)
            continue
        b, d = STATE_DIMS[key]
        P = state[key].shape[b] // B
        state[key].copy_(x.unflatten(d, (P, -1)).movedim(d, b).flatten(b, b + 1))
    return state


def family_start(torch, dev, bundle, params, B, seed):
    """A decode start of ``B`` rows for ``bundle``: whisper's encode of
    seeded frames into a dense slab of ``WHISPER_MAX_LEN`` slots and its
    start token, or the synthetic state and seeded tokens."""
    cfg = bundle.cfg
    if cfg.family == "encdec":
        state = bundle.init_serve_state(B, WHISPER_MAX_LEN, dev)
        bundle.encode(params, whisper_frames(torch, dev, cfg, B, seed), state)
        return state, torch.full((B,), WHISPER_SOT, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev, dtype=torch.int32)
    return placed_state(bundle, synthetic_state(torch, dev, cfg, B, seed), B, dev), tok


def state_slices_gate(label, mine, final, mesh, D):
    """Each rank's slice of each recurrent leaf of the blocks' state
    ``mine`` against the documented slice of the plain path's whole state
    ``final``: rank ``(p, d, m)`` holds width slice ``m * pods + p``
    (model-major, ``models.layers.state_tp``) of data rank ``d``'s rows
    (``D`` data ranks), within ``SERVE_LOGIT_LIMIT`` of the leaf's largest
    |value|.  Returns the worst such error (0.0 without a recurrent
    leaf)."""
    pods = mesh.shape.get("pod", 1)
    K = pods * mesh.shape["model"]
    worst = 0.0
    for key in (k for k in RECURRENT if k in mine):
        b, s = STATE_DIMS[key]
        ref, held = final[key].float(), mine[key].float().unflatten(b, (K, -1))
        w, n = ref.shape[s] // K, ref.shape[b] // D
        for r in range(mesh.size):
            c = mesh.coords(r)
            j = c["model"] * pods + c.get("pod", 0)
            d = c["data"] if D > 1 else 0
            want = ref.narrow(s, j * w, w).narrow(b, d * n, n)
            got = held.select(b, j).narrow(b, d * n, n)
            worst = max(worst, float((got - want).abs().max() / ref.abs().max()))
    if worst > SERVE_LOGIT_LIMIT:
        raise AssertionError(f"{label}: a rank's slice of the recurrent state is {worst:.2e} of "
                             f"the leaf's max from its model-major slice of the plain path's")
    return worst


def phase_family_checked(torch, dev, name, over, mesh_shape, B=FAMILY_CHECK_BATCH,
                         steps=FAMILY_CHECK_STEPS, phase=24):
    """Phase 24 (a), and 25 (a) on a pod mesh: ``name`` at full width,
    float32, ``over``'s depth: the replicated SP-4 decode on the plain path
    (greedy) against the decode step on serve blocks over the virtual
    ``mesh_shape`` on the kernels, fed the same tokens from the same start,
    twice; each rank's slice of the recurrent state against the plain
    path's (:func:`state_slices_gate`).  Returns A's launches on the
    blocks."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.mesh import make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import layout_for, shard_tree

    cfg = ARCHS[name].with_(dtype="float32", **over)
    mesh = serve_mesh(mesh_shape)
    label = f"phase {phase} (a) {name} {mesh_shape}"
    P = sp_size(mesh)
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda", sp_degree=P,
                                             layout=cfg.layout))
    pctx = make_pctx(mesh, device="cuda", global_batch=B, layout=cfg.layout)
    bundle = build_model(cfg, pctx)
    params = plain.init(0)
    ref_state, tok = family_start(torch, dev, plain, params, B, 43)
    final = {}
    chain, ref, _, ran, _ = serve_decode(torch, plain, params, ref_state, tok, steps,
                                         final=final)
    if ran:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    if cfg.family == "encdec":  # the caches' layout is the plain SP-4 path's
        state = ref_state
    else:
        state, _ = family_start(torch, dev, bundle, params, B, 43)
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)
    split = serve_blocks_gate(label, params, blocks, layout)
    del params
    free_device_memory(torch)
    mine = {}
    runs = [serve_decode(torch, bundle, blocks, state, tok, steps, feed=chain, final=mine)
            for _ in range(2)]
    (_, got, _, ran, ledger), (_, again, _, _, _) = runs
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: the second run is not bitwise the first")
    want_a = decode_a_calls(cfg) * steps
    if ran != want_a:
        raise AssertionError(f"{label}: A launches {ran}, expected {want_a}")
    err = float(((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
    gap, _ = forced_gaps(torch, ref, got.argmax(-1))
    if not (bool(torch.isfinite(got).all()) and err <= SERVE_LOGIT_LIMIT
            and float(gap.max()) <= 1e-3):
        raise AssertionError(f"{label}: logits off by {err:.2e} of the row's max, a token "
                             f"{float(gap.max()):.2e} below the plain path's max logit")
    closed = serve_bytes_gate(label, ledger, layout, cfg, B // pctx.data_degree, steps)
    slices = state_slices_gate(label, mine, final, mesh, pctx.data_degree)
    wrap = (f"; each rank's slice of the recurrent state within {slices:.2e} of the leaf's max "
            f"from its model-major slice of the plain path's" if cfg.family != "encdec" else "")
    if cfg.family == "hybrid":
        # the ring buffer read back globally: the 16 steps wrote 2040..2047
        # on the last rank, then wrapped to slots 0..7 on rank 0
        n = RG_SYNTH_LEN + steps - cfg.window
        pos = mine["pos"].unflatten(0, (P, B)).movedim(0, 1).flatten(1, 2)
        want_pos = torch.arange(cfg.window, device=dev, dtype=torch.int32)
        want_pos = torch.where(want_pos < n, want_pos + cfg.window, want_pos)
        if not (n > 0 and bool((pos == want_pos).all())
                and torch.equal(mine["pos"], final["pos"])):
            raise AssertionError(f"{label}: the ring buffer did not wrap to rank 0's slot 0")
        wrap += (f"; the ring buffer wrapped from slot {cfg.window - 1} (rank {P - 1}) to slots "
                 f"0..{n - 1} (rank 0), positions equal to the plain path's")
    log(f"  ok {label}: float32, batch {B}, {steps} steps on serve blocks ({split} leaves split "
        f"over model, each the rule's) against the replicated SP-{P} decode on the plain path: "
        f"logits within {err:.2e} of the row's max (limit {SERVE_LOGIT_LIMIT}), tokens within "
        f"{float(gap.max()):.2e} of its max logit; the second run bitwise equal; A launches "
        f"{ran} = {decode_a_calls(cfg)} x {steps}; bytes a step and direction = the closed "
        f"form: {class_line(closed)}{wrap}")
    del runs, blocks, state, ref_state, mine, final
    free_device_memory(torch)
    return ran


def meta_params(cfg):
    """``cfg``'s full parameter tree as meta tensors."""
    from repro_torch.models import encdec, mamba, rglru, transformer

    init = {"encdec": encdec.init_encdec, "ssm": mamba.init_mamba_lm, "hybrid": rglru.init_rg}
    return init.get(cfg.family, transformer.init_lm)(cfg, None, device="meta")


def swapped_in_proj(blocks):
    """``blocks`` with every layer's ``in_proj`` blocks of ranks 1 and 2
    swapped (the fault (c) plants)."""
    def swap(b):
        return dataclasses.replace(b, blocks=b.blocks[[0, 2, 1, 3]])

    return {**blocks, "layers": [{**layer, "in_proj": {**layer["in_proj"],
                                                       "w": swap(layer["in_proj"]["w"])}}
                                 for layer in blocks["layers"]]}


def spread_gaps(torch, got, ref):
    """``got``'s logits against the reference's ``ref`` (each ``(B, steps,
    V)``), as shares of each reference row's spread (max minus mean):
    ``(token, logit, max |diff|, median spread)``, the token gap of
    ``got``'s argmax below the reference's max."""
    top = ref.amax(-1)
    spread = top - ref.mean(-1)
    gap = top - ref.gather(-1, got.argmax(-1, keepdim=True))[..., 0]
    diff = (got - ref).abs().amax(-1)
    return (float((gap / spread).max()), float((diff / spread).max()), float(diff.max()),
            float(spread.median()))


def as_layout_of(tree, meta):
    """``tree``'s leaves cast to the dtypes of ``meta`` (another storage
    layout of the same tree)."""
    from repro_torch.optim.adamw import tree_leaves, tree_map

    it = iter([x.to(m.dtype) for x, m in zip(tree_leaves(tree), tree_leaves(meta))])
    return tree_map(lambda _: next(it), tree)


def phase_family_gate(torch, dev, cfg, B=FAMILY_TP_BATCH, steps=FAMILY_GATE_STEPS,
                      mesh_shape=(1, 4), phase=24):
    """Phase 24 (b)'s gate (and 25 (b)'s), in float32 at ``cfg``'s full
    width and depth (falcon-mamba at ``FAMILY_F32_LAYERS``): ``steps``
    greedy steps of the replicated SP-1 decode (the reference), its chain
    fed through the serve blocks over the virtual ``mesh_shape`` (each
    token within ``WITNESS_GAP``
    and each logit within ``SERVE_TP_LOGIT_GAP`` of the reference row's
    spread; the ledger = the closed form) and through the replicated bf16
    decode of the same weights (the bf16 floor: logged); falcon-mamba's
    (c): ``FAULT_STEPS`` of the chain on blocks with ``in_proj``'s ranks 1
    and 2 swapped, which must fail the logit limit."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.mesh import make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import layout_for, shard_tree

    cfg32 = cfg.with_(dtype="float32")
    mesh = serve_mesh(mesh_shape)
    label = f"phase {phase} (b) {cfg.name} {mesh_shape} float32 gate"
    ref_bundle = build_model(cfg32, ParallelContext(device="cuda", layout=cfg.layout))
    bundle = build_model(cfg32, make_pctx(mesh, device="cuda", global_batch=B,
                                          layout=cfg.layout))
    bf16 = build_model(cfg, ParallelContext(device="cuda", layout=cfg.layout))
    params = ref_bundle.init(0)
    ref_state, tok = family_start(torch, dev, ref_bundle, params, B, 53)
    chain, ref, _, ref_a, _ = serve_decode(torch, ref_bundle, params, ref_state, tok, steps)
    del ref_state
    p16 = as_layout_of(params, meta_params(cfg))
    state16, _ = family_start(torch, dev, bf16, p16, B, 53)
    _, floor16, _, _, _ = serve_decode(torch, bf16, p16, state16, tok, steps, feed=chain)
    del p16, state16
    state, _ = family_start(torch, dev, bundle, params, B, 53)
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)
    del params
    free_device_memory(torch)
    _, got, _, ran, ledger = serve_decode(torch, bundle, blocks, state, tok, steps, feed=chain)
    want_a = decode_a_calls(cfg) * steps
    if ran != want_a or ref_a != want_a:
        raise AssertionError(f"{label}: A launches {ran} on the blocks, {ref_a} replicated, "
                             f"expected {want_a}")
    serve_bytes_gate(label, ledger, layout, cfg32, B, steps)
    tok_ratio, logit_ratio, diff, spread = spread_gaps(torch, got, ref)
    floor = spread_gaps(torch, floor16, ref)
    gate = {"layers": cfg.n_layers, "dtype": "float32", "max_token_gap_over_spread": tok_ratio,
            "max_logit_diff_over_spread": logit_ratio, "max_logit_abs_diff": diff,
            "median_spread": spread, "bf16_floor_token_gap_over_spread": floor[0],
            "bf16_floor_logit_diff_over_spread": floor[1]}
    if cfg.family == "ssm":
        _, wrong, _, _, _ = serve_decode(torch, bundle, swapped_in_proj(blocks), state, tok,
                                         FAULT_STEPS, feed=chain)
        gate.update(fault="in_proj blocks of ranks 1 and 2 swapped", fault_steps=FAULT_STEPS,
                    fault_logit_diff_over_spread=spread_gaps(torch, wrong,
                                                             ref[:, :FAULT_STEPS])[1])
        del wrong
    log(f"  {label}: {cfg.n_layers} layers, batch {B}, {steps} steps of the replicated SP-1 "
        f"decode fed through the serve blocks: tokens within {tok_ratio:.2e} and logits within "
        f"{logit_ratio:.2e} of the row spread (limits {WITNESS_GAP} and {SERVE_TP_LOGIT_GAP}; "
        f"max |diff| {diff:.2e}, median spread {spread:.3f}), A launches {ran}, bytes = the "
        f"closed form; the replicated bf16 decode of the same weights fed the same chain reads "
        f"{floor[0]:.4f} and {floor[1]:.4f} (the bf16 floor)"
        + (f"; in_proj's ranks 1 and 2 swapped: logits {gate['fault_logit_diff_over_spread']:.4f}"
           f" of the row spread over {FAULT_STEPS} steps (must fail the limit)"
           if "fault" in gate else ""))
    if not (bool(torch.isfinite(got).all()) and tok_ratio <= WITNESS_GAP
            and logit_ratio <= SERVE_TP_LOGIT_GAP):
        raise AssertionError(f"{label}: a token {tok_ratio:.4f} and a logit {logit_ratio:.4f} "
                             f"of the row spread from the replicated decode (limits "
                             f"{WITNESS_GAP}, {SERVE_TP_LOGIT_GAP})")
    if "fault" in gate and not gate["fault_logit_diff_over_spread"] > SERVE_TP_LOGIT_GAP:
        raise AssertionError(f"{label}: the swapped in_proj blocks stay within "
                             f"{gate['fault_logit_diff_over_spread']:.4f} of the row spread: "
                             f"the limit {SERVE_TP_LOGIT_GAP} would not see them")
    del blocks, state, got, ref, floor16
    free_device_memory(torch)
    return gate


def phase_family_tp(torch, dev, name, layers=None, with_profile=False, B=FAMILY_TP_BATCH,
                    steps=FAMILY_TP_STEPS):
    """Phase 24 (b): ``name`` at full width (``layers`` of its layers),
    bf16, on the virtual (1, 4) mesh, the slice's main path: ``steps``
    greedy steps of the replicated SP-1 decode on the kernels, the tree cut
    to serve blocks and freed, the reference's chain fed through the
    blocks (their token and logit gaps from the replicated decode logged
    as shares of its row spread), then ``steps`` greedy steps timed; the
    ledger's bytes = the closed form; ``state_bytes`` of the whole model
    for a model axis of 4 and 8.  The gate of the blocks' values is
    :func:`phase_family_gate`'s, in float32: two bf16 decodes that sum in
    other orders part by as much as either parts from its float32 run.
    Returns A's launches of the timed steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.mesh import data_mesh, make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import ServeBlocks, layout_for, shard_tree, state_bytes

    full_cfg = ARCHS[name]
    cfg = full_cfg.with_(n_layers=layers) if layers else full_cfg
    mesh = data_mesh(1, 4)
    label = f"serving_tp_{cfg.family}"
    ref_bundle = build_model(cfg, ParallelContext(device="cuda", layout=cfg.layout))
    bundle = build_model(cfg, make_pctx(mesh, device="cuda", global_batch=B, layout=cfg.layout))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ref_bundle.init(0)
    weight_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    ref_state, tok = family_start(torch, dev, ref_bundle, params, B, 47)
    state, _ = family_start(torch, dev, bundle, params, B, 47)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    chain, ref, ref_ms, ref_a, _ = serve_decode(torch, ref_bundle, params, ref_state, tok, steps,
                                                timed=True)
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)
    del params, ref_state
    free_device_memory(torch)
    cut_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls = {}
    with recorded_a_calls(calls):
        _, forced, _, _, _ = serve_decode(torch, bundle, blocks, state, tok, steps, feed=chain)
    own, got, ms, ran, ledger = serve_decode(torch, bundle, blocks, state, tok, steps,
                                             timed=True)
    serve_peak = torch.cuda.max_memory_allocated()
    want_a = decode_a_calls(cfg) * steps
    if ran != want_a or ref_a != want_a:
        raise AssertionError(f"{label}: A launches {ran} on the blocks, {ref_a} replicated, "
                             f"expected {want_a}")
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(forced).all())):
        raise AssertionError(f"{label}: non-finite logits on the blocks")
    replay_err, replayed = replay_a_calls(torch, calls, label), len(calls)
    del calls
    closed = serve_bytes_gate(label, ledger, layout, cfg, B, steps)
    tok_ratio, logit_ratio, diff, spread = spread_gaps(torch, forced, ref)
    blocks_bytes = sum(x.blocks.numel() * x.blocks.element_size() if isinstance(x, ServeBlocks)
                       else x.numel() * x.element_size() for x in tree_leaves(blocks))
    held = sum(x.numel() * x.element_size() for x in state.values())
    med, ref_med = statistics.median(ms), statistics.median(ref_ms)
    full_meta = meta_params(full_cfg)
    full_state = {m: state_bytes(layout_for(full_meta, data_mesh(1, m), mode="serve"))
                  for m in (4, 8)}
    full_tp = closed_form(full_cfg)(layout_for(full_meta, mesh, mode="serve"), full_cfg, B)
    res = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "full_layers": full_cfg.n_layers, "mesh": dict(mesh.shape), "storage": "serve",
           "batch": B, "steps": steps, "start_s": t_start, "median_step_ms": med,
           "step_ms": ms, "replicated_median_step_ms": ref_med, "replicated_step_ms": ref_ms,
           "weight_bytes": weight_bytes, "blocks_bytes": blocks_bytes,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "state_bytes_held": held,
           "read_bound_ms": (weight_bytes + held) / HBM_BYTES_PER_S * 1e3,
           "tp_bytes_per_step": closed["tp"]["fwd"], "link_bytes_per_step":
           closed["link"]["fwd"], "peak_bytes_cut": cut_peak, "peak_bytes_serve": serve_peak,
           "state_bytes_full_depth": full_state, "tp_bytes_per_step_full_depth":
           full_tp["tp"]["fwd"], "launches": ran, "replicated_launches": ref_a,
           "a_launches_per_step": decode_a_calls(cfg),
           "bf16_token_gap_over_spread": tok_ratio, "bf16_logit_diff_over_spread": logit_ratio,
           "bf16_max_logit_abs_diff": diff, "median_spread": spread,
           "a_calls_replayed": replayed, "a_calls_max_abs_err": replay_err,
           "greedy_equal_to_replicated": int((own == chain).sum()), "tokens": chain.numel()}
    log(f"  {cfg.name}: {cfg.n_layers} of {full_cfg.n_layers} layers, {weight_bytes / 1e9:.2f} "
        f"GB in bf16, serve blocks over {dict(mesh.shape)}, batch {B}, started in "
        f"{t_start:.2f} s; decode step median {med:.3f} ms (replicated SP 1 {ref_med:.3f} ms), "
        f"weight-read bound {res['weight_read_bound_ms']:.3f} ms ({res['read_bound_ms']:.3f} "
        f"with the state); TP bytes a step, rank and direction {closed['tp']['fwd']:.0f} = the "
        f"closed form (link {closed['link']['fwd']:.0f}); peak {cut_peak / 1e9:.2f} GB at the "
        f"cut, {serve_peak / 1e9:.2f} GB serving; A launches {ran} ({decode_a_calls(cfg)} a "
        f"step); the replicated chain fed through the blocks: tokens within {tok_ratio:.4f} and "
        f"logits within {logit_ratio:.4f} of the row spread (max |diff| {diff:.4f}, median "
        f"spread {spread:.3f}; bf16, logged: the gate is float32's); greedy tokens equal to the "
        f"replicated decode's {res['greedy_equal_to_replicated']} of {chain.numel()}; A's "
        f"{replayed} call shapes on the blocks replayed against the plain version, max |out "
        f"err| {replay_err:.3e}; "
        f"state_bytes at {full_cfg.n_layers} layers {full_state[4] / 1e9:.3f} GB (model 4), "
        f"{full_state[8] / 1e9:.3f} GB (model 8)")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: serve_decode(torch, bundle, blocks, state,
                                                                  tok, 4), 4 * med / 1e3)
    del blocks, state, forced, got, ref
    free_device_memory(torch)
    gate_cfg = full_cfg.with_(n_layers=FAMILY_F32_LAYERS.get(name, full_cfg.n_layers))
    res["float32_gate"] = phase_family_gate(torch, dev, gate_cfg, B)
    log(f"RESULT {label} " + json.dumps(res))
    return ran


# ---------------------------------------------------------------------------
# phase 25: every family's decode step on serve-mode storage over the pod
# mesh (pod, data, model)
# ---------------------------------------------------------------------------

POD_CHECKS = (("qwen3-moe-30b-a3b", dict(n_layers=SERVE_CHECK_LAYERS)),
              (MAMBA, dict(n_layers=MAMBA_CHECK_LAYERS)),
              (RG, dict(n_layers=RG_CHECK_LAYERS)))
POD_CHECK_MESHES = ((2, 1, 2), (2, 2, 2))  # virtual (pod, data, model) meshes
POD_ARCH = "qwen3-moe-30b-a3b"
POD_LAYERS = 8  # of 48: 10.9 GB in bf16
POD_MESHES = ((2, 1, 2), (1, 1, 4))  # (b)'s timed meshes, both SP 4
POD_FULL_MESH = (2, 16, 16)  # the reference's multi-pod production mesh


def phase_serve_pod(torch, dev, with_profile=False, layers=POD_LAYERS, B=FAMILY_TP_BATCH,
                    steps=FAMILY_TP_STEPS):
    """Phase 25 (b): qwen3-moe-30b-a3b at full width, ``layers`` of its 48,
    bf16, batch ``B``, from a seeded synthetic dense slab at length
    ``RG_SYNTH_LEN``: ``steps`` greedy steps of the replicated SP-1 decode
    on the kernels (the reference), the tree cut to serve blocks over the
    virtual (2, 1, 2) and (1, 1, 4) meshes (both SP 4: experts over all 4
    ranks, two EP slices in a model block on the first) and freed, the
    reference's chain fed through each (token and logit gaps logged as
    shares of its row spread), then ``steps`` greedy steps on each timed
    with CUDA events beside the replicated step, the weight-read bound,
    the peak memory, the bytes a step (= ``serve_comm_bytes``) and
    ``state_bytes`` at 48 layers on (2, 16, 16); the timed runs go (2, 1,
    2), (1, 1, 4), then again in the other order, each mesh's median over
    both of its passes.  The gate of the blocks'
    values is :func:`phase_family_gate`'s, in float32 at the same depth on
    (2, 1, 2).  Kernel A's calls on the (2, 1, 2) blocks (the first of each
    shape) are replayed through its wrapper twice and against its plain
    version.  ``with_profile``: 4 steps on (2, 1, 2) under torch.profiler.
    Returns A's launches of the timed (2, 1, 2) steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.mesh import make_pctx
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import ServeBlocks, layout_for, shard_tree, state_bytes

    full_cfg = ARCHS[POD_ARCH]
    cfg = full_cfg.with_(n_layers=layers)
    label = "serving_tp_pod"
    meshes = {shape: serve_mesh(shape) for shape in POD_MESHES}
    ref_bundle = build_model(cfg, ParallelContext(device="cuda"))
    bundles = {shape: build_model(cfg, make_pctx(mesh, device="cuda", global_batch=B))
               for shape, mesh in meshes.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ref_bundle.init(0)
    weight_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    ref_state, tok = family_start(torch, dev, ref_bundle, params, B, 59)
    states = {shape: family_start(torch, dev, b, params, B, 59)[0] for shape, b in bundles.items()}
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    chain, ref, ref_ms, ref_a, _ = serve_decode(torch, ref_bundle, params, ref_state, tok, steps,
                                                timed=True)
    layouts = {shape: layout_for(params, mesh, mode="serve") for shape, mesh in meshes.items()}
    blocks = {shape: shard_tree(params, lay) for shape, lay in layouts.items()}
    del params, ref_state
    free_device_memory(torch)
    cut_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want_a = cfg.n_layers * steps
    if ref_a != want_a:
        raise AssertionError(f"{label}: A launches {ref_a} replicated, expected {want_a}")
    calls, runs = {}, {}
    for shape in POD_MESHES:
        tag = "x".join(map(str, shape))
        bundle, tree, state = bundles[shape], blocks[shape], states[shape]
        with recorded_a_calls(calls if shape == POD_MESHES[0] else {}):
            _, forced, _, _, _ = serve_decode(torch, bundle, tree, state, tok, steps, feed=chain)
        own, got, ms, ran, ledger = serve_decode(torch, bundle, tree, state, tok, steps,
                                                 timed=True)
        if ran != want_a:
            raise AssertionError(f"{label} {tag}: A launches {ran}, expected {want_a}")
        if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(forced).all())):
            raise AssertionError(f"{label} {tag}: non-finite logits on the blocks")
        closed = serve_bytes_gate(f"{label} {tag}", ledger, layouts[shape], cfg, B, steps)
        tok_ratio, logit_ratio, diff, spread = spread_gaps(torch, forced, ref)
        held = sum(x.blocks.numel() * x.blocks.element_size() if isinstance(x, ServeBlocks)
                   else x.numel() * x.element_size() for x in tree_leaves(tree))
        runs[tag] = {"mesh": dict(meshes[shape].shape), "median_step_ms": statistics.median(ms),
                     "step_ms": ms, "launches": ran, "blocks_bytes": held,
                     "bytes_per_step": {c: v["fwd"] for c, v in closed.items()},
                     "bf16_token_gap_over_spread": tok_ratio,
                     "bf16_logit_diff_over_spread": logit_ratio,
                     "bf16_max_logit_abs_diff": diff, "median_spread": spread,
                     "greedy_equal_to_replicated": int((own == chain).sum())}
        del forced, got, own
    for shape in reversed(POD_MESHES):  # a second timed pass in the other order: A B B A
        tag = "x".join(map(str, shape))
        _, _, ms, _, _ = serve_decode(torch, bundles[shape], blocks[shape], states[shape], tok,
                                      steps, timed=True)
        run = runs[tag]
        run["pass_median_step_ms"] = [run["median_step_ms"], statistics.median(ms)]
        run["step_ms"] += ms
        run["median_step_ms"] = statistics.median(run["step_ms"])
    serve_peak = torch.cuda.max_memory_allocated()
    replay_err, replayed = replay_a_calls(torch, calls, label), len(calls)
    del calls
    pod, flat = ("x".join(map(str, shape)) for shape in POD_MESHES)
    cache_bytes = sum(states[POD_MESHES[0]][k].numel() * states[POD_MESHES[0]][k].element_size()
                      for k in ("k", "v"))
    ref_med = statistics.median(ref_ms)
    full_state = state_bytes(layout_for(meta_params(full_cfg), serve_mesh(POD_FULL_MESH),
                                        mode="serve"))
    res = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "full_layers": full_cfg.n_layers, "storage": "serve", "batch": B, "steps": steps,
           "start_len": RG_SYNTH_LEN, "start_s": t_start, "runs": runs,
           "median_step_ms": runs[pod]["median_step_ms"],
           "flat_median_step_ms": runs[flat]["median_step_ms"],
           "replicated_median_step_ms": ref_med, "replicated_step_ms": ref_ms,
           "weight_bytes": weight_bytes,
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "cache_bytes": cache_bytes,
           "read_bound_ms": (weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
           "peak_bytes_cut": cut_peak, "peak_bytes_serve": serve_peak,
           "state_bytes_full_depth_2x16x16": full_state, "launches": runs[pod]["launches"],
           "replicated_launches": ref_a, "a_calls_replayed": replayed,
           "a_calls_max_abs_err": replay_err, "tokens": chain.numel()}
    log(f"  {cfg.name}: {cfg.n_layers} of {full_cfg.n_layers} layers, {weight_bytes / 1e9:.2f} "
        f"GB in bf16, batch {B} from a synthetic slab at length {RG_SYNTH_LEN}, started in "
        f"{t_start:.2f} s; decode step median {runs[pod]['median_step_ms']:.3f} ms on {pod}, "
        f"{runs[flat]['median_step_ms']:.3f} ms on {flat} (replicated SP 1 {ref_med:.3f} ms), "
        f"weight-read bound {res['weight_read_bound_ms']:.3f} ms ({res['read_bound_ms']:.3f} "
        f"with the cache); bytes a step, rank and direction = serve_comm_bytes: {pod} "
        f"{runs[pod]['bytes_per_step']}, {flat} {runs[flat]['bytes_per_step']}; peak "
        f"{cut_peak / 1e9:.2f} GB at the cut, {serve_peak / 1e9:.2f} GB serving; A launches "
        f"{runs[pod]['launches']} a run; the replicated chain fed through the blocks: tokens "
        f"within {runs[pod]['bf16_token_gap_over_spread']:.4f} ({pod}) and "
        f"{runs[flat]['bf16_token_gap_over_spread']:.4f} ({flat}), logits within "
        f"{runs[pod]['bf16_logit_diff_over_spread']:.4f} and "
        f"{runs[flat]['bf16_logit_diff_over_spread']:.4f} of the row spread (bf16, logged: the "
        f"gate is float32's); A's {replayed} call shapes on the blocks replayed against the "
        f"plain version, max |out err| {replay_err:.3e}; state_bytes at 48 layers on "
        f"{POD_FULL_MESH} {full_state / 1e9:.3f} GB")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: serve_decode(
            torch, bundles[POD_MESHES[0]], blocks[POD_MESHES[0]], states[POD_MESHES[0]], tok, 4),
            4 * runs[pod]["median_step_ms"] / 1e3)
    ran = runs[pod]["launches"]
    del blocks, states, ref
    free_device_memory(torch)
    res["float32_gate"] = phase_family_gate(torch, dev, cfg, B, mesh_shape=POD_MESHES[0],
                                            phase=25)
    log(f"RESULT {label} " + json.dumps(res))
    return ran


PROFILED_PHASES = (6, 9, 11, 13, 16, 17, 18, 19, 20, 23, 24, 25)


def profiled_phases(argv):
    """The phases whose runs ``argv`` asks to profile."""
    for arg in argv:
        if arg == "--profile":
            return set(PROFILED_PHASES)
        if arg.startswith("--profile="):
            phases = {int(x) for x in arg.split("=", 1)[1].split(",")}
            if not phases <= set(PROFILED_PHASES):
                raise SystemExit(f"--profile: phases {sorted(phases)} not among "
                                 f"{PROFILED_PHASES}")
            return phases
    return set()


# ---------------------------------------------------------------------------
# phase 26: the dry run (repro_torch.launch.dryrun) against the card
# ---------------------------------------------------------------------------

# Each RESULT's dict by its name (phase 26 reads phase 9's peak).
RESULTS: dict = {}
# The dry run's predicted peak against the card's measured one, relative:
# the tracker counts every storage an operation makes, rounded to the
# caching allocator's 512 bytes; the card also holds what the tracker cannot
# see (cuBLAS's workspace, the allocator's unsplit block remainders).
DRYRUN_LIMIT = 0.10
# (c)'s cells: traced on rank 0 of (16, 16) in processes of their own.  A
# train cell's trace takes minutes of one core, more than the phase's
# minute: the tests and the sweep trace those.
DRYRUN_CELLS = (("qwen2-72b", "decode_32k"),)
DRYRUN_OUT = ROOT / "build" / "dryrun_cells"
_DRYRUN_PROCS: list = []


def start_dryrun_cells():
    """Start (c)'s dry runs, one process a cell, with no card visible (the
    trace's fakes are CPU tensors then, as on a machine without a card);
    phase 26 runs (a) and (b) while they trace, then collects them."""
    import atexit
    import os

    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(SRC)}
    atexit.register(stop_dryrun_cells)
    for arch, shape in DRYRUN_CELLS:
        out = open(DRYRUN_OUT / f"{arch}__{shape}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--out", str(DRYRUN_OUT), "--force"],
            env=env, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        out.close()
        _DRYRUN_PROCS.append((arch, shape, proc))


def stop_dryrun_cells():
    for _, _, proc in _DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_dryrun(torch, dev):
    """Phase 26 (module docstring)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.launch.dryrun import memory_record, trace_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    start_dryrun_cells()
    res = {"limit": DRYRUN_LIMIT}

    def held(label, pred, meas):
        rel = abs(pred - meas) / meas
        if not rel <= DRYRUN_LIMIT:
            raise AssertionError(f"phase 26 {label}: the dry run predicts a peak of {pred} B, "
                                 f"the card measured {meas} B ({100 * rel:.2f}% apart, limit "
                                 f"{100 * DRYRUN_LIMIT:.0f}%)")
        return rel

    def traced(cfg, shape):
        reset_launch_counts()
        t = time.perf_counter()
        tr = trace_step(cfg, shape, ParallelContext(device="cuda"))
        secs = time.perf_counter() - t
        if any(launch_counts().values()) or _paged_launches():
            raise AssertionError(f"phase 26: the dry run of {cfg.name} counted launches "
                                 f"{launch_counts()}")
        mem = memory_record(tr)
        return mem, tr["analysis"].stats.as_dict(), secs

    # (a) phase 9's step at world 1
    cfg = ARCHS["qwen3-1.7b"]
    mem, stats, secs = traced(cfg, ShapeConfig("phase9", 4096, 2, "train"))
    meas = RESULTS["training"]["peak_bytes_timed_steps"]
    rel = held("(a)", mem["peak_bytes_per_device"], meas)
    res["a"] = {"arch": cfg.name, "batch": 2, "seq": 4096, "remat": cfg.remat,
                "predicted_peak_bytes": mem["peak_bytes_per_device"],
                "measured_peak_bytes": meas, "relative_gap": rel, "memory": mem,
                "step_stats": stats, "trace_s": secs}
    log(f"  (a) {cfg.name} training step (batch 2 x 4096, remat {cfg.remat}): predicted peak "
        f"{mem['peak_bytes_per_device'] / 2**30:.3f} GiB against phase 9's "
        f"{meas / 2**30:.3f} GiB ({100 * rel:.2f}% apart; split at the peak "
        f"{ {k: round(v / 2**30, 3) for k, v in mem['split_at_peak'].items()} } GiB); "
        f"traced in {secs:.1f} s, no launch counted")

    # (b) the decode step at SP 1 on the card against its prediction
    cfg = ARCHS["qwen3-1.7b"].with_(param_dtype="bfloat16", remat="none")
    B, S, steps = 8, 4096, 4
    mem, stats, secs = traced(cfg, ShapeConfig("decode_4k", S, B, "decode"))
    free_device_memory(torch)
    base = torch.cuda.memory_allocated()
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    params = bundle.init(0)
    state = bundle.init_serve_state(B, S, "cuda")
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        logits, state = bundle.decode_step(params, tok, state)
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    meas = torch.cuda.max_memory_allocated() - base
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 26 (b): non-finite logits")
    rel = held("(b)", mem["peak_bytes_per_device"], meas)
    res["b"] = {"arch": cfg.name, "batch": B, "slab": S, "steps": steps,
                "predicted_peak_bytes": mem["peak_bytes_per_device"],
                "measured_peak_bytes": meas, "allocated_before_bytes": base,
                "relative_gap": rel, "memory": mem, "step_stats": stats, "trace_s": secs}
    log(f"  (b) {cfg.name} decode step (bf16, batch {B}, dense slab {S}, SP 1), {steps} steps: "
        f"predicted peak {mem['peak_bytes_per_device'] / 2**30:.3f} GiB against "
        f"{meas / 2**30:.3f} GiB on the card above the {base / 2**20:.1f} MiB held before "
        f"({100 * rel:.2f}% apart); traced in {secs:.1f} s, no launch counted")
    del params, state, logits, bundle
    free_device_memory(torch)

    # (c) the (16, 16) cells, traced in their own processes since the
    # phase began
    res["c"] = []
    for arch, shape, proc in _DRYRUN_PROCS:
        t = time.perf_counter()
        rc = proc.wait(timeout=300)
        waited = time.perf_counter() - t
        logf = DRYRUN_OUT / f"{arch}__{shape}.log"
        if rc != 0:
            raise AssertionError(f"phase 26 (c) {arch} {shape}: the dry run exited {rc}: "
                                 + logf.read_text()[-2000:])
        rec = json.loads((DRYRUN_OUT / f"{arch}__{shape}__pod__tokenring.json").read_text())
        m, roof = rec["memory"], rec["roofline"]
        row = {"arch": arch, "shape": shape, "status": rec["status"],
               "state_bytes_per_rank": m["argument_bytes_per_device"],
               "peak_bytes_per_rank": m["peak_bytes_per_device"], "dominant": roof["dominant"],
               "bound_s": roof["bound_s"], "trace_s": rec["timing"]["trace_s"],
               "groups_s": rec["timing"]["groups_s"], "waited_s": waited}
        res["c"].append(row)
        log(f"  (c) {arch} {shape} on (16, 16), rank 0 of 256: state "
            f"{row['state_bytes_per_rank'] / 2**30:.3f} GiB, peak "
            f"{row['peak_bytes_per_rank'] / 2**30:.3f} GiB, dominant {row['dominant']} (bound "
            f"{row['bound_s'] * 1e3:.2f} ms); traced in {row['trace_s']:.1f} s (subgroups "
            f"{row['groups_s']:.2f} s), waited {waited:.1f} s for it here")
    res["seconds"] = time.perf_counter() - t0
    log(f"RESULT dryrun " + json.dumps(res))
    log(f"  phase 26 took {res['seconds']:.1f} s")


def _paged_launches() -> int:
    from repro_torch.kernels import paged_attention as pa

    return pa.paged_decode_fwd_cuda.launches


def free_device_memory(torch):
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"no src/repro_torch beside {__file__}: run from a checkout", file=sys.stderr)
        return 2
    prof = profiled_phases(sys.argv[1:])
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== phase 1: toolchain")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True, timeout=60)
    if nvcc.returncode != 0:
        from repro_torch.kernels._build import _nvcc

        nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60, check=True)
    card = smi_line()
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_v}")
    log("  nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    log(f"  card: {card}; device count {torch.cuda.device_count()}")

    log("== phase 2: build")
    phase_build(torch, dev)

    log("== phase 3: kernel A (flash forward) vs plain")
    flash_rows = phase_flash(torch, dev)
    log("== phase 4: kernel C (paged decode) vs plain")
    paged_rows = phase_paged(torch, dev)
    log("== phase 5: paged and dense-slab engines on the kernels, teacher-forced vs the plain "
        "path")
    phase_e2e_checked(torch, dev)
    log("== phase 6: qwen3-1.7b full width and depth, serving")
    launches, sp1_outputs = phase_full(torch, dev, 6 in prof)
    free_device_memory(torch)
    log("== phase 7: kernels B1 and B2 (flash backward) vs plain")
    bwd_rows = phase_bwd(torch, dev)
    free_device_memory(torch)
    log("== phase 8: one training step on the kernels vs the plain path")
    phase_train_checked(torch, dev)
    free_device_memory(torch)
    phase_train_checked_bf16(torch, dev)
    free_device_memory(torch)
    log("== phase 9: qwen3-1.7b full width and depth, training")
    launches["train"] = phase_train_full(torch, dev, 9 in prof)
    free_device_memory(torch)
    log("== phase 10: the ring strategies on the kernels vs the plain path, virtual ring of P "
        "ranks on one card")
    ring_trace = phase_ring(torch, dev)
    free_device_memory(torch)
    ring_trace["strategies"] = phase_strategies(torch, dev)
    free_device_memory(torch)
    phase_train_checked(torch, dev, S=1024, label="phase 10 ring step (tokenring, P=4)",
                        sp_degree=4, strategy="tokenring")
    free_device_memory(torch)
    log("== phase 11: qwen3-1.7b full width and depth, training through TokenRing over 4 "
        "virtual ranks")
    launches["train_ring"] = phase_train_ring(torch, dev, 11 in prof)
    free_device_memory(torch)
    log("== phase 12: sequence-parallel serving on the kernels vs the plain path, virtual ring "
        "of P ranks on one card")
    phase_sp_attention(torch, dev)
    free_device_memory(torch)
    sp_rows = phase_sp_main_shapes(torch, dev)
    free_device_memory(torch)
    phase_e2e_checked(torch, dev, sp_degree=4, label="phase 12")
    free_device_memory(torch)
    phase_e2e_checked(torch, dev, sp_degree=4, label="phase 12", prefix_cache=True)
    free_device_memory(torch)
    log("== phase 13: qwen3-1.7b full width and depth, served over 4 virtual ranks")
    sp_launches, sp_outputs = phase_full(torch, dev, 13 in prof, sp_degree=4,
                                         reference=sp1_outputs)
    launches.update(sp_launches)
    free_device_memory(torch)
    teacher_forced_witness(torch, dev, sp_outputs)
    free_device_memory(torch)
    log("== phase 14: qwen3-1.7b full width and depth, served with the prefix cache, faults "
        "and a snapshot restart")
    phase_prefix_serving(torch, dev, launches)
    free_device_memory(torch)
    log(f"== phase 15: qwen3-1.7b full width, {CKPT_LAYERS} layers, checkpoint/restart training "
        "and remat "
        "dots")
    launches.update(phase_train_ckpt(torch, dev))
    free_device_memory(torch)
    log("== phase 16: qwen3-1.7b full width and depth, training through Ulysses and through "
        "the 2 x 2 multi-pod hybrid over 4 virtual ranks (main path); the serve CLI's "
        "adaptive-prefill line")
    launches["train_ulysses"] = phase_train_ring(torch, dev, 16 in prof, steps=2,
                                                 strategy="ulysses", sequential=False,
                                                 result="training_ulysses")
    free_device_memory(torch)
    launches["train_hybrid"] = phase_train_ring(torch, dev, 16 in prof, steps=2, pods=2,
                                                sequential=False, result="training_hybrid")
    free_device_memory(torch)
    serve_cli_adaptive_prefill(torch, dev)
    free_device_memory(torch)

    log("== phase 17: the MoE and VLM families: qwen3-moe-30b-a3b checked at 2 layers (SP 1 "
        "and 4 virtual ranks with expert parallelism), served at full width and depth (main "
        f"path), trained at full width ({MOE_TRAIN_LAYERS} layers, SP 1 and 4); "
        f"llama4-scout ({LLAMA4_LAYERS} layers); pixtral-12b")
    from repro_torch.configs import ARCHS

    phase_moe_checked(torch, dev)
    moe_cfg = ARCHS["qwen3-moe-30b-a3b"]
    served, _ = phase_full(torch, dev, 17 in prof, cfg=moe_cfg, paths=("paged",), tag="serving_moe")
    launches["moe_paged"] = served["paged"]
    free_device_memory(torch)
    train_cfg = moe_cfg.with_(n_layers=MOE_TRAIN_LAYERS)
    launches["train_moe"] = phase_train_full(torch, dev, 17 in prof, cfg=train_cfg, steps=2,
                                             result="training_moe")
    free_device_memory(torch)
    launches["train_moe_ring"] = phase_train_ring(torch, dev, 17 in prof, cfg=train_cfg, steps=2,
                                                  sequential=False, result="training_moe_ring",
                                                  sp1_limit=None)
    free_device_memory(torch)
    served, _ = phase_full(torch, dev, False,
                           cfg=ARCHS["llama4-scout-17b-a16e"].with_(n_layers=LLAMA4_LAYERS),
                           paths=("dense",), tag="serving_llama4")
    launches["llama4_dense"] = served["dense"]
    free_device_memory(torch)
    launches["pixtral"] = phase_vlm(torch, dev)
    free_device_memory(torch)

    log("== phase 18: the encoder-decoder family: whisper-base checked at 2+2 layers (SP 1 "
        "and TokenRing over 4 virtual ranks), trained at full width and depth (SP 1 and 4, "
        "main path), served by encode-then-decode (SP 1 and 4) and through the serve CLI")
    whisper = ARCHS["whisper-base"]
    phase_whisper_checked(torch, dev)
    free_device_memory(torch)
    launches["train_whisper"] = phase_train_full(
        torch, dev, 18 in prof, cfg=whisper, B=WHISPER_TRAIN_BATCH, steps=2,
        result="training_whisper")
    free_device_memory(torch)
    launches["train_whisper_ring"] = phase_train_ring(
        torch, dev, 18 in prof, cfg=whisper, B=WHISPER_TRAIN_BATCH, steps=2, sequential=False,
        result="training_whisper_ring")
    free_device_memory(torch)
    launches["serve_whisper"] = phase_whisper_serving(torch, dev, 18 in prof)
    free_device_memory(torch)
    launches["serve_whisper_sp4"] = phase_whisper_serving(torch, dev, 18 in prof, sp_degree=4,
                                                          result="serving_whisper_sp4")
    free_device_memory(torch)
    serve_cli_whisper(torch, dev)
    free_device_memory(torch)

    log("== phase 19: the SSM family: falcon-mamba-7b checked at 2 layers in float32 (sp_scan "
        "at P = 2/4/8 and 2 x 2 pods, the loss and gradients at SP 1 and through the scan over "
        f"4 virtual ranks), trained at full width ({MAMBA_TRAIN_LAYERS} layers, SP 1 and 4, "
        "main path), decoded at full width and depth; lm_prefill at SP 4 on qwen3-1.7b")
    phase_mamba_scan(torch, dev)
    free_device_memory(torch)
    phase_mamba_checked(torch, dev)
    free_device_memory(torch)
    mamba_train = ARCHS[MAMBA].with_(n_layers=MAMBA_TRAIN_LAYERS)
    launches["train_mamba"] = phase_train_full(torch, dev, 19 in prof, cfg=mamba_train,
                                               result="training_mamba")
    free_device_memory(torch)
    launches["train_mamba_ring"] = phase_train_ring(torch, dev, 19 in prof, cfg=mamba_train,
                                                    sequential=False,
                                                    result="training_mamba_ring")
    free_device_memory(torch)
    launches["decode_mamba"] = phase_mamba_decode(torch, dev)
    free_device_memory(torch)
    launches["prefill_sp4"] = phase_prefill_sp(torch, dev)
    free_device_memory(torch)

    log("== phase 20: the hybrid family: kernels A (wgmma, CUDA-core and decode-core instances), "
        "B1 and B2 at head dim 256 against their plain versions; recurrentgemma-2b checked at "
        f"{RG_CHECK_LAYERS} layers in float32 (SP 1 and the window halo and scan over 4 virtual "
        "ranks), trained at full width and depth (SP 1 and 4, main path), decoded at full width "
        "and depth, its ring buffer wrapped")
    rg_rows = phase_rg_kernels(torch, dev)
    free_device_memory(torch)
    phase_rg_checked(torch, dev)
    free_device_memory(torch)
    rg_cfg = ARCHS[RG]
    launches["train_rg"] = phase_train_full(torch, dev, 20 in prof, cfg=rg_cfg,
                                            result="training_rg")
    free_device_memory(torch)
    launches["train_rg_ring"] = phase_train_ring(torch, dev, 20 in prof, cfg=rg_cfg,
                                                 sequential=False, result="training_rg_ring")
    free_device_memory(torch)
    launches["decode_rg"] = phase_rg_decode(torch, dev)
    free_device_memory(torch)
    phase_rg_wrap(torch, dev)
    free_device_memory(torch)

    log("== phase 21: the static analysis gate (schedule check, comm audit, kernel lint with "
        "the card's limits and the build's ptxas report, topology check)")
    phase_analysis(torch, dev)

    log("== phase 22: data parallelism with FSDP storage, each layer gathered just in time "
        "inside its remat region, over the virtual (data 2, model 4) mesh through TokenRing: "
        "qwen3-1.7b, whisper-base, falcon-mamba-7b and recurrentgemma-2b checked at full width "
        "in float32 (a few layers each); qwen3-1.7b trained at full depth (main path) against "
        "the (1, 4) mesh, re-meshed, restored across meshes, its gradients compressed over 8 "
        f"data ranks; llama2-7b trained at {DP_LLAMA_LAYERS} layers, which the whole-tree "
        "gather cannot fit")
    t22 = time.perf_counter()
    for name, over in DP_CHECK_CASES:
        phase_dp_checked(torch, dev, ARCHS[name].with_(dtype="float32", **over))
        free_device_memory(torch)
    launches["train_dp2_sp4"] = phase_train_dp(torch, dev)
    free_device_memory(torch)
    phase_dp_elastic(torch, dev)
    free_device_memory(torch)
    launches["train_dp_llama"] = phase_train_dp_llama(torch, dev)
    free_device_memory(torch)
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s")

    log("== phase 23: the decode step under serve-mode (Megatron) storage: qwen3-1.7b and "
        "qwen3-moe-30b-a3b checked at full width (2 layers, float32) on the virtual (1, 4) and "
        f"(2, 4) meshes; qwen2-72b at full width ({SERVE_TP_LAYERS} of 80 layers, main path) "
        "decoded on serve blocks over the virtual (1, 4) mesh")
    t23 = time.perf_counter()
    for name in SERVE_CHECK_ARCHS:
        for shape in SERVE_CHECK_MESHES:
            phase_serve_checked(torch, dev, name, shape)
    zero = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "paged_decode_fwd": 0}
    launches["serve_tp"] = {"flash_attention_fwd": phase_serve_tp(torch, dev, 23 in prof),
                            **zero}
    free_device_memory(torch)
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s")

    log("== phase 24: the encoder-decoder, SSM and hybrid decode steps under serve-mode "
        "(Megatron) storage: whisper-base, falcon-mamba-7b and recurrentgemma-2b checked at full "
        "width (float32, a few layers) on the virtual (1, 4) and (2, 4) meshes, recurrentgemma "
        "across its ring buffer's wrap at SP 4; recurrentgemma-2b (all 26 layers, main path), "
        f"falcon-mamba-7b ({MAMBA_SERVE_LAYERS} of 64 layers) and whisper-base decoded at full "
        "width on serve blocks over the virtual (1, 4) mesh; falcon-mamba's in_proj blocks "
        "swapped must fail the gate")
    t24 = time.perf_counter()
    for name, over in FAMILY_CHECKS:
        for shape in SERVE_CHECK_MESHES:
            phase_family_checked(torch, dev, name, over, shape)
    for name in FAMILY_TP_ARCHS:
        layers = MAMBA_SERVE_LAYERS if name == MAMBA else None
        ran = phase_family_tp(torch, dev, name, layers, with_profile=24 in prof and name == RG)
        launches[f"serve_tp_{ARCHS[name].family}"] = {"flash_attention_fwd": ran, **zero}
        free_device_memory(torch)
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s")

    log("== phase 25: every family's decode step under serve-mode (Megatron) storage over the "
        "pod mesh (pod, data, model): qwen3-moe-30b-a3b, falcon-mamba-7b and recurrentgemma-2b "
        "checked at full width (float32, a few layers) on the virtual (2, 1, 2) and (2, 2, 2) "
        "meshes, recurrentgemma across its ring buffer's wrap; the EP slices of pods 0 and 1 "
        f"swapped must fail the gate; qwen3-moe-30b-a3b ({POD_LAYERS} of 48 layers, main path) "
        "decoded at full width on serve blocks over the virtual (2, 1, 2) and (1, 1, 4) meshes")
    t25 = time.perf_counter()
    for name, over in POD_CHECKS:
        for shape in POD_CHECK_MESHES:
            if name == POD_ARCH:
                phase_serve_checked(torch, dev, name, shape, over["n_layers"], phase=25)
            else:
                phase_family_checked(torch, dev, name, over, shape, phase=25)
            free_device_memory(torch)
    launches["serve_tp_pod"] = {"flash_attention_fwd": phase_serve_pod(torch, dev, 25 in prof),
                                **zero}
    free_device_memory(torch)
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s")

    log("== phase 26: the dry run against the card: (a) phase 9's training step and (b) "
        "qwen3-1.7b's decode step traced on fake tensors, their predicted peaks against the "
        "card's; (c) qwen2-72b decode_32k on rank 0 of (16, 16)")
    phase_dryrun(torch, dev)

    log("== phase 27: summary")
    # `launches` is the count of the main path that runs the kernel (A, B1
    # and B2: whisper-base trained at full width and depth at SP 1, phase
    # 18's first training run; C, which no encoder-decoder path runs:
    # qwen3-moe-30b-a3b served by the paged engine, phase 17's serving
    # run); `launches_by_path` gives every driven path's count, each read
    # from counters set to 0 just before that run.  The times, errors and
    # bounds are those of the main path's calls at whisper's shapes (8/8
    # heads, D 64, bf16, non-causal): A's cross-attention of a training
    # step (phase 3: B=2, Sq=4096, Sk=1536), and B1 and B2 at the same
    # call (phase 7); C's at qwen3-moe's 32/4 heads and phase 6's lengths
    # (phase 4).  `whisper_calls` holds whisper's other calls (phase 3's
    # encoder and decode rows, phase 7's encoder and decoder rows);
    # `times_by_path` keeps qwen3-moe-30b-a3b's rows (32/4 heads, D 128:
    # phase 3's resident prefill call, phase 7's training shape) and
    # qwen3-1.7b's (16/8), and `sp4_calls` phase 13's SP-4 calls (phase 12).
    # Phase 19's paths are in `launches_by_path`: falcon-mamba's training
    # and decoding launch no kernel; `prefill_sp4` is lm_prefill at SP 4.
    # Phase 24's are `serve_tp_hybrid` (recurrentgemma-2b's decode on serve
    # blocks: A's D-256 decode instance, 8 launches a step),
    # `serve_tp_ssm` (falcon-mamba-7b's: none) and `serve_tp_encdec`
    # (whisper-base's: A's D-64 decode core, 12 launches a step).  Phase
    # 25's is `serve_tp_pod` (qwen3-moe-30b-a3b's decode on serve blocks over
    # the pod mesh (2, 1, 2): A's D-128 decode core, 8 launches a step).
    # `f32_step` holds A's, B1's and B2's CUDA-core instances at the float32
    # calls of `F32_CORE_CALLS` (phase 7, `f32_step_rows`): phase 8's step,
    # the `--reduced` quickstart's and phase 20 (b)'s D-256 call.
    # `d256` holds the head-dim-256 instances (phase 20, recurrentgemma-2b):
    # each row's time, errors and bound from phase 20 (a) at the main path's
    # shapes, its `launches` from the main path that runs it (A's wgmma
    # instance, B1 and B2: the SP-1 training run; A's decode instance: the
    # full-depth decode; `decode_short` the decode call at phase 20 (d)'s
    # lengths).  C's `d256` row is phase 4's bf16 main-path shape at head dim
    # 256 (recurrentgemma's 10/1 heads): no driven path serves paged at D 256,
    # so its launches are 0.
    def d256(row, path, name):
        return {**row, "launches": launches[path][name], "path": path}

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    bwd = "src/repro/kernels/flash_attention.py:476"
    moe, dense, wb = "qwen3-moe-30b-a3b", "qwen3-1.7b", "whisper-base"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:244",
         "launches": launches["train_whisper"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"),
         "device_kernels": {"wgmma": ["rt::wg::flash_fwd_wgmma_kernel<D> (bf16; D 64, 128, "
                                      "256)"],
                            "decode": ["rt::dec::decode_kernel<T, D, WR, RW, false>",
                                       "rt::dcl::decode_d256_kernel<false> (bf16, D 256)"],
                            "cuda_core": ["rt::core::flash_fwd_core_kernel<T, D> (float32; bf16 "
                                          "at D 32)"]},
         **flash_rows[wb]["cross_prefill"],
         "training_shape": bwd_rows[wb]["cross"]["fwd"],
         "whisper_calls": {"encoder": flash_rows[wb]["encoder"],
                           "cross_decode": flash_rows[wb]["cross_decode"],
                           "encoder_training_shape": bwd_rows[wb]["encoder"]["fwd"],
                           "decoder_training_shape": bwd_rows[wb]["decoder"]["fwd"]},
         "times_by_path": {moe: {"prefill_resident": flash_rows[moe][256],
                                 "training_shape": bwd_rows[moe]["fwd"]},
                           dense: {"prefill_resident": flash_rows[dense][256],
                                   "decode": flash_rows[dense][1],
                                   "training_shape": bwd_rows[dense]["fwd"]}},
         "sp4_calls": {k: v for k, v in sp_rows.items() if k != "paged_decode"},
         "ring_overlap_trace": ring_trace,
         "f32_step": {c: r["fwd"] for c, r in bwd_rows["f32_step"].items()},
         "d256": {"wgmma": d256(rg_rows["wgmma"], "train_rg", "flash_attention_fwd"),
                  "decode": d256(rg_rows["decode"], "decode_rg", "flash_attention_fwd"),
                  "decode_short": d256(rg_rows["decode_short"], "decode_rg",
                                       "flash_attention_fwd")}},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:367",
         "device_kernels": {"wgmma": ["rt::wgb::flash_bwd_dq_wgmma_kernel<D> (bf16; D 64, 128, "
                                      "256)"],
                            "cuda_core": ["rt::core::flash_bwd_dq_core_kernel<T, D> (float32; "
                                          "bf16 at D 32)"]},
         "launches": launches["train_whisper"]["flash_attention_bwd_dq"],
         "launches_by_path": by_path("flash_attention_bwd_dq"), **bwd_rows[wb]["cross"]["dq"],
         "whisper_calls": {k: bwd_rows[wb][k]["dq"] for k in ("encoder", "decoder")},
         "times_by_path": {moe: bwd_rows[moe]["dq"], dense: bwd_rows[dense]["dq"]},
         "f32_step": {c: r["dq"] for c, r in bwd_rows["f32_step"].items()},
         "d256": d256(rg_rows["dq"], "train_rg", "flash_attention_bwd_dq")},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:415",
         "launches": launches["train_whisper"]["flash_attention_bwd_dkv"],
         "launches_by_path": by_path("flash_attention_bwd_dkv"), **bwd_rows[wb]["cross"]["dkv"],
         "whisper_calls": {k: bwd_rows[wb][k]["dkv"] for k in ("encoder", "decoder")},
         "times_by_path": {moe: bwd_rows[moe]["dkv"], dense: bwd_rows[dense]["dkv"]},
         "f32_step": {c: r["dkv"] for c, r in bwd_rows["f32_step"].items()},
         "d256": d256(rg_rows["dkv"], "train_rg", "flash_attention_bwd_dkv")},
        {"name": "paged_decode_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:192",
         "launches": launches["moe_paged"]["paged_decode_fwd"],
         "launches_by_path": by_path("paged_decode_fwd"),
         "device_kernels": ["rt::dec::decode_kernel<T, D, WR, RW, true>",
                            "rt::dcl::decode_d256_kernel<true> (bf16, D 256)"],
         **paged_rows[moe], "times_by_path": {dense: paged_rows[dense]},
         "sp4_calls": {"paged_decode": sp_rows["paged_decode"]},
         "d256": {**paged_rows["d256"], "launches": 0, "path": None}},
    ]
    log(f"== done in {time.perf_counter() - t_start:.1f} s (limit 1200 s)")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
