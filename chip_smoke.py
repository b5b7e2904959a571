"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its lines; any failure raises, so the script exits
non-zero and never prints the final `"ok": true` line (the d256 phases
are 7-9):

1. device   - a CUDA card of capability 9.0 (Hopper), its name and power
              limit from nvidia-smi; TF32 off for fp32 matmuls.
2. build    - compile the port's CUDA kernels from this checkout's sources
              (one nvcc per source, in parallel) and print ptxas's
              registers and spills per kernel, and any wgmma it serialises
              (C7518).
3. k1       - the flash-attention forward kernel against its plain PyTorch
              tile loop and against dense (vanilla) attention, at the GPT-2
              and Llama-3 8B prefill shapes and more (window, segment ids,
              the tile's ragged edges with a GQA group crossing the
              diagonal), each error beside its tolerance; the fp32 cases
              (the 3xTF32 K1, "flash_fwd_fp32", launched once a case),
              output and lse at 1e-5 at L1024 GQA 8/2 at D64 and D128, the
              Llama prefill shape (L1024, L900), the tile's edges (q129 x
              kv257), rows that see no key (exactly 0, lse -inf),
              non-causal, lq < lk, window and segments.
4. k2k3     - the backward's pre-pass (di and qs) against its plain
              expression; gradients of K1 + pre-pass + K2 + K3 through the
              autograd Function against the plain backward and against
              autograd of fp32 vanilla, at the tiles' edges (q129 x kv257,
              GQA 8/2, window 100; Lq 1023; rows that see no key), at the
              llama-train shape (b4, GQA 32/8, L1024, D128) and more; the
              fp32 cases (the 3xTF32 K2 / K3 up to head dim 128, the
              "_fp32" keys, launched once each a case) at the same edges at
              D64 and D128, the GPT-2 and Llama training shapes and 3
              segments at D128.
5. k4       - quantized-KV flash attention (int8/fp8 K/V) against its plain
              version and fp32 vanilla on the dequantized K/V (Lk % 4 != 0
              among them, so the scales' rows are unaligned), fp32 q (the
              3xTF32 K4, "flash_fwd_kv_quant_fp32") at 5e-5 at L1024 and
              the tile's edges; then the quant op's path (quantize_kv +
              flash_attention_kv_quant for 12 layers at b8 x T1024), in
              bf16 and in fp32, which must launch K4 12 times each.
6. decode   - K5 (paged) and K6 (slot-major) split-KV decode against their
              plain versions on bf16, fp32, int8 and fp8 caches with ragged
              lengths and at the split's edges (cache lengths 0, chunk - 1,
              chunk, chunk + 1, capacity - 1; also multi-query 16/1 at
              D128, L1024 and L2048), serving-mqa's layer (8 slots, 16/1
              D128, L2048, contexts past 1024 so that most of K6's 32
              splits are live) on bf16 and int8 caches, K5 with a
              permuted page table and NaN past the lengths, GQA 32/8 at
              D128; then every other head dim they take (8, 16, 32, 256,
              384, 512, 640, 768, 896, 1024) at groups 1 and 16 on bf16
              and int8 caches, fp32 q at D8-D1024, fp16 q over fp16, int8
              and fp8 caches at D64 and D128, GQA groups 12, 16, 48 and 71
              (the whole-group kernels: "_group" for bf16 / fp16 q at
              D8-D256, also at groups 9, 10, 16 and 48 at D8, D16, D32 and
              D256 on bf16, fp16, int8 and fp8 caches at its splits' edges,
              at groups 24 and 71 at D8 / D32, at time_decode's d32_mqa
              shape and at RecurrentGemma-2B's D256 layer; "_group_fp32"
              for fp32 q at D64 / D128, which also runs serving-mqa's shape
              and Falcon-40B's layer over fp32, int8 and fp8 caches at its
              splits' edges; each held also against the plain version of
              its plan; "_group_fp32" also at groups above 8 at D8-32 and
              D256, RecurrentGemma-2B's layer at its splits' edges), K5
              permuted with NaN at D16, D128, D256 (also fp32
              q over fp32 / int8 / fp8 pages at D128) and D512; above head
              dim 256 the wide kernels
              ("paged_decode_wide" / "fused_decode_wide", each held also
              against the plain version of its plan), also at group 4 on
              bf16, int8 and fp8 caches, fp32 q over fp8 and fp16 q over
              fp16, int8 and fp8 caches, and at time_decode's d512 / d1024
              shape (8 slots, GQA 8/2, L2048; bf16, int8 and fp32) at the
              timed lengths and at the edges of K5's and K6's splits (0,
              chunk +- 1, cluster x chunk +- 1, capacity - 1), with K5 over
              permuted pages of 16 at 2048 tokens, at least one launch
              each; at head dims 8-32 for groups of up to 8 the narrow
              kernels ("paged_decode_narrow" / "fused_decode_narrow", each
              held also against the plain version of its plan,
              `paged_attention_narrow_ref`) at groups 1, 2, 4 and 8 on
              every payload for fp32, bf16 and fp16 q at the edges of
              their 32-token tiles, chunks and clusters, at time_decode's
              d32 and d32_gqa4 shapes, and K5 over permuted pages of 16
              and 48 with NaN past the lengths, at least one launch each;
              the head dims that run inside a wider instantiation
              (check_decode_padded: 48, 80, 96, 112, 160, 192, 240 in the
              group tiles' and whole-group kernels' D64 / D128 / D256, 320
              and 640 in the wide kernel's D512 / D1024) at every q dtype
              over every payload, groups 1, 4, 8, 16 and 71, at their
              splits' edges, K5 over pages of 128 and of 16 (permuted, NaN
              past the lengths) and K6; D24, D40 and D1040 raise before any
              launch.  Limits
              by q's dtype (DECODE_TOL): bf16 atol
              2e-2 + rtol 1e-2, fp16 2e-3 + 2^-10, and against the
              exact fp32 versions min(2e-3, 2^-10 x a row's largest
              |exact|) + 2^-10, fp32 1e-5; every fp16 case's outputs
              rounded to bf16 must fall outside fp16's exact limit.
7. d256     - head dims 160 and 256 (run at 256: the wgmma K1, K4, K2 and
              K3 for bf16/fp16; for fp32 the 3xTF32 K1 and K4 of
              csrc/flash_fwd_fp32_wide.cuh and K2 and K3 of
              csrc/flash_bwd_fp32_wide.cuh), 288 and 520 (padded to 512 and 1024:
              bf16/fp16 K1 and K4 on the wide wgmma forward of
              csrc/flash_fwd_wide.cuh, K2 and K3 on the wide wgmma
              backward of csrc/flash_bwd_wide.cuh; fp32 as at 256): K1, its
              lse (fp32 against vanilla at 1e-5; the wide kernel's against
              its plain version at 1e-3 and vanilla at 2e-2), the
              pre-pass, K2/K3 and K4 (int8, fp8) against their plain
              versions and fp32 vanilla, with GQA 8/2 at q129 x kv257 and
              window 100, 3 segments, rows that see no key (their output
              and dQ exactly 0), the lse cotangent, non-causal, batch x
              heads past 32767 (b2 h16400 GQA /4 L2; the wide K2/K3 in
              bf16 and fp16 at each of these), and K1 and the grads at the
              d256-path's shape (b4 h3 L1024, causal only, so most tiles
              take the unmasked branch) and at b2 h4 L1024 for D288 /
              D520.  Then the 3xTF32 K1 at D256, D288, D520 and D1024
              through the entry points, output and lse at 1e-5 against
              plain and vanilla (check_k1_fp32: L1024 GQA 8/2, q129 x kv257
              with window 100, GQA and segments, 3 segments at q1014 x
              kv1024, rows that see no key exactly 0 / -inf, non-causal,
              lq < lk), and the 3xTF32 K4 over int8 and fp8 at 5e-5 at
              each padded head dim (GQA L1024, 3 segments at q1014 x
              kv1024), each launching its "_d256_fp32" / "_wide_fp32" key
              once a call; and the 3xTF32 K2 and K3 there, the grads of
              K1 + pre-pass + K2 + K3 through the entry points at 1e-4
              against plain and vanilla (L1024 GQA 8/2, q129 x kv257 with
              window 100, GQA and segments, 3 segments at q1014 x kv1024,
              rows that see no key, non-causal, lq < lk, an lse
              cotangent), each call launching the "_d256_fp32" /
              "_wide_fp32" K2 and K3 once.
8. d256-path - the D256 route through the entry points: a 2-layer GPT at
              GPT-2's width with 3 heads of 256, 6 Trainer steps at b4 x
              T1024 in bf16 (the "_d256" keys, the wgmma K1, K2 and K3 and
              the pre-pass, launched n_layer x steps times each, nothing
              else; the median step ms), then the quant op at D256 over 4
              layers (the wgmma K4 launched 4 times).
   wide-path - head dims above 256 and fp32 at 256 through the entry
              points: forward and backward of flash_attention and K4 (int8)
              at b2 h4 L1024 for D288 and D520 bf16 (the wide wgmma K1, K4,
              K2 and K3) and D256 and D520 fp32 (the 3xTF32 K1, K4, K2 and
              K3); the "_wide", "_wide_fp32" and "_d256_fp32" keys
              launched as WIDE_PATH_LAUNCHES says; every output and grad
              against its plain version and fp32 vanilla.
9. llama    - the slice: Llama-3 8B at full width and depth (32 layers,
              4096 wide, GQA 32/8 D128, vocab 128256), bf16, random weights
              drawn on the card from the seed, behind the engine with
              prefill_fn=llama.prefill / decode_fn=llama.decode_step: the
              serving burst of 16 on bf16 weights and a bf16 cache, then on
              int4 weight-only (quantized in place) and an fp8 cache.
              Budgets exact, ids in range, K1 launched n_layer x prefill
              dispatches (one prompt each) and nothing else; tokens/s and
              TTFT.  The fp8 burst's first greedy tokens each equal to the
              argmax of llama.prefill's logits on the same bucket-padded
              prompt, those logits against a full forward of the same
              weights; then 4 teacher-forced decode steps of one prompt on
              an fp8 and a bf16 cache, against each other and against full
              recompute.  llama-chunked, between the two: the bf16 burst
              with prefill_chunk_fn=llama.prefill_chunk and chunk_prefill
              256 (budgets exact, the chunk count of the prompt lengths, K1
              launched n_layer x whole-prompt dispatches).
10. llama-parity - fp32 Llama-3 8B widths at 2 layers: prefill logits and
              llama.prefill_chunk's (chunks of 128) within 1e-3 of a full
              forward, 6 greedy tokens of cached decode equal to full
              recompute (the 3xTF32 K1 launched 2 layers x 8 forwards and
              the 16-bit one never); int8 / int4 weight-only
              forwards finite, their error against fp32 printed and bounded
              (relative L2 0.1 / 0.8), two broken int4 forwards (nibble
              halves swapped, scales zeroed) outside the int4 bound, and
              the JAX test's bounds (0.05 / 1.0) at its own config,
              TINY_LLAMA.
11. llama-train - Llama-3 8B widths and vocab at 2 layers through the
              Trainer (bf16 compute, fp32 masters), 10 steps at b4 x T1024:
              losses finite, the last 3 more than 0.5 nat below the first;
              K1, the pre-pass, K2 and K3 launched n_layer x steps times.
12. serving - GPT-2 124M (bf16, random weights from --seed) behind the
              continuous-batching engine: 16 requests, every one finishing
              with its exact budget; K1's launch count during the run
              equals n_layer x prefill dispatches.
13. serving-quant - the same burst through an int8-cache engine decoding
              with attn_impl="paged" and an fp8-cache engine with "fused":
              exact budgets; K5 / K6 launched n_layer x decode steps, K1
              n_layer x prefill dispatches; tokens/s and TTFT beside 12's.
    serving-chunked - the burst with chunk_prefill=256: exact budgets, the
              chunk count of the prompt lengths, K1 launched n_layer x
              whole-prompt dispatches (a chunk runs the dense offset
              attention); one chunk's wall ms through the 12 layers and its
              offset attention's ms a layer; then fp32: a 900-token prompt
              in chunks of 256 against prefill (logits, cache rows 1e-3),
              and greedy outputs of 4 prompts with and without chunking
              equal, K1 there the 3xTF32 one only.
    serving-spec - the burst with speculative decoding, spec_k 4, the
              target drafting for itself and a 2-layer draft (its first
              blocks, embeddings and head) with spec_adaptive: exact
              budgets, K1 launched n_layer x target prefill dispatches +
              draft layers x draft dispatches; acceptance, retreat and
              trials; then fp32: verify_step against chained decode_step
              (1e-3), greedy outputs of 4 prompts x 32 tokens with the
              2-layer draft equal the plain engine's and a self-draft
              accepting every proposal.
    serving-pipelined - the burst with pipeline_scans=True, then also with
              scan_tokens_target=64: exact budgets, every scan pipelined;
              tokens/s, TTFT and scans beside 12's.
14. serving-wquant - the same model with int8 weight-only projections
              (quantized in place) on an fp8 cache through K6: one prompt's
              prefill logits within relative L2 0.05 of the bf16 model's,
              then the burst, K6 launched n_layer x decode steps.
    serving-mqa - multi-query serving at SantaCoder's published widths
              (24 layers, 16 q heads on one KV head of 128, width 2048,
              vocab 49280), bf16 weights drawn on the card, 8 slots,
              max_len 2048: the burst through einsum, through K5 on a bf16
              cache and K6 on an int8 cache (exact budgets, K5 / K6
              launched n_layer x decode steps); then fp32 at SantaCoder's
              widths with 2 layers, 8 slots of 2048 with prompts of
              16-2030 tokens: paged and fused logits within 1e-3 of
              einsum's on fp32 and int8 caches, through the 3xTF32
              whole-group kernel ("paged_decode_group_fp32" /
              "fused_decode_group_fp32", each launched).
    serving-phi2 - serving at Phi-2's published widths (32 layers, 32 heads
              of 80, width 2560, vocab 51200), bf16 weights drawn on the
              card, 8 slots, max_len 2048: the burst through einsum on a
              bf16 cache, K5 on an int8 cache and K6 on an fp8 cache (head
              dim 80 in the group tiles' D128; exact budgets, K5 / K6
              launched n_layer x decode steps); then fp32 at Phi-2's widths
              with 2 layers, 8 slots of 2048 with prompts of 16-2030
              tokens: paged and fused logits within 1e-3 of einsum's on
              fp32 and int8 caches.
    serving-fp16 - GPT-2 124M in fp16: the burst through einsum, K5 on an
              fp16 cache and K6 on an fp8 cache (fp16 q); fp16 paged /
              fused logits against einsum's at the 16-bit tier; then fp32
              GPT-2 124M on fp32 and fp8 caches at 1e-3.
15. parity  - GPT-2 124M in fp32: prefill logits and 8 teacher-forced
              decode steps against the model's forward on dense attention;
              the prefill launches the 3xTF32 K1 once a layer.
16. parity-quant - GPT-2 124M in fp32 with an int8 cache, 8 teacher-forced
              decode steps: paged and fused logits against einsum on the
              same cache contents within 1e-3; the quantization error
              against the unquantized forward is printed.
17. training - the port's Trainer on GPT-2 124M (bf16 compute, fp32 master
              weights) for 20 steps at b8 x T1024: losses finite and
              falling by more than 1 nat; K1, the pre-pass, K2 and K3 each
              launched n_layer x steps times; step time, tokens/s, peak
              memory; then a torch.profiler trace of 3 more steps: device
              busy ms a step by kind of kernel, and the idle share.
18. train-parity - GPT-2 124M in fp32, 5 steps at b2 x T512 on flash and on
              dense attention from the same weights and batches: losses
              within 2e-3; the flash run launches the 3xTF32 K1, K2 and K3
              n_layer x steps times each (their kernels line's launches)
              and the 16-bit K1 never.
19. timing  - K1 at the Llama prefill shape (b1, GQA 32/8, L1024, D128) and
              the D256 kernels at b8 h12 L1024, beside their plain
              versions, bounds and torch SDPA forward / backward; then K1,
              and the backward (pre-pass, K2, K3, and the three together)
              at b1 and b8 (D64) and b8 D128, against the plain
              versions and vanilla at GPT-2 shapes, and torch SDPA forward /
              backward as the one library call for the same function; K4 at
              b1/b8 (SDPA forward on bf16 K/V beside it, the same FLOPs but
              not the same function), K5 and K6 at DECODE_SHAPES (8 slots
              with contexts near 512 of 1024 on one layer, L2-hot; GPT-2's
              12 layers, a long context at 32 slots, a Llama-shaped GQA
              layer, SantaCoder's 24 multi-query layers, a Gemma-7B D256
              layer, a Falcon-40B GQA 128/8 layer, GPT-2's 12 layers with
              fp16 q (fp16 and fp8 caches), D32, D512 and D1024 layers,
              Phi-2's, GPT-NeoX-20B's, MPT-30B's and StableLM-2-12B's
              layers and a multi-query D80 layer (head dims inside a wider
              instantiation; the bound counts d columns), L2-cold;
              SantaCoder's layer also with one group tile of 8 q
              heads), int8 and bf16, against their plain versions
              and, on a bf16 cache, SDPA with a length mask over the
              slot-major cache.  Device time: a CUDA graph of 20 calls
              between CUDA events (graph_ms); "a call" adds the host's
              enqueue.  Each kernel beside its bound: the larger of its bytes
              at 3.35 TB/s and its FLOPs at 989 TFLOP/s (fp32: 165, TF32's
              495 over the three passes of 3xTF32).  Last,
              at b8 h12 L1024: fp32 D256 (the 3xTF32 K1, K4, K2 and K3);
              bf16 D512 and D1024 (no plain versions at
              D1024): the wide wgmma K1 and K4 beside the SIMT times they
              replaced and SDPA's forward, the pre-pass and the wide wgmma
              K2/K3 beside their bounds, the SIMT times they replaced and
              SDPA's whole backward (pre-pass + K2 + K3 against it); fp32
              D512 and D1024 (the 3xTF32 K1, K4, K2 and K3); the 3xTF32
              K1 (with and without lse) and K4 (int8, fp8) at D256, D512
              and D1024 beside their bounds, SDPA's fp32 forward and the
              SIMT forward's times they replaced (SIMT_FP32_WIDE_FWD_MS,
              an earlier reading); the pre-pass and the 3xTF32 K2 and K3
              there beside their bounds, SDPA's fp32 whole backward
              (pre-pass + K2 + K3 against it) and the SIMT times they
              replaced (SIMT_FP32_WIDE_BWD_MS, an earlier reading); fp32
              D64 and D128 (the 3xTF32 K1, K4, K2 and K3 and the
              pre-pass, beside the SIMT times they replaced and SDPA
              fp32).
20. measure - utils.measure on K1 at b8 h12 L1024 D64 bf16: chain_timer
              (a chain of 64 calls in a CUDA graph), ab_compare over K1's
              tiles with the recheck's drift band, graph_ms of the same
              call; a reading at or below K1's bound (floor_ms) fails.
21. memory  - utils.profiling.memory_report on the card: dense attention
              against K1 at the reference's OOM shape (b1 h16 L2048 D64
              fp32; dense temps at least the 256 MiB of scores, flash's at
              most a quarter of them), flash from L2048 to L4096 (bf16 h4
              D128) growing less than 3x, the allocator's peak beside each;
              then the reference's own foil: at b1 h16 L65536 D64 bf16 dense
              attention must raise torch.cuda.OutOfMemoryError and K1 must
              run.
22. autotune - kernels.autotune, its cache in this run's temporary
              directory: at GPT-2's prefill buckets (b1 h12 D64, L128-1024),
              Llama-3 8B's prefill (b1 GQA 32/8 L1024 D128) and GPT-2's
              training shape (b8 h12 L1024 D64), every K1 tile (K1_TILES)
              against the plain version at the same tile, its device ms, the
              sweep's winner, and a default flash_attention launching the
              winner's block_q; then the slice's path with the counts at 0:
              InferenceEngine.warmup_autotune on GPT-2 124M (every bucket a
              cache hit) and a 1000-token prompt, and 3 Trainer steps with
              autotune_blocks=True, each K1 launch at the winner's tile;
              torch SDPA's device ms beside each shape's tiles.
23. ring    - ring attention's rank-local step functions for every rank of
              a 4-ring in one process (one card holds one NCCL rank): at
              b1 h2 L1024 D64 bf16, contiguous and zig-zag, every step's
              K1 with lse (non-causal past shards, the causal diagonal, the
              zig-zag diagonal's Lq 256 < Lk 512) and, on the merged o and
              lse, the pre-pass (di 1e-3, qs bit-equal), K2 and K3 against
              their plain versions; then at GPT-2 124M's heads (b8 h12
              L4096 D64, shards of 1024) and Llama-3 8B's (b1 GQA 32/8
              L8192 D128, shards of 2048), contiguous and zig-zag, the
              merged output (1e-2) and q/k/v grads (2e-2 x max |grad|)
              against one K1 and one K2/K3 call on the whole sequence, the
              ring's summed device ms beside the one call's; then the call
              shapes at b8 h12 D64 that the ring and the context-parallel
              Trainer send (K1 with lse non-causal over a 1024 shard,
              causal q512 x kv1024 end-aligned and causal q512 x kv512;
              the pre-pass, K2 and K3 on each with its o/lse), each held
              against its plain version as above, then timed beside its
              plain version, bound and SDPA.
24. parallel - the parallel package's entry points on a real 1-rank NCCL
              group (initialize_multihost, make_mesh): ring attention
              (contiguous, zig-zag) and head-parallel attention with grads
              against one flash_attention call; a context-parallel Trainer
              on GPT-2 124M (full width and depth, b8 x T1024, seq_zigzag,
              seq_batch_sharding), 4 steps, losses within 1e-4 (relative)
              of the unsharded Trainer's and the first step's gradients
              within 1e-2 (relative norm, every parameter), K1, the
              pre-pass, K2 and K3 each
              launched 2 x n_layer x steps times from counts set to 0 (the
              zig-zag diagonal is two calls) and nothing else; a dp x tp
              Trainer with DTensor parameters and fused AdamW held the
              same way against the unsharded one; Llama TP serving at Llama-3 8B's widths with 2
              layers (shard_llama_for_inference, tp_prefill,
              tp_decode_loop): greedy tokens equal to llama.prefill /
              decode_loop's, the cache a DTensor.

The line before the last is a JSON summary of the kernels, the "_fp32",
the D256, the "_d256_fp32", the "_wide" and the "_wide_fp32" ones as rows
of their own (launches on
their path, max error, device ms, plain ms, bound ms and what sets it,
library ms or null; K1's row also carries its launches on the Llama path
and in the chunked, speculative and pipelined GPT-2 bursts and its times
at the Llama prefill shape, the wide rows D1024's times as d1024_* (the
"_d256_fp32" / "_wide_fp32" rows also K1's time with lse and K4's over
fp8); the "_fp32" rows D128's as d128_*, the fp32 K1's also its time
with lse and its launches on the parity and llama-parity paths; the
pre-pass's row its fp32 D64 / D128 rows as fp32_d64 / fp32_d128; K1's
row its tile sweep, {shape: {block_q: device ms}}, as `tiles` with
SDPA's ms as `tiles_library_ms`, its launches on the autotuned engine
and trainer paths, and the measure phase's readings; K1, the pre-pass,
K2 and K3 their ring call shapes as `ring_noncausal_shard` (K1 also
`ring_causal_lq_lt_lk` and `ring_vs_one_call`) and their launches on the
context-parallel run as `parallel_launches`; K5's and K6's rows their
times at each configuration beyond D64 / D128, bf16 q and groups up to
8 that the group tiles run (NEW_DECODE_SHAPES: gemma7b_*, gpt2_12l_*,
d32_*, phi2_*, neox20b_*, mpt30b_*, stablelm2_12b_*; int8 caches
unsuffixed, others suffixed by the store) and their launches in
serving-fp16 and serving-phi2 (serving_phi2_launches in its bursts,
serving_phi2_fp32_launches in its fp32 check); the
whole-group K5's and K6's rows SantaCoder's bf16 layer's times with
SDPA's, the santacoder_*, falcon40b_*, recurrentgemma2b_*, palm8b_*,
d32_mqa_* and mqa_d80_* rows beside them; the fp32 whole-group K5's and
K6's rows SantaCoder's fp32 layer's times with SDPA's fp32 call, the
santacoder_fp32_*, falcon40b_fp32_*, recurrentgemma2b_fp32_*, palm8b_fp32_*
and d32_mqa_fp32_* rows beside them (fp32 and int8 caches), and their
launches in serving-mqa's fp32 check; the wide K5's
and K6's rows the D1024 bf16 layer's times, with d512_* and d1024_*
beside them, and their launches in the decode phase);
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_attention_tpu_torch.data import CharTokenizer, batch_iterator, synthetic_corpus  # noqa: E402
from flash_attention_tpu_torch.inference import InferenceEngine, init_cache, speculative_decode_loop  # noqa: E402
from flash_attention_tpu_torch.inference.model_runner import (  # noqa: E402
    decode_step,
    prefill,
    prefill_chunk,
    verify_step,
)
from flash_attention_tpu_torch.kernels import _build  # noqa: E402
from flash_attention_tpu_torch.kernels.vanilla import vanilla_attention, vanilla_attention_with_lse  # noqa: E402
from flash_attention_tpu_torch.models import llama  # noqa: E402
from flash_attention_tpu_torch.models.gpt import GPT, GPT2_124M, GPTConfig  # noqa: E402
from flash_attention_tpu_torch.quant.weights import (  # noqa: E402
    QuantizedLinear,
    quantize_gpt_params,
    quantize_llama_params,
)
from flash_attention_tpu_torch.training import Trainer, TrainerConfig  # noqa: E402
from flash_attention_tpu_torch.utils.devices import device_info  # noqa: E402
from flash_attention_tpu_torch.utils.measure import (  # noqa: E402
    BF16_FLOPS,
    TF32X3_FLOPS,
    ab_compare,
    chain_timer,
    floor_ms,
    graph_ms,
    time_ms,
)
from flash_attention_tpu_torch.utils.profiling import device_time, memory_report  # noqa: E402

# the modules, not the functions that the packages re-export under their names
FA = importlib.import_module("flash_attention_tpu_torch.kernels.flash_attention")
QK = importlib.import_module("flash_attention_tpu_torch.quant.kv")
KVC = importlib.import_module("flash_attention_tpu_torch.inference.kv_cache")
PA = importlib.import_module("flash_attention_tpu_torch.inference.paged_attention")
DA = importlib.import_module("flash_attention_tpu_torch.inference.decode_attention")
MR = importlib.import_module("flash_attention_tpu_torch.inference.model_runner")
ENG = importlib.import_module("flash_attention_tpu_torch.inference.engine")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "flash_fwd": ("flash_attention_tpu_torch/csrc/flash_fwd.cu", "flash_attention_tpu/kernels/flash_attention.py:269"),
    # no Pallas kernel: the di and qs that JAX computes outside its backward
    # kernels (_flash_bwd_rule :1112, _recompute_p :618)
    "flash_bwd_prep": ("flash_attention_tpu_torch/csrc/flash_bwd.cu", "flash_attention_tpu/kernels/flash_attention.py:1112"),
    "flash_bwd_dkv": ("flash_attention_tpu_torch/csrc/flash_bwd.cu", "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq": ("flash_attention_tpu_torch/csrc/flash_bwd.cu", "flash_attention_tpu/kernels/flash_attention.py:765"),
    # fp32 K2 / K3 at head dims up to 128, padded to 64 or 128: the 3xTF32
    # tensor-core kernels, reached through flash_bwd.cu's entry points
    "flash_bwd_dkv_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32.cuh",
                           "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32.cuh",
                          "flash_attention_tpu/kernels/flash_attention.py:765"),
    # fp32 K1 / K4 at head dims up to 128, padded to 64 or 128: the 3xTF32
    # tensor-core forward, reached through flash_fwd.cu's and
    # flash_fwd_kv_quant.cu's entry points
    "flash_fwd_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32.cu",
                       "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_fwd_kv_quant_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32.cu", "flash_attention_tpu/quant/kv.py:98"),
    "flash_fwd_kv_quant": ("flash_attention_tpu_torch/csrc/flash_fwd_kv_quant.cu", "flash_attention_tpu/quant/kv.py:98"),
    # K5 / K6: one template (decode.cuh), instantiated by csrc/decode_*.cu
    "paged_decode": ("flash_attention_tpu_torch/csrc/decode.cuh",
                     "flash_attention_tpu/inference/paged_attention.py:34"),
    "fused_decode": ("flash_attention_tpu_torch/csrc/decode.cuh",
                     "flash_attention_tpu/inference/decode_attention.py:195"),
    # K5 / K6 over a GQA group above 8 with bf16 / fp16 q at head dims 64 and
    # 128: the whole-group kernel (decode_group.cuh), instantiated by
    # csrc/decode_group_*.cu
    "paged_decode_group": ("flash_attention_tpu_torch/csrc/decode_group.cuh",
                           "flash_attention_tpu/inference/paged_attention.py:34"),
    "fused_decode_group": ("flash_attention_tpu_torch/csrc/decode_group.cuh",
                           "flash_attention_tpu/inference/decode_attention.py:195"),
    # K5 / K6 over a GQA group above 8 with fp32 q at head dims 64 and 128:
    # the whole-group kernel in 3xTF32 (decode_group_fp32.cuh), instantiated
    # by csrc/decode_group_fp32_*.cu
    "paged_decode_group_fp32": ("flash_attention_tpu_torch/csrc/decode_group_fp32.cuh",
                                "flash_attention_tpu/inference/paged_attention.py:34"),
    "fused_decode_group_fp32": ("flash_attention_tpu_torch/csrc/decode_group_fp32.cuh",
                                "flash_attention_tpu/inference/decode_attention.py:195"),
    # K5 / K6 at head dims above 256 (padded 512 / 1024), every q dtype and
    # group: the wide cluster kernel (decode_wide.cuh), instantiated by
    # csrc/decode_wide_*.cu
    "paged_decode_wide": ("flash_attention_tpu_torch/csrc/decode_wide.cuh",
                          "flash_attention_tpu/inference/paged_attention.py:34"),
    "fused_decode_wide": ("flash_attention_tpu_torch/csrc/decode_wide.cuh",
                          "flash_attention_tpu/inference/decode_attention.py:195"),
    # K5 / K6 at head dims 8-32 for GQA groups of up to 8, every q dtype: the
    # narrow cluster kernel (decode_narrow.cuh), instantiated by
    # csrc/decode_narrow_*.cu
    "paged_decode_narrow": ("flash_attention_tpu_torch/csrc/decode_narrow.cuh",
                            "flash_attention_tpu/inference/paged_attention.py:34"),
    "fused_decode_narrow": ("flash_attention_tpu_torch/csrc/decode_narrow.cuh",
                            "flash_attention_tpu/inference/decode_attention.py:195"),
    # head dims 129-256, padded to 256, bf16/fp16: the wgmma K1, K4, K2 and
    # K3 (flash_fwd_d256.cu, flash_bwd_d256.cu) and flash_bwd.cu's pre-pass
    # instantiated at 256
    "flash_fwd_d256": ("flash_attention_tpu_torch/csrc/flash_fwd_d256.cu",
                       "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_bwd_prep_d256": ("flash_attention_tpu_torch/csrc/flash_bwd.cu",
                            "flash_attention_tpu/kernels/flash_attention.py:1112"),
    "flash_bwd_dkv_d256": ("flash_attention_tpu_torch/csrc/flash_bwd_d256.cu",
                           "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq_d256": ("flash_attention_tpu_torch/csrc/flash_bwd_d256.cu",
                          "flash_attention_tpu/kernels/flash_attention.py:765"),
    "flash_fwd_kv_quant_d256": ("flash_attention_tpu_torch/csrc/flash_fwd_d256.cu",
                                "flash_attention_tpu/quant/kv.py:98"),
    # fp32 at 256: K1 and K4 on the 3xTF32 forward of
    # flash_fwd_fp32_wide.cuh (flash_fwd_fp32_wide.cu), K2 and K3 on the
    # 3xTF32 backward of flash_bwd_fp32_wide.cuh (flash_bwd_fp32_wide.cu)
    "flash_fwd_d256_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32_wide.cu",
                            "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_bwd_dkv_d256_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32_wide.cu",
                                "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq_d256_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32_wide.cu",
                               "flash_attention_tpu/kernels/flash_attention.py:765"),
    "flash_fwd_kv_quant_d256_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32_wide.cu",
                                     "flash_attention_tpu/quant/kv.py:98"),
    # head dims 257-1024, padded to 512 or 1024, bf16/fp16: K1 and K4 on the
    # wide wgmma forward (flash_fwd_wide.cuh, D = 1024 in
    # flash_fwd_wide_d1024.cu), the pre-pass, and K2 / K3 on the wide wgmma
    # backward (flash_bwd_wide.cuh, D = 1024 in flash_bwd_wide_d1024.cu)
    "flash_fwd_wide": ("flash_attention_tpu_torch/csrc/flash_fwd_wide.cu",
                       "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_bwd_prep_wide": ("flash_attention_tpu_torch/csrc/flash_bwd.cu",
                            "flash_attention_tpu/kernels/flash_attention.py:1112"),
    "flash_bwd_dkv_wide": ("flash_attention_tpu_torch/csrc/flash_bwd_wide.cu",
                           "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq_wide": ("flash_attention_tpu_torch/csrc/flash_bwd_wide.cu",
                          "flash_attention_tpu/kernels/flash_attention.py:765"),
    "flash_fwd_kv_quant_wide": ("flash_attention_tpu_torch/csrc/flash_fwd_wide.cu",
                                "flash_attention_tpu/quant/kv.py:98"),
    # fp32 at 512 / 1024: K1 and K4 on the 3xTF32 forward
    # (flash_fwd_fp32_wide.cu; D = 1024 in flash_fwd_fp32_wide_d1024.cu), K2
    # and K3 on the 3xTF32 backward (flash_bwd_fp32_wide.cu; D = 1024 in
    # flash_bwd_fp32_wide_d1024.cu)
    "flash_fwd_wide_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32_wide.cu",
                            "flash_attention_tpu/kernels/flash_attention.py:269"),
    "flash_bwd_dkv_wide_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32_wide.cu",
                                "flash_attention_tpu/kernels/flash_attention.py:637"),
    "flash_bwd_dq_wide_fp32": ("flash_attention_tpu_torch/csrc/flash_bwd_fp32_wide.cu",
                               "flash_attention_tpu/kernels/flash_attention.py:765"),
    "flash_fwd_kv_quant_wide_fp32": ("flash_attention_tpu_torch/csrc/flash_fwd_fp32_wide.cu",
                                     "flash_attention_tpu/quant/kv.py:98"),
}
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv", "flash_bwd_dq")
FP32_BWD_KERNELS = ("flash_bwd_dkv_fp32", "flash_bwd_dq_fp32")
FP32_FWD_KERNELS = ("flash_fwd_fp32", "flash_fwd_kv_quant_fp32")
D256_TRAINING_KERNELS = tuple(f"{k}_d256" for k in TRAINING_KERNELS)


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on the card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say(f"[device] {smi}")
    info = device_info()[0]
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {info['kind']}, capability {cap}, "
        f"{info['sms']} SMs, {info['memory_bytes'] / 2**30:.1f} GiB, count {torch.cuda.device_count()}")
    return name, smi


def _demangle(names: list[str]) -> list[str]:
    """C++ names through c++filt where the toolkit's binutils have it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, timeout=60)
    except OSError:
        return names
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def _is_wide(name: str) -> bool:
    """An instantiation of the wide wgmma forward (fa::wide::fwd_kernel),
    demangled or not."""
    return "wide::fwd_kernel" in name or "4wide10fwd_kernel" in name


def _is_wide_bwd(name: str) -> bool:
    """An instantiation of the wide wgmma backward (fa::wide::dkv_kernel,
    fa::wide::dq_kernel), demangled or not."""
    return any(k in name for k in ("wide::dkv_kernel", "wide::dq_kernel", "4wide10dkv_kernel", "4wide9dq_kernel"))


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] {os.path.relpath(_build.build_info['path'])} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_info['seconds']:.1f} s)")
    per = _build.build_info["per_source"]
    if per:
        say("[build] nvcc per source, all started together: " + ", ".join(f"{k} {v:.1f} s" for k, v in per.items()))
    else:
        say("[build] library already built: ptxas's report read from the log beside it, no nvcc seconds")
    if not _build.build_info["ptxas"]:
        raise AssertionError(f"[build] no ptxas report for {_build.build_info['path']}: remove the library to rebuild")
    # ptxas -v: one "Compiling entry function" line per instantiation, then
    # its spills and registers
    entries, kernel, spills = [], "", ""
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            entries.append((kernel, regs, spills))
    decode, decode_spilled, group, group_spilled, wide_dec, wide_dec_spilled = [], [], [], [], [], []
    group32, group_new, narrow = [], [], []
    for name, (_, regs, spill) in zip(_demangle([e[0] for e in entries]), entries):
        spilled = not spill.startswith("0 bytes stack frame, 0 bytes spill stores")
        if "narrow_kernel" in name:
            m = re.search(r"narrow_kernel<(.*)>", name)
            narrow.append((m.group(1) if m else name, regs, spill, spilled))
        elif "decode::wide_kernel" in name or "6decode11wide_kernel" in name:
            wide_dec.append(regs)
            if spilled:
                m = re.search(r"wide_kernel<(.*)>", name)
                stores = re.search(r"(\d+) bytes spill stores", spill)
                wide_dec_spilled.append(f"<{m.group(1) if m else name}> {regs} regs "
                                        f"{stores.group(1) if stores else '?'} B")
        elif "group_fp32_kernel" in name:
            group32.append((name, regs, spill))
        elif "group_kernel" in name:
            group.append(regs)
            m = re.search(r"group_kernel<(.*)>", name)
            if m and re.search(r", (32|256), \d+, (true|false)$", m.group(1)):
                group_new.append(f"<{m.group(1)}> {regs}")
            if spilled:
                stores = re.search(r"(\d+) bytes spill stores", spill)
                group_spilled.append(f"<{m.group(1) if m else name}> {regs} regs {stores.group(1) if stores else '?'} B")
        elif "decode_kernel" in name:
            decode.append(regs)
            if spilled:
                m = re.search(r"decode_kernel<(.*)>", name)
                stores = re.search(r"(\d+) bytes spill stores", spill)
                nbytes = stores.group(1) if stores else "?"
                decode_spilled.append(f"<{m.group(1) if m else name}> {regs} regs {nbytes} B")
        elif not _is_wide(name) and not _is_wide_bwd(name):
            short = name.replace("(anonymous namespace)::", "").replace("(fa::FwdParams)", "").replace("fa::", "")
            say(f"[build] ptxas {short}: {regs} registers; {spill}")
    if decode:
        say(f"[build] ptxas decode_kernel: {len(decode)} instantiations, {len(decode) - len(decode_spilled)} without "
            f"spills, {min(decode)}-{max(decode)} registers; nvcc per decode source: "
            + (", ".join(f"{k} {v:.1f} s" for k, v in per.items()
                         if k.startswith("decode") and "group" not in k and "wide" not in k)
               or "not run (built)"))
        say("[build] decode_kernel spills (T, KV, D, rows, paged; spill stores): "
            + ("; ".join(decode_spilled) or "none"))
    # the whole-group decode kernel (decode_group.cuh): its sources' nvcc
    # seconds, its instantiations' registers and spills
    say(f"[build] ptxas group_kernel (whole-group K5 / K6): {len(group)} instantiations, "
        f"{len(group) - len(group_spilled)} without spills, "
        + (f"{min(group)}-{max(group)} registers" if group else "none found")
        + "; nvcc per source: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if k.startswith("decode_group") and "fp32" not in k)
           or "not run (built)")
        + "; spills (T, KV, D, row-tile groups, paged; spill stores): " + ("; ".join(group_spilled) or "none"))
    # each instantiation at D32 (d 8-32) and D256: payload x row-tile groups
    # (1, 2, 4, 8 at D32; 1, 2 at D256) x K5 / K6 a q dtype; none may spill
    # (at D64 / D128 those of 8 row-tile groups do: 24 of 96)
    say(f"[build] ptxas group_kernel at D32 / D256: {len(group_new)} instantiations (T, KV, D, row-tile groups, "
        "paged; registers): " + "; ".join(group_new))
    if len(group) != 168 or len(group_new) != 72:
        raise AssertionError(f"[build] expected 168 instantiations of the whole-group decode kernel, 72 of them at D32 "
                             f"/ D256; found {len(group)} and {len(group_new)}")
    new_spilled = [x for x in group_spilled if re.search(r", (32|256), \d+, (true|false)>", x)]
    if new_spilled:
        raise AssertionError(f"[build] whole-group decode kernel instantiations at D32 / D256 spill: {new_spilled}")
    # the whole-group kernel for fp32 q (decode_group_fp32.cuh): payload x
    # row tiles (1, 2, 4, 8 at D32 / D64; 1, 2, 4 at D128; 1, 2 at D256) x
    # K5 / K6, each instantiation's registers and spills; none at D32 / D256
    # may spill
    clean = sum(re.search(r"(\d+) bytes spill stores", sp).group(1) == "0" for _, _, sp in group32)
    say(f"[build] ptxas group_fp32_kernel (whole-group K5 / K6, fp32 q): {len(group32)} instantiations, {clean} "
        f"without spills; nvcc per source: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if k.startswith("decode_group_fp32")) or "not run (built)"))
    for n, regs, spill in group32:
        m = re.search(r"group_fp32_kernel<(.*)>", n)
        say(f"[build]   group_fp32_kernel<{m.group(1) if m else n}> (KV, D, row tiles, paged): {regs} registers; "
            f"{spill}")
    new32 = [n for n, _, _ in group32 if re.search(r"group_fp32_kernel<[^,]+, (32|256), \d+, (true|false)>", n)]
    spilled32 = [n for n, _, sp in group32 if n in new32 and re.search(r"(\d+) bytes spill stores", sp).group(1) != "0"]
    if len(group32) != 78 or len(new32) != 36:
        raise AssertionError(f"[build] expected 78 instantiations of the fp32 whole-group decode kernel, 36 of them at "
                             f"D32 / D256; found {len(group32)} and {len(new32)}")
    if spilled32:
        raise AssertionError(f"[build] fp32 whole-group decode kernel instantiations at D32 / D256 spill: {spilled32}")
    # the wide decode kernel (decode_wide.cuh, head dims above 256): q dtype x
    # payload x D512 / D1024 x passes of 1, 4 or 8 rows x K5 / K6; the
    # group-tile kernel (decode.cuh) keeps D64-D256: q dtype x payload x
    # D64 / D128 / D256 x q-row capacities 1, 4, 8 (1, 8 at D256) x K5 / K6,
    # 144 in all; the head dims between its widths run inside them
    say(f"[build] ptxas wide_kernel (wide K5 / K6): {len(wide_dec)} instantiations, "
        f"{len(wide_dec) - len(wide_dec_spilled)} without spills, "
        + (f"{min(wide_dec)}-{max(wide_dec)} registers" if wide_dec else "none found")
        + "; nvcc per source: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if k.startswith("decode_wide")) or "not run (built)")
        + "; spills (T, KV, D, rows, paged; spill stores): " + ("; ".join(wide_dec_spilled) or "none"))
    if len(wide_dec) != 108 or len(decode) != 144:
        raise AssertionError(f"[build] expected 108 instantiations of the wide decode kernel and 144 of the group-tile "
                             f"one, found {len(wide_dec)} and {len(decode)}")
    # the narrow decode kernel (decode_narrow.cuh, head dims 8-32 at groups of
    # up to 8): q dtype x payload x q-row capacity 1, 2, 4, 8 x K5 / K6, each
    # instantiation's registers and spills; none may spill
    say("[build] ptxas narrow_kernel (narrow K5 / K6): " + f"{len(narrow)} instantiations; nvcc per source: "
        + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if k.startswith("decode_narrow")) or "not run (built)"))
    for n, regs, spill, _ in narrow:
        say(f"[build]   narrow_kernel<{n}> (T, KV, rows, paged): {regs} registers; {spill}")
    if len(narrow) != 72 or any(sp for *_, sp in narrow):
        raise AssertionError(f"[build] expected 72 instantiations of the narrow decode kernel, none spilling; found "
                             f"{len(narrow)}, {sum(sp for *_, sp in narrow)} spilling")
    # ptxas reports a kernel whose wgmma it serialises only as an info line
    serial = [line.strip() for line in _build.build_info["ptxas"].splitlines() if "C7518" in line]
    names = _demangle([m.group(1) for line in serial for m in [re.search(r"function '([^']+)'", line)] if m])
    say(f"[build] ptxas C7518 (wgmma serialised): {len(serial)} line(s)"
        + "".join(f"\n[build]   {line}" for line in serial)
        + ("\n[build]   in " + ", ".join(sorted(set(names))) if names else ""))
    # the wide wgmma forward (K1 / K4 at D512 and D1024): its sources' nvcc
    # seconds, and each instantiation's registers, spills and C7518 lines
    wide = [(n, regs, spill) for n, (_, regs, spill) in zip(_demangle([e[0] for e in entries]), entries)
            if _is_wide(n)]
    say("[build] wide forward: nvcc " + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if "fwd_wide" in k)
                                          or "not run (already built)")
        + f"; {len(wide)} instantiations; C7518 in them: {sum(_is_wide(n) for n in names)}")
    for n, regs, spill in wide:
        m = re.search(r"fwd_kernel<(.*)>", n)
        say(f"[build]   wide {m.group(1) if m else n}: {regs} registers; {spill}")
    if len(wide) != 12:
        raise AssertionError(f"[build] expected 12 wide forward instantiations, found {len(wide)}")
    # the wide wgmma backward (K2 / K3 at D512 and D1024, bf16 and fp16): the
    # same report; a serialised wgmma in it fails the build phase
    wide_bwd = [(n, regs, spill) for n, (_, regs, spill) in zip(_demangle([e[0] for e in entries]), entries)
                if _is_wide_bwd(n)]
    serial_bwd = sum(_is_wide_bwd(n) for n in names)
    say("[build] wide backward: nvcc " + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if "bwd_wide" in k)
                                           or "not run (already built)")
        + f"; {len(wide_bwd)} instantiations; C7518 in them: {serial_bwd}")
    for n, regs, spill in wide_bwd:
        m = re.search(r"((?:dkv|dq)_kernel<.*>)", n)
        say(f"[build]   wide {m.group(1) if m else n}: {regs} registers; {spill}")
    if len(wide_bwd) != 8 or serial_bwd:
        raise AssertionError(f"[build] expected 8 wide backward instantiations and no C7518 in them, found "
                             f"{len(wide_bwd)} and {serial_bwd}")
    # the 3xTF32 forward above head dim 128 (fa::wide32::fwd_kernel: fp32,
    # int8 and fp8 K/V at D256, D512 and D1024), printed with the rest above
    fp32_wide = [n for n in _demangle([e[0] for e in entries])
                 if "wide32::fwd_kernel" in n or "6wide3210fwd_kernel" in n]
    say("[build] 3xTF32 forward above 128: nvcc "
        + (", ".join(f"{k} {v:.1f} s" for k, v in per.items() if "fwd_fp32_wide" in k) or "not run (already built)")
        + f"; {len(fp32_wide)} instantiations")
    if len(fp32_wide) != 9:
        raise AssertionError(f"[build] expected 9 instantiations of the 3xTF32 forward above 128, found "
                             f"{len(fp32_wide)}")


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(device="cuda", dtype=dtype)


def _segment_ids(b: int, length: int, n: int = 3) -> torch.Tensor:
    """n segments per row, of unequal lengths, as int32 on the card."""
    cuts = [0, length // 5, length // 2, length]
    ids = torch.zeros(b, length, dtype=torch.int32)
    for i in range(n):
        ids[:, cuts[i]:cuts[i + 1]] = i
    return ids.cuda()


def check_k1(label, gen, b, hq, hkv, lq, lk, d, dtype, causal, atol, window=None, segments=False,
             block_q=None, no_key_rows=0) -> float:
    """Kernel vs plain tile loop vs fp32 vanilla on the same inputs, both at
    the tile height `block_q` (default the kernel's); returns the kernel's
    max error against the plain version.  `no_key_rows`: the first rows see
    no key (causal, lq > lk); their output must be exactly 0, as the plain
    version's, where vanilla spreads them over every key, so vanilla is
    held on the other rows only."""
    q = _rand(gen, (b, hq, lq, d), dtype)
    k = _rand(gen, (b, hkv, lk, d), dtype)
    v = _rand(gen, (b, hkv, lk, d), dtype)
    segs = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    bs = dataclasses.replace(FA.default_blocks(lq, lk, d), block_q=block_q) if block_q else None
    with torch.no_grad():
        out = FA.flash_attention(q, k, v, causal=causal, window=window, segment_ids=segs, block_sizes=bs)
        plain, _ = FA.flash_attention_reference(q, k, v, causal=causal, window=window, segment_ids=segs,
                                                block_sizes=bs)
        g = hq // hkv
        dense, _ = vanilla_attention_with_lse(
            q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1),
            causal=causal, sm_scale=d ** -0.5, window=window, segment_ids=segs,
        )
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"[k1] {label}: bad output {out.shape} {out.dtype}")
    e_plain = (out.float() - plain.float()).abs().max().item()
    e_dense = (out.float() - dense)[:, :, no_key_rows:].abs().max().item()
    ok = e_plain <= atol and e_dense <= atol and not out[:, :, :no_key_rows].any()
    say(f"[k1] {label:<34} vs plain {e_plain:.3e}  vs vanilla {e_dense:.3e}  atol {atol:g}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k1] {label} outside tolerance")
    return e_plain


def check_k1_fp32(label, gen, b, hq, hkv, lq, lk, d, causal=True, window=None, segments=False,
                  no_key_rows=0) -> float:
    """The fp32 K1 (a 3xTF32 kernel at every padded head dim) through the
    public entry points: the output of `flash_attention` (causal, window,
    segment ids as a user passes them) and the lse of
    `flash_attention_with_lse`, or of the wrapper where a window or segment
    ids apply (the lse entry takes neither), against the plain tile loop
    and fp32 vanilla on the same inputs, absolute 1e-5 (the fp32 forward
    tier).  Each of the two calls must launch the fp32 K1 of its head dim
    once ("flash_fwd_fp32", "flash_fwd_d256_fp32" or "flash_fwd_wide_fp32")
    and nothing else.  Rows that see no key (the plain lse -inf: causal with
    lq > lk, or a window whose keys are all of other segments) must give
    exactly 0 and lse -inf, as the plain version does, and vanilla, which
    spreads them over every key, is held on the other rows only;
    `no_key_rows` is how many such rows there must be at least.  Returns
    the worst error against the plain version."""
    f32 = torch.float32
    q = _rand(gen, (b, hq, lq, d), f32)
    k = _rand(gen, (b, hkv, lk, d), f32)
    v = _rand(gen, (b, hkv, lk, d), f32)
    ids = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    segs = FA._segments(ids, b, lq, lk, q.device) if segments else None
    want = _key("flash_fwd", d, f32)

    def one_launch(call):
        before = dict(FA.KERNEL_LAUNCHES)
        result = call()
        torch.cuda.synchronize()
        launched = {key: n - before[key] for key, n in FA.KERNEL_LAUNCHES.items() if n != before[key]}
        if launched != {want: 1}:
            raise AssertionError(f"[k1] {label}: launched {launched}, want {want} once")
        return result

    with torch.no_grad():
        out = one_launch(lambda: FA.flash_attention(q, k, v, causal=causal, window=window, segment_ids=ids))
        if window is None and not segments:
            out_l, lse = one_launch(lambda: FA.flash_attention_with_lse(q, k, v, causal=causal))
        else:
            # the wrapper takes the kernels' head dims: pad as the entry
            # points do, and slice the output back
            dp = FA.padded_head_dim(d)
            spec = FA._Spec(causal=causal, sm_scale=d ** -0.5, window=window,
                            blocks=FA.default_blocks(lq, lk, dp, dtype=f32))
            qp, kp, vp = (FA._pad_head_dim(x, dp) for x in (q, k, v))
            out_l, lse = one_launch(lambda: FA._launch(qp, kp, vp, spec, segs, True))
            out_l = out_l[..., :d]
        p_out, p_lse = FA.flash_attention_reference(q, k, v, causal=causal, window=window, segment_ids=segs)
        g = hq // hkv
        d_out, d_lse = vanilla_attention_with_lse(q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                                                  causal=causal, sm_scale=d ** -0.5, window=window, segment_ids=segs)
    torch.cuda.synchronize()
    if (out.shape != q.shape or out_l.shape != q.shape or lse.shape != q.shape[:3]
            or not torch.isfinite(out).all() or not torch.isfinite(out_l).all()):
        raise AssertionError(f"[k1] {label}: bad output {tuple(out.shape)} / {tuple(out_l.shape)} / lse "
                             f"{tuple(lse.shape)}")
    none = p_lse == -math.inf  # [b, hq, lq]: rows that see no key
    keyed = ~none
    n = int(none[0, 0].sum())
    e_plain = max((out - p_out).abs().max().item(), (out_l - p_out).abs().max().item(),
                  (lse - p_lse)[keyed].abs().max().item())
    e_dense = max((out - d_out)[keyed].abs().max().item(), (out_l - d_out)[keyed].abs().max().item(),
                  (lse - d_lse)[keyed].abs().max().item())
    no_key = (not out[none].any() and not out_l[none].any() and bool((lse[none] == -math.inf).all())
              and n >= no_key_rows)
    ok = e_plain <= 1e-5 and e_dense <= 1e-5 and no_key and bool(torch.isfinite(lse[keyed]).all())
    say(f"[k1] {label:<44} out, lse vs plain {e_plain:.3e}  vs vanilla {e_dense:.3e}  atol 1e-05"
        + (f"; {n} no-key rows a head 0 / -inf" if n else "") + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k1] {label} outside tolerance")
    return e_plain


def phase_k1(seed: int) -> tuple[float, float]:
    """Returns K1's worst error against its plain version: the 16-bit
    cases', and the fp32 cases' (the 3xTF32 kernel, "flash_fwd_fp32")."""
    gen = torch.Generator().manual_seed(seed)
    bf16, worst = torch.bfloat16, 0.0
    _reset_launches()
    # bf16 tier: fp32 vanilla of the same bf16 inputs, atol 2e-2
    for b in (1, 4):
        for L in (40, 128, 200, 1024):
            err = check_k1(f"gpt2 prefill b{b} h12 L{L} D64 bf16", gen, b, 12, 12, L, L, 64, bf16, True, 2e-2)
            worst = max(worst, err)
    check_k1("gqa hq8 hkv2 L384 D128 bf16", gen, 1, 8, 2, 384, 384, 128, bf16, True, 2e-2)
    # the Llama-3 8B prefill's shape: GQA 32/8 at D128, a full bucket and a
    # ragged prompt length
    for L in (1024, 900):
        check_k1(f"llama prefill b1 hq32 hkv8 L{L} D128 bf16", gen, 1, 32, 8, L, L, 128, bf16, True, 2e-2)
    check_k1("lq<lkv q128 kv384 D64 bf16", gen, 2, 12, 12, 128, 384, 64, bf16, True, 2e-2)
    check_k1("non-causal L200 D64 bf16", gen, 2, 12, 12, 200, 200, 64, bf16, False, 2e-2)
    check_k1("fp16 native b2 h12 L200 D64", gen, 2, 12, 12, 200, 200, 64, torch.float16, True, 2e-2)
    check_k1("window 256 b2 h12 L1024 D64 bf16", gen, 2, 12, 12, 1024, 1024, 64, bf16, True, 2e-2, window=256)
    check_k1("3 segments b2 h12 L1024 D64 bf16", gen, 2, 12, 12, 1024, 1024, 64, bf16, True, 2e-2, segments=True)
    # the forward tile's edges: lq 129 (one row past two consumer
    # warpgroups' 64 rows), lk 257 (one row past four 64-row KV tiles), a
    # GQA group of 4 whose q tiles cross the end-aligned diagonal, window 100
    check_k1("edges q129 kv257 gqa 8/2 window 100 bf16", gen, 2, 8, 2, 129, 257, 64, bf16, True, 2e-2, window=100)
    check_k1("edges q129 kv257 gqa 8/2 D128 fp16", gen, 2, 8, 2, 129, 257, 128, torch.float16, True, 2e-2)
    # K1's other tiles (K1_TILES; the autotune phase sweeps them): the
    # tile's edges, a window, segment ids and fp16 at each
    for d in (64, 128):
        for bq in FA.K1_TILES[d][1:]:
            check_k1(f"tile {bq} edges q129 kv257 8/2 w100 D{d}", gen, 2, 8, 2, 129, 257, d, bf16, True, 2e-2,
                     window=100, block_q=bq)
            check_k1(f"tile {bq} 3 segments L1024 D{d} fp16", gen, 2, 4, 4, 1024, 1024, d, torch.float16, True,
                     2e-2, segments=True, block_q=bq)
    # head dims the kernels are not built for: zero-padded to 64 / 128 by
    # the entry point, the output sliced back
    check_k1("padded D32 b2 h12 L300 bf16", gen, 2, 12, 12, 300, 300, 32, bf16, True, 2e-2)
    check_k1("padded D96 gqa 8/2 L384 window 100 bf16", gen, 1, 8, 2, 384, 384, 96, bf16, True, 2e-2, window=100)
    check_k1("padded D32 fp32 b1 h4 L200", gen, 1, 4, 4, 200, 200, 32, torch.float32, True, 1e-5)
    check_k1("padded D96 fp32 b1 h4 L300 3 segments", gen, 1, 4, 4, 300, 300, 96, torch.float32, True, 1e-5,
             segments=True)
    # lse (fp32, natural log) against dense attention's, at D64 and padded
    for d in (64, 96):
        q, k, v = (_rand(gen, (1, 4, 300, d), torch.float32) for _ in range(3))
        with torch.no_grad():
            out, lse = FA.flash_attention_with_lse(q, k, v)
            d_out, d_lse = vanilla_attention_with_lse(q, k, v, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        e_out = (out - d_out).abs().max().item()
        e_lse = (lse - d_lse).abs().max().item()
        label = f"lse fp32 b1 h4 L300 D{d}"
        say(f"[k1] {label:<34} out {e_out:.3e}  lse {e_lse:.3e}  atol 1e-05  "
            f"{'ok' if max(e_out, e_lse) <= 1e-5 and out.shape == q.shape else 'FAIL'}")
        if max(e_out, e_lse) > 1e-5 or out.shape != q.shape:
            raise AssertionError("[k1] lse outside tolerance")
    # fp32: the 3xTF32 K1, output and lse at 1e-5 against plain and vanilla
    fp32 = [
        check_k1_fp32("fp32 b1 h4 L384 D64", gen, 1, 4, 4, 384, 384, 64),
        check_k1_fp32("fp32 window 100 b1 h4 L384 D128", gen, 1, 4, 4, 384, 384, 128, window=100),
        check_k1_fp32("fp32 3 segments b2 h4 L300 D64 gqa 4/2", gen, 2, 4, 2, 300, 300, 64, segments=True),
        # L1024 with a GQA group of 4, at both head dims
        check_k1_fp32("fp32 gqa 8/2 b2 L1024 D64", gen, 2, 8, 2, 1024, 1024, 64),
        check_k1_fp32("fp32 gqa 8/2 b2 L1024 D128", gen, 2, 8, 2, 1024, 1024, 128),
        # the Llama-3 8B prefill's shape, a full bucket and a ragged length
        *(check_k1_fp32(f"fp32 llama prefill b1 hq32 hkv8 L{L} D128", gen, 1, 32, 8, L, L, 128) for L in (1024, 900)),
        # the tile's edges: lq 129 (one row past a block's 128), lk 257 (one
        # row past eight 32-row KV tiles), GQA 8/2 across the diagonal
        check_k1_fp32("fp32 edges q129 kv257 gqa 8/2 w100 D64", gen, 2, 8, 2, 129, 257, 64, window=100),
        check_k1_fp32("fp32 edges q129 kv257 gqa 8/2 D128", gen, 2, 8, 2, 129, 257, 128),
        check_k1_fp32("fp32 edges q129 kv257 3 segments D128", gen, 2, 4, 4, 129, 257, 128, segments=True),
        # a window of 100 over 3 segments: rows 22-24 see only keys of other
        # segments, so they see none
        check_k1_fp32("fp32 edges w100 3 segments gqa 8/2 D64", gen, 2, 8, 2, 129, 257, 64, window=100,
                      segments=True, no_key_rows=3),
        # queries aligned to the end of 200 keys: the first 100 see none
        check_k1_fp32("fp32 no-key rows q300 kv200 D64", gen, 2, 4, 4, 300, 200, 64, no_key_rows=100),
        check_k1_fp32("fp32 no-key rows q300 kv200 gqa 4/2 D128", gen, 1, 4, 2, 300, 200, 128, no_key_rows=100),
        check_k1_fp32("fp32 non-causal q200 kv300 D64", gen, 2, 4, 4, 200, 300, 64, causal=False),
        check_k1_fp32("fp32 non-causal L1024 gqa 8/2 D128", gen, 1, 8, 2, 1024, 1024, 128, causal=False),
        check_k1_fp32("fp32 lq<lk q128 kv384 D128", gen, 2, 4, 4, 128, 384, 128),
        check_k1_fp32("fp32 3 segments q1014 kv1024 D128", gen, 2, 4, 4, 1014, 1024, 128, segments=True),
    ]
    torch.cuda.synchronize()
    # the fp32 cases above (two calls each), the padded and lse checks: 4
    # more, all fp32
    counts = {key: FA.KERNEL_LAUNCHES[key] for key in ("flash_fwd_fp32", "flash_fwd_kv_quant_fp32")}
    want = 2 * len(fp32) + 4
    say(f"[k1] fp32 launches {counts} ({len(fp32)} cases x 2 + 2 padded + 2 lse; no fp32 launch under flash_fwd)")
    if counts != {"flash_fwd_fp32": want, "flash_fwd_kv_quant_fp32": 0}:
        raise AssertionError(f"[k1] the fp32 cases launched {counts}, want flash_fwd_fp32 {want} times")
    return worst, max(fp32)


def check_prep(label, gen, b, hq, lq, d, dtype, with_lse=False) -> float:
    """The backward's pre-pass against its plain expression on the same
    inputs (o from the forward, read through its [B, L, H, D] strides): di
    against (o.float() * do.float()).sum(-1) - dlse, fp32, absolute 1e-5
    (D products summed in another order); qs against (q.float() * sm_scale
    * log2 e).to(dtype), bit for bit (fp32 and head dims above 256, whose
    kernels do not read it, write no qs).  Returns di's error."""
    q, k, v, do = (_rand(gen, (b, hq, lq, d), dtype) for _ in range(4))
    dlse = _rand(gen, (b, hq, lq), torch.float32) if with_lse else None
    with torch.no_grad():
        o, lse = FA.flash_attention_with_lse(q, k, v)
    spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None, blocks=FA.default_blocks(lq, lq, d))
    args = FA._bwd_args(q, k, v, o, lse, do, dlse, spec, None)
    FA._launch_bwd_prep(args)
    di_ref, qs_ref = FA.flash_attention_bwd_prep_reference(q, o, do, dlse=dlse, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    di, qs = args["tensors"][5], args["qs"]
    err = (di - di_ref).abs().max().item()
    same = qs is None or torch.equal(qs.view(torch.int16), qs_ref.contiguous().view(torch.int16))
    ok = err <= 1e-5 and same and bool(torch.isfinite(di).all())
    say(f"[k2k3] pre-pass {label:<34} di vs plain {err:.2e} (atol 1e-5), qs "
        f"{'bit-equal' if qs is not None and same else 'not written (fp32, D > 256)' if qs is None else 'DIFFERS'}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k2k3] pre-pass {label} disagrees with its plain expression")
    return err


def check_grads(label, gen, b, hq, hkv, lq, lk, d, dtype, causal=True, window=None, segments=False,
                with_lse=False, no_key_rows=0) -> dict:
    """Gradients of K1 + pre-pass + K2 + K3 through the autograd Function
    against the plain backward (on the plain forward's o and lse) and
    against autograd of fp32 vanilla attention, on the same inputs and one
    random dO (and dlse).  fp32: absolute 1e-4, the source repo's backward
    tier.  bf16/fp16: max error <= 2e-2 x max |grad| of the fp32 reference,
    since P and dS are rounded to the 16-bit type before their products.
    Rows that see no key (the plain forward's lse is -inf: the first
    `no_key_rows`, which must be among them, and rows that a window over
    segment ids leaves without a key): their dO (and dlse) is 0, since
    vanilla spreads such a row over every key where the kernels give it P =
    0; a P of inf there would turn 0 into NaN; their dQ must be exactly 0.
    Returns the worst error of each grad against the plain backward."""
    q = _rand(gen, (b, hq, lq, d), dtype).requires_grad_()
    k = _rand(gen, (b, hkv, lk, d), dtype).requires_grad_()
    v = _rand(gen, (b, hkv, lk, d), dtype).requires_grad_()
    do = _rand(gen, (b, hq, lq, d), dtype)
    dlse = _rand(gen, (b, hq, lq), torch.float32) if with_lse else None
    segs = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    kw = dict(causal=causal, window=window, segment_ids=segs)
    with torch.no_grad():
        o_p, lse_p = FA.flash_attention_reference(q, k, v, **kw)
    no_key = lse_p == -math.inf
    if not bool(no_key[:, :, :no_key_rows].all()):
        raise AssertionError(f"[k2k3] {label}: the first {no_key_rows} rows see a key")
    do[no_key] = 0
    if with_lse:
        dlse[no_key] = 0
    if with_lse:
        out, lse = FA.flash_attention_with_lse(q, k, v, causal=causal)
        torch.autograd.backward((out, lse), (do, dlse))
    else:
        FA.flash_attention(q, k, v, **kw).backward(do)
    got = (q.grad, k.grad, v.grad)
    with torch.no_grad():
        plain = FA.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do, dlse=dlse, **kw)
    g = hq // hkv
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o_v, lse_v = vanilla_attention_with_lse(
        qf, kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1), sm_scale=d ** -0.5, **kw
    )
    loss = (o_v * do.float()).sum() + ((lse_v * dlse).sum() if with_lse else 0.0)
    dense = torch.autograd.grad(loss, (qf, kf, vf))
    torch.cuda.synchronize()
    worst, ok = {}, True
    parts = []
    for name, a, p_, r in zip(("dq", "dk", "dv"), got, plain, dense):
        if a.shape != r.shape or a.dtype != dtype or not torch.isfinite(a).all():
            raise AssertionError(f"[k2k3] {label}: bad {name} {tuple(a.shape)} {a.dtype}")
        e_p = (a.float() - p_.float()).abs().max().item()
        e_d = (a.float() - r).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2 * r.abs().max().item()
        ok = ok and e_p <= tol and e_d <= tol
        worst[name] = e_p
        parts.append(f"{name} {e_p:.2e}/{e_d:.2e} tol {tol:.2e}")
    if bool(got[0][no_key].any()):
        raise AssertionError(f"[k2k3] {label}: dq of the rows that see no key is not 0")
    say(f"[k2k3] {label:<34} vs plain/vanilla: {'  '.join(parts)}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k2k3] {label} outside tolerance")
    return worst


def phase_k2k3(seed: int) -> dict:
    """Returns the pre-pass's, K2's and K3's worst errors against their plain
    versions: the 16-bit cases under the plain keys, the fp32 ones (the
    3xTF32 kernels up to head dim 128) under "_fp32"."""
    gen = torch.Generator().manual_seed(seed + 3)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    _reset_launches()
    prep = [
        check_prep("gpt2 b4 h12 L1024 D64 bf16", gen, 4, 12, 1024, 64, bf16),
        check_prep("lse cotangent b2 h12 L256 D64 bf16", gen, 2, 12, 256, 64, bf16, with_lse=True),
        check_prep("lq1023 b1 h8 D128 fp16", gen, 1, 8, 1023, 128, f16, with_lse=True),
        check_prep("fp32 b1 h4 L300 D64", gen, 1, 4, 300, 64, f32),
    ]
    say("[k2k3] tolerance: fp32 absolute 1e-4 (the source repo's backward tier); bf16/fp16 2e-2 x max |grad| of "
        "the fp32 reference, since P and dS are rounded to the 16-bit type before their products")
    runs = [
        # the tiles' edges: q129 (one row past two 64-row warpgroups), kv257
        # (one row past two 128-row KV blocks), a GQA group of 4 whose q
        # tiles cross the end-aligned diagonal, window 100
        check_grads("edges q129 kv257 gqa 8/2 window 100 bf16", gen, 2, 8, 2, 129, 257, 64, bf16, window=100),
        check_grads("edges q129 kv257 gqa 8/2 w100 D128 fp16", gen, 2, 8, 2, 129, 257, 128, f16, window=100),
        # lse and di rows of 1023 floats: not 16-byte aligned
        check_grads("lq1023 gqa 8/2 D128 bf16", gen, 1, 8, 2, 1023, 1023, 128, bf16),
        # queries aligned to the end of 200 keys: the first 100 see none
        check_grads("no-key rows q300 kv200 D64 bf16", gen, 2, 12, 12, 300, 200, 64, bf16, no_key_rows=100),
        check_grads("gpt2 train b4 h12 L1024 D64 bf16", gen, 4, 12, 12, 1024, 1024, 64, bf16),
        *(check_grads(f"b2 h12 L{L} D64 bf16", gen, 2, 12, 12, L, L, 64, bf16) for L in (40, 200)),
        check_grads("gqa hq8 hkv2 L384 D128 bf16", gen, 1, 8, 2, 384, 384, 128, bf16),
        # the llama-train shape
        check_grads("llama train b4 hq32 hkv8 L1024 D128 bf16", gen, 4, 32, 8, 1024, 1024, 128, bf16),
        check_grads("lq<lkv q128 kv384 D64 bf16", gen, 2, 12, 12, 128, 384, 64, bf16),
        check_grads("non-causal L200 D64 bf16", gen, 2, 12, 12, 200, 200, 64, bf16, causal=False),
        check_grads("window 128 L512 D64 bf16", gen, 2, 12, 12, 512, 512, 64, bf16, window=128),
        check_grads("3 segments L512 D64 bf16", gen, 2, 12, 12, 512, 512, 64, bf16, segments=True),
        check_grads("lse cotangent b2 h12 L256 D64 bf16", gen, 2, 12, 12, 256, 256, 64, bf16, with_lse=True),
        check_grads("fp16 b2 h12 L300 D64", gen, 2, 12, 12, 300, 300, 64, torch.float16),
        # head dims padded to 64 / 128 by the entry points; autograd slices
        # the grads back
        check_grads("padded D32 b2 h12 L300 bf16", gen, 2, 12, 12, 300, 300, 32, bf16),
        check_grads("padded D96 gqa 8/2 L257 window 100 bf16", gen, 1, 8, 2, 257, 257, 96, bf16, window=100),
    ]
    # fp32: the 3xTF32 K2 / K3, held at 1e-4 like every fp32 case
    fp32 = [
        check_grads("no-key rows fp32 q300 kv200 D64", gen, 1, 4, 4, 300, 200, 64, f32, no_key_rows=100),
        check_grads("fp32 b1 h4 L384 D64", gen, 1, 4, 4, 384, 384, 64, f32),
        check_grads("lse cotangent fp32 b1 h4 L300 D64", gen, 1, 4, 4, 300, 300, 64, f32, with_lse=True),
        check_grads("fp32 gqa hq4 hkv2 L200 D128 window 64", gen, 1, 4, 2, 200, 200, 128, f32, window=64),
        check_grads("padded D32 fp32 b1 h4 L200 3 segments", gen, 1, 4, 4, 200, 200, 32, f32, segments=True),
        check_grads("padded D96 lse cotangent fp32 b1 h4 L300", gen, 1, 4, 2, 300, 300, 96, f32, with_lse=True),
        # the new kernels' edges: q129 (one row past 128 pinned q rows),
        # kv257 (one row past two 128-row KV blocks), GQA 8/2, window 100
        check_grads("edges q129 kv257 gqa 8/2 w100 D64 fp32", gen, 2, 8, 2, 129, 257, 64, f32, window=100),
        check_grads("edges q129 kv257 gqa 8/2 w100 D128 fp32", gen, 2, 8, 2, 129, 257, 128, f32, window=100),
        # lse and di rows of 1023 floats: not 16-byte aligned
        check_grads("lq1023 gqa 8/2 D128 fp32", gen, 1, 8, 2, 1023, 1023, 128, f32),
        # the training shapes: GPT-2 (fp32 train-parity's head dim) and Llama
        check_grads("gpt2 train b4 h12 L1024 D64 fp32", gen, 4, 12, 12, 1024, 1024, 64, f32),
        check_grads("llama train b1 hq32 hkv8 L1024 D128 fp32", gen, 1, 32, 8, 1024, 1024, 128, f32),
        check_grads("3 segments L512 D128 fp32", gen, 2, 4, 4, 512, 512, 128, f32, segments=True),
    ]
    torch.cuda.synchronize()
    counts = {key: FA.KERNEL_LAUNCHES[key] for key in FP32_BWD_KERNELS}
    say(f"[k2k3] fp32 cases launched {counts} (the 3xTF32 K2 / K3, one launch each a case)")
    if any(counts[key] != len(fp32) for key in FP32_BWD_KERNELS):
        raise AssertionError(f"[k2k3] the fp32 cases launched {counts}, want {len(fp32)} each")
    return {
        "flash_bwd_prep": max(prep),
        "flash_bwd_dkv": max(max(r["dk"], r["dv"]) for r in runs),
        "flash_bwd_dq": max(r["dq"] for r in runs),
        "flash_bwd_dkv_fp32": max(max(r["dk"], r["dv"]) for r in fp32),
        "flash_bwd_dq_fp32": max(r["dq"] for r in fp32),
    }


def _dense_on(q, k, v, **kw) -> torch.Tensor:
    """fp32 vanilla attention of q over k/v (GQA expanded)."""
    g = q.shape[1] // k.shape[1]
    return vanilla_attention_with_lse(q.float(), k.float().repeat_interleave(g, 1), v.float().repeat_interleave(g, 1),
                                      sm_scale=q.shape[-1] ** -0.5, **kw)[0]


def check_k4(label, gen, b, hq, hkv, lq, lk, d, dtype, qdt, atol, window=None, segments=False) -> float:
    """K4 vs its plain version (K1's tile loop on K/V dequantized the
    kernel's way, payload.to(T) * scale.to(T)) vs fp32 vanilla on the same
    dequantized K/V; returns the kernel's max error against the plain
    version."""
    q = _rand(gen, (b, hq, lq, d), dtype)
    kv = QK.quantize_kv(_rand(gen, (b, hkv, lk, d), torch.float32), _rand(gen, (b, hkv, lk, d), torch.float32),
                        dtype=qdt)
    segs = (_segment_ids(b, lq), _segment_ids(b, lk)) if segments else None
    with torch.no_grad():
        out = QK.flash_attention_kv_quant(q, kv, window=window, segment_ids=segs)
        plain = QK.flash_attention_kv_quant_reference(q, kv, window=window, segment_ids=segs)
        k_t, v_t = (QK._dequantize_like_kernel(x, sc, dtype) for x, sc in ((kv.k, kv.k_scale), (kv.v, kv.v_scale)))
        dense = _dense_on(q, k_t, v_t, window=window, segment_ids=segs)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"[k4] {label}: bad output {out.shape} {out.dtype}")
    e_plain = (out.float() - plain.float()).abs().max().item()
    e_dense = (out.float() - dense).abs().max().item()
    ok = e_plain <= atol and e_dense <= atol
    say(f"[k4] {label:<38} vs plain {e_plain:.3e}  vs vanilla {e_dense:.3e}  atol {atol:g}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[k4] {label} outside tolerance")
    return e_plain


def phase_k4(seed: int) -> dict:
    """Returns K4's worst error against its plain version and its launches
    on the quant op's path, for bf16 / fp16 q under "flash_fwd_kv_quant"
    and for fp32 q (the 3xTF32 kernel) under "flash_fwd_kv_quant_fp32":
    {key: (error, launches)}."""
    gen = torch.Generator().manual_seed(seed + 5)
    bf16, f32, i8, f8 = torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn
    say("[k4] tolerance: bf16/fp16 2e-2 (K1's tier); fp32 5e-5, the JAX package's quantized-KV tier.  The vanilla "
        "reference reads K/V dequantized as the kernel does it, in q's dtype")
    worst = 0.0
    for b in (1, 8):
        for name, qdt in (("int8", i8), ("fp8", f8)):
            err = check_k4(f"gpt2 b{b} h12 L1024 D64 bf16 {name}", gen, b, 12, 12, 1024, 1024, 64, bf16, qdt, 2e-2)
            worst = max(worst, err)
    runs = [
        check_k4("q128 vs kv1024 b2 h12 D64 bf16 int8", gen, 2, 12, 12, 128, 1024, 64, bf16, i8, 2e-2),
        check_k4("gqa hq32 hkv8 L1024 D128 bf16 int8", gen, 1, 32, 8, 1024, 1024, 128, bf16, i8, 2e-2),
        check_k4("window 256 b2 h12 L1024 D64 bf16 int8", gen, 2, 12, 12, 1024, 1024, 64, bf16, i8, 2e-2, window=256),
        check_k4("3 segments b2 h12 L1024 D64 bf16 fp8", gen, 2, 12, 12, 1024, 1024, 64, bf16, f8, 2e-2, segments=True),
        check_k4("fp16 b2 h12 L300 D64 int8", gen, 2, 12, 12, 300, 300, 64, torch.float16, i8, 2e-2),
        # Lk % 4 != 0: the scales' rows are not 16-byte aligned, so they are
        # loaded without TMA
        check_k4("lk%4=3 q1023 kv1023 gqa 8/2 D128 bf16 fp8", gen, 1, 8, 2, 1023, 1023, 128, bf16, f8, 2e-2),
        # head dims padded to 64 / 128 (payloads with zero bytes)
        check_k4("padded D32 b2 h12 L1024 bf16 int8", gen, 2, 12, 12, 1024, 1024, 32, bf16, i8, 2e-2),
        check_k4("padded D96 gqa 8/2 L384 bf16 fp8 window 100", gen, 1, 8, 2, 384, 384, 96, bf16, f8, 2e-2,
                 window=100),
    ]
    worst = max(worst, *runs)
    # fp32 q: the 3xTF32 K4, at L1024 and at its tile's edges (q129: one row
    # past a block's 128; kv257: one past eight 32-row KV tiles)
    _reset_launches()
    fp32 = [
        check_k4("fp32 b1 h4 L384 D64 int8", gen, 1, 4, 4, 384, 384, 64, f32, i8, 5e-5),
        check_k4("fp32 gqa hq4 hkv2 L384 D128 fp8 window 100", gen, 1, 4, 2, 384, 384, 128, f32, f8, 5e-5,
                 window=100),
        check_k4("fp32 b2 h4 L300 D64 int8 3 segments", gen, 2, 4, 4, 300, 300, 64, f32, i8, 5e-5, segments=True),
        check_k4("padded D96 fp32 b1 h4 L300 int8", gen, 1, 4, 4, 300, 300, 96, f32, i8, 5e-5),
        check_k4("fp32 gqa 8/2 b2 L1024 D64 int8", gen, 2, 8, 2, 1024, 1024, 64, f32, i8, 5e-5),
        check_k4("fp32 gqa 8/2 b2 L1024 D64 fp8", gen, 2, 8, 2, 1024, 1024, 64, f32, f8, 5e-5),
        check_k4("fp32 llama b1 hq32 hkv8 L1024 D128 int8", gen, 1, 32, 8, 1024, 1024, 128, f32, i8, 5e-5),
        check_k4("fp32 llama b1 hq32 hkv8 L1024 D128 fp8", gen, 1, 32, 8, 1024, 1024, 128, f32, f8, 5e-5),
        check_k4("fp32 edges q129 kv257 8/2 w100 D64 fp8", gen, 2, 8, 2, 129, 257, 64, f32, f8, 5e-5, window=100),
        check_k4("fp32 edges q129 kv257 8/2 D128 int8", gen, 2, 8, 2, 129, 257, 128, f32, i8, 5e-5),
        check_k4("fp32 lk%4=3 q1023 kv1023 8/2 D128 fp8", gen, 1, 8, 2, 1023, 1023, 128, f32, f8, 5e-5),
        # segment ids with the diagonal 10 keys into a 32-row KV tile, so
        # that a block's warps end their walks on different tiles while the
        # producer refills the ring
        check_k4("fp32 3 segments q1014 kv1024 D128 fp8", gen, 2, 4, 4, 1014, 1024, 128, f32, f8, 5e-5,
                 segments=True),
        check_k4("fp32 3 segments q1014 kv1024 D64 int8", gen, 2, 4, 4, 1014, 1024, 64, f32, i8, 5e-5,
                 segments=True),
    ]
    torch.cuda.synchronize()
    n32 = FA.KERNEL_LAUNCHES["flash_fwd_kv_quant_fp32"]
    others = {k: n for k, n in FA.KERNEL_LAUNCHES.items() if k != "flash_fwd_kv_quant_fp32" and n}
    say(f"[k4] fp32 cases launched flash_fwd_kv_quant_fp32 {n32} times (one a case), others {others}")
    if n32 != len(fp32) or others:
        raise AssertionError(f"[k4] the fp32 cases launched {n32} of {len(fp32)} (others {others})")
    # The quant op's path: each of GPT-2's 12 layers quantizes its K/V and
    # attends over them, at b8 x T1024.
    layers = [tuple(_rand(gen, (8, 12, 1024, 64), bf16) for _ in range(3)) for _ in range(12)]
    torch.cuda.synchronize()
    _reset_launches()
    with torch.no_grad():
        outs = [QK.flash_attention_kv_quant(q, QK.quantize_kv(k, v, dtype=i8)) for q, k, v in layers]
    torch.cuda.synchronize()
    launches = FA.KERNEL_LAUNCHES["flash_fwd_kv_quant"]
    others = {k: n for k, n in FA.KERNEL_LAUNCHES.items() if k != "flash_fwd_kv_quant" and n}
    if launches != 12 or others or not all(o.shape == (8, 12, 1024, 64) and torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"[k4] quant op path: {launches} launches of 12 (others {others}), or bad outputs")
    say(f"[k4] quant op path, 12 layers at b8 h12 T1024 D64 bf16 int8: flash_fwd_kv_quant launches {launches}, "
        f"outputs finite")
    # the same path with fp32 q: the 3xTF32 K4
    del layers, outs
    layers = [tuple(_rand(gen, (8, 12, 1024, 64), f32) for _ in range(3)) for _ in range(12)]
    torch.cuda.synchronize()
    _reset_launches()
    with torch.no_grad():
        outs = [QK.flash_attention_kv_quant(q, QK.quantize_kv(k, v, dtype=i8)) for q, k, v in layers]
    torch.cuda.synchronize()
    launches32 = FA.KERNEL_LAUNCHES["flash_fwd_kv_quant_fp32"]
    others = {k: n for k, n in FA.KERNEL_LAUNCHES.items() if k != "flash_fwd_kv_quant_fp32" and n}
    if launches32 != 12 or others or not all(o.shape == (8, 12, 1024, 64) and torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"[k4] fp32 quant op path: {launches32} launches of 12 (others {others}), or bad outputs")
    say(f"[k4] quant op path, 12 layers at b8 h12 T1024 D64 fp32 int8: flash_fwd_kv_quant_fp32 launches "
        f"{launches32}, outputs finite")
    return {"flash_fwd_kv_quant": (worst, launches), "flash_fwd_kv_quant_fp32": (max(fp32), launches32)}


def _error(out: torch.Tensor, ref: torch.Tensor, atol, rtol: float) -> tuple[float, bool]:
    """(max |out - ref|, whether |out - ref| <= atol + rtol |ref| everywhere;
    `atol` a float or a tensor that broadcasts against `ref`)."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * ref.float().abs()).all())


# Decode tolerances by q's dtype, (atol, rtol).  bf16: P * v_scale and the
# output are rounded to bf16 (2^-8 relative each) where the plain versions
# round P elsewhere or not at all.  fp16: the output rounded to fp16 on both
# sides (2^-11 relative each, so rtol 2^-10) and P * v_scale rounded to fp16
# (2^-11 relative) against |v| up to about 4 (atol 2e-3).  fp32: sums in
# another order.
DECODE_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float16: (2e-3, 2 ** -10), torch.float32: (1e-5, 0.0)}
# fp16 q's outputs are also held against the exact versions (`_exact_refs`:
# fp32 throughout, P never rounded) at atol FP16_ROW_ATOL times each row's
# (q head's) largest |exact|, at most 2e-3, and rtol 2^-10: a kernel's
# roundings of P * v_scale fall at random over the tokens, so their sum
# stays near 2^-11 of the row's own size, where 2e-3 alone would pass an
# output rounded to bf16 at every context of more than a few tokens.  An
# output rounded to bf16 in place of fp16 (up to 2^-8 relative) falls
# outside this limit at short and long contexts alike, which the phase's
# control shows.
FP16_ROW_ATOL = 2 ** -10


def _fp16_error(out: torch.Tensor, exact: torch.Tensor) -> tuple[float, bool]:
    """`_error` at fp16 q's limit against an exact version [..., d]; the
    error as the largest share of that limit."""
    atol, rtol = DECODE_TOL[torch.float16]
    limit = (exact.float().abs().amax(dim=-1, keepdim=True) * FP16_ROW_ATOL).clamp(max=atol)
    limit = limit + rtol * exact.float().abs()
    share = ((out.float() - exact.float()).abs() / limit.clamp(min=1e-30)).max().item()
    return share, share <= 1.0


def _filled_cache(gen, slots, hkv, max_len, d, store, q_dtype, lengths, layers=1) -> "KVC.KVCache":
    """A cache of `layers` layers on the card with random contents drawn from
    `gen` on its own device (quantized when `store` is int8/fp8) and the
    given lengths (current token excluded)."""
    quant = store in QK.QUANT_DTYPES
    cache = KVC.init_cache(layers, slots, hkv, max_len, d, dtype=q_dtype if quant else store,
                           quant_dtype=store if quant else None, device="cuda")
    for layer in range(layers):
        for dst, scale in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
            x = torch.randn(dst.shape[1:], generator=gen, device=gen.device).to("cuda")
            if quant:
                payload, sc = QK.quantize_tokens(x, store)
                dst[layer].copy_(payload)
                scale[layer].copy_(sc)
            else:
                dst[layer].copy_(x)
    cache.lengths.copy_(torch.as_tensor(lengths, dtype=torch.int32))
    return cache


def _k6_exact(q: torch.Tensor, cache: "KVC.KVCache", slots: int, max_len: int) -> torch.Tensor:
    """K6's exact version (fp16 q): `paged_attention_ref`, fp32 throughout
    with P never rounded, over the slot-major cache's view, with q *
    sm_scale rounded to q's dtype first, as K6 scores.  K5's exact version
    is its plain one."""
    kp, vp, ks, vs = KVC.page_view(cache, 0, max_len)
    pi = KVC.identity_page_indices(slots, max_len, max_len, device="cuda")
    q6 = (q.float() * float(q.shape[-1]) ** -0.5).to(q.dtype)
    return PA.paged_attention_ref(q6, kp, vp, cache.lengths + 1, pi, k_scales=ks, v_scales=vs, sm_scale=1.0)


def _fp16_control(label: str, outs, exacts) -> bool:
    """The control of fp16 q's limit: the kernels' own outputs rounded
    through bf16 (what a kernel rounding its output to bf16 in place of
    fp16 would give) held against the exact versions at fp16's limit
    (FP16_ROW_ATOL); prints its share of the limit and returns whether the
    limit rejects it."""
    errs = [_fp16_error(o.to(torch.bfloat16), r) for o, r in zip(outs, exacts)]
    rejected = not any(ok for _, ok in errs)
    say(f"[decode] {label:<42} control, output rounded to bf16: share of the limit "
        + " / ".join(f"{e:.2f}" for e, _ in errs) + f"  {'rejected' if rejected else 'NOT rejected'}")
    return rejected


def _decode_keys(q_dtype, d: int, group: int) -> tuple[str, str]:
    """The launch keys of K5 and K6 for a configuration: the wide kernel's
    above head dim 256, the whole-group kernel's for a group above 8 at
    D8-D256 (with fp32 q its keys of its own), the narrow kernel's at D8-32
    for groups of up to 8."""
    if PA.uses_wide_kernel(q_dtype, d, group):
        return "paged_decode_wide", "fused_decode_wide"
    if PA.uses_narrow_kernel(q_dtype, d, group):
        return "paged_decode_narrow", "fused_decode_narrow"
    if PA.uses_group_kernel(q_dtype, d, group):
        if q_dtype == torch.float32:
            return "paged_decode_group_fp32", "fused_decode_group_fp32"
        return "paged_decode_group", "fused_decode_group"
    return "paged_decode", "fused_decode"


def _cluster_split(q_dtype, payload, group: int, d: int, capacity: int, unit: int, pairs: int,
                   paged: bool) -> tuple[int, int, int]:
    """The cluster kernel's (cluster, chunk, walks) for a configuration
    (`payload`: the cache's dtype; `pairs`: sequences x KV heads), as its
    launcher chooses them on this card (`paged_attention.cluster_plan`)."""
    plan = PA.cluster_plan(q_dtype, payload, d, group, capacity, unit, pairs, paged, torch.cuda.current_device())
    return plan[3:]


def check_decode(label, gen, slots, hq, hkv, d, max_len, store, q_dtype, lengths,
                 controls=None) -> dict:
    """K5 (through decode_attention_paged) and K6 vs their plain versions on
    one cache at DECODE_TOL; returns {launch key: max error}.  Each must
    launch its kernel once: the narrow kernel at D8-32 for a group of up to
    8, the whole-group kernel for a group above 8 at D8-D256, the wide
    kernel above D256 and the group tiles otherwise, each also held against
    the plain version of its own plan (`paged_attention_narrow_ref`,
    `paged_attention_group_ref`: its chunks, its cluster, the merge's
    order; `paged_attention_split_ref` at the group tiles' chunks).  For
    fp16 q both are also held against their exact versions at fp16's limit
    (FP16_ROW_ATOL), and whether that limit rejects the bf16-rounded control
    goes into `controls`."""
    cache = _filled_cache(gen, slots, hkv, max_len, d, store, q_dtype, lengths)
    q = _rand(gen, (slots, hq, d), q_dtype)
    key5, key6 = _decode_keys(q_dtype, d, hq // hkv)
    before = dict(FA.KERNEL_LAUNCHES)
    with torch.no_grad():
        out5 = DA.decode_attention_paged(q, cache, 0, page_size=128)
        kp, vp, ks, vs = KVC.page_view(cache, 0, 128)
        pi = KVC.identity_page_indices(slots, max_len, 128, device="cuda")
        plain5 = PA.paged_attention_ref(q, kp, vp, cache.lengths + 1, pi, k_scales=ks, v_scales=vs)
        out6 = DA.decode_attention_fused(q, cache, 0)
        plain6 = DA.decode_attention(q, cache, 0)
    launched = {k: n - before[k] for k, n in FA.KERNEL_LAUNCHES.items() if n != before[k]}
    if launched != {key5: 1, key6: 1}:
        raise AssertionError(f"[decode] {label}: launched {launched}, want {key5} and {key6} once each")
    torch.cuda.synchronize()
    for o in (out5, out6):
        if o.shape != q.shape or o.dtype != q_dtype or not torch.isfinite(o).all():
            raise AssertionError(f"[decode] {label}: bad output {o.shape} {o.dtype}")
    atol, rtol = DECODE_TOL[q_dtype]
    e5, ok5 = _error(out5, plain5, atol, rtol)
    e6, ok6 = _error(out6, plain6, atol, rtol)
    ok = ok5 and ok6
    with torch.no_grad():
        kp6, vp6, ks6, vs6 = KVC.page_view(cache, 0, max_len)
        pi6 = KVC.identity_page_indices(slots, max_len, max_len, device="cuda")
        total = cache.lengths + 1
        if key5.endswith(("_group", "_group_fp32", "_wide", "_narrow")):
            ref = PA.paged_attention_narrow_ref if key5.endswith("_narrow") else PA.paged_attention_group_ref
            c5, ch5, w5 = _cluster_split(q_dtype, kp.dtype, hq // hkv, d, max_len, 128, slots * hkv, True)
            c6, ch6, w6 = _cluster_split(q_dtype, kp.dtype, hq // hkv, d, max_len, max_len, slots * hkv, False)
            plan5 = ref(q, kp, vp, total, pi, cluster=c5, chunk=ch5, k_scales=ks, v_scales=vs)
            plan6 = ref(q, kp6, vp6, total, pi6, cluster=c6, chunk=ch6, k_scales=ks6, v_scales=vs6, prescale_q=True)
            split = f"K5 {c5} blocks x {w5} chunks of {ch5}, K6 {c6} x {w6} of {ch6}"
        else:  # the group tiles: the split-KV arithmetic at the chunks the launcher picks
            (ch5, n5), (ch6, n6) = _tile_split(slots, hq, hkv, max_len)
            plan5 = PA.paged_attention_split_ref(q, kp, vp, total, pi, chunk=ch5, k_scales=ks, v_scales=vs)
            plan6 = PA.paged_attention_split_ref(q, kp6, vp6, total, pi6, chunk=ch6, k_scales=ks6, v_scales=vs6,
                                                 prescale_q=True)
            split = f"K5 {n5} splits of {ch5}, K6 {n6} of {ch6}"
    p5, okp5 = _error(out5, plan5, atol, rtol)
    p6, okp6 = _error(out6, plan6, atol, rtol)
    ok = ok and okp5 and okp6
    plan = f"  vs the plan's plain version {p5:.3e} / {p6:.3e} ({split})"
    exact = ""
    if q_dtype == torch.float16:
        with torch.no_grad():
            exacts = (plain5, _k6_exact(q, cache, slots, max_len))
        (x5, okx5), (x6, okx6) = _fp16_error(out5, exacts[0]), _fp16_error(out6, exacts[1])
        ok = ok and okx5 and okx6
        exact = f"  vs the exact versions {x5:.2f} / {x6:.2f} of fp16's limit"
    say(f"[decode] {label:<42} K5 vs plain {e5:.3e}  K6 vs plain {e6:.3e}{plan}  atol {atol:g} rtol {rtol:g}{exact}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[decode] {label} outside tolerance")
    if q_dtype == torch.float16 and controls is not None:
        controls.append(_fp16_control(label, (out5, out6), exacts))
    return {key5: max(e5, p5), key6: max(e6, p6)}


def _gather(errs: dict, got: dict) -> None:
    for key, err in got.items():
        errs.setdefault(key, []).append(err)


def check_paged_permuted(label, gen, batch, hq, hkv, d, page_size, pps, store, q_dtype, lengths,
                         controls=None) -> dict:
    """K5 over a permuted page table with NaN in every page row past each
    sequence's length (payload, or the scales of a quantized cache), at
    DECODE_TOL; for fp16 q, the control as in check_decode.  Returns {launch
    key: max error}."""
    n_pages = batch * pps + 5
    quant = store in QK.QUANT_DTYPES
    shape = (hkv, n_pages, page_size, d)
    kp, vp = _rand(gen, shape, torch.float32), _rand(gen, shape, torch.float32)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = QK.quantize_tokens(kp, store), QK.quantize_tokens(vp, store)
    else:
        kp, vp = kp.to(store), vp.to(store)
    pi = torch.randperm(n_pages, generator=gen)[: batch * pps].view(batch, pps).to(torch.int32).cuda()
    lens = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    row = torch.arange(pps * page_size, device="cuda").view(1, pps, page_size)
    past = torch.zeros(n_pages, page_size, dtype=torch.bool, device="cuda")
    past[pi.long()] = row >= lens.clamp(min=1)[:, None, None]
    for t_ in ((ks, vs) if quant else (kp, vp)):
        t_[:, past] = float("nan")
    q = _rand(gen, (batch, hq, d), q_dtype)
    key = _decode_keys(q_dtype, d, hq // hkv)[0]
    before = FA.KERNEL_LAUNCHES[key]
    with torch.no_grad():
        out = PA.paged_attention(q, kp, vp, lens, pi, k_scales=ks, v_scales=vs)
        plain = PA.paged_attention_ref(q, kp, vp, lens, pi, k_scales=ks, v_scales=vs)
    if FA.KERNEL_LAUNCHES[key] != before + 1:
        raise AssertionError(f"[decode] {label}: {key} not launched")
    torch.cuda.synchronize()
    if out.shape != q.shape or not torch.isfinite(out).all() or not torch.isfinite(plain).all():
        raise AssertionError(f"[decode] {label}: NaN past the length leaked")
    atol, rtol = DECODE_TOL[q_dtype]
    err, ok = _error(out, plain, atol, rtol)
    exact = ""
    if q_dtype == torch.float16:  # the plain version is K5's exact one
        share, ok_exact = _fp16_error(out, plain)
        ok = ok and ok_exact
        exact = f"  {share:.2f} of fp16's limit"
    say(f"[decode] {label:<42} K5 vs plain {err:.3e}  atol {atol:g} rtol {rtol:g}{exact}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[decode] {label} outside tolerance")
    if q_dtype == torch.float16 and controls is not None:
        controls.append(_fp16_control(label, (out,), (plain,)))
    return {key: err}


def phase_decode(seed: int) -> tuple[dict, dict]:
    """Returns each decode kernel's worst error against its plain versions,
    by launch key (K5 / K6, the narrow, the whole-group and the wide K5 /
    K6), and the wide and narrow kernels' launches in the phase (no model
    path runs head dims above 256 or below 64)."""
    _reset_launches()
    gen = torch.Generator().manual_seed(seed + 6)
    bf16, f32, i8, f8 = torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn
    say("[decode] tolerance (atol + rtol |plain|): " + "; ".join(
        f"{str(dt).split('.')[-1]} q atol {a:g} rtol {r:g}" for dt, (a, r) in DECODE_TOL.items())
        + f"; fp16 q also against the exact versions at atol min(2e-3, {FP16_ROW_ATOL:g} x a row's largest |exact|) "
        "(DECODE_TOL says why)")
    ragged = [0, 16, 299, 1022, 511, 63, 799, 127]  # cache lengths: the kernels read lengths + 1 tokens
    errs = {}
    for name, store, q_dtype in (("bf16", bf16, bf16), ("fp32", f32, f32), ("int8", i8, bf16), ("fp8", f8, bf16),
                                 ("int8 fp32 q", i8, f32)):
        _gather(errs, check_decode(f"8 slots h12 D64 L1024 {name} cache", gen, 8, 12, 12, 64, 1024, store, q_dtype,
                                   ragged))
    for name, store in (("int8", i8), ("bf16", bf16)):
        _gather(errs, check_decode(f"gqa hq32 hkv8 D128 L1024 {name} cache", gen, 4, 32, 8, 128, 1024, store, bf16,
                                   [5, 1023, 200, 640]))
    lens = [1, 17, 300, 1023, 512, 0, 800, 1024]
    for name, store, q_dtype in (("int8", i8, bf16), ("fp8", f8, bf16), ("bf16", bf16, bf16), ("fp32", f32, f32)):
        _gather(errs, check_paged_permuted(f"paged permuted ps16 NaN past length {name}", gen, 8, 12, 12, 64, 16, 64,
                                           store, q_dtype, lens))
    # The split's edges: cache lengths 0, chunk - 1, chunk, chunk + 1 (for
    # K5's chunk and K6's; for the whole-group kernel its chunk and its
    # cluster's span of chunks) and capacity - 1, so that a sequence reads
    # one token, exactly one or two whole splits, one token of a next split,
    # or every split; most splits of the short ones are empty.  The last row
    # is serving-mqa's layer (8 slots, 16 q heads on one KV head, max_len
    # 2048).
    sms = PA._sm_count(0)
    for slots, hq, hkv, d, max_len in ((8, 12, 12, 64, 1024), (8, 32, 8, 128, 1024), (8, 16, 1, 128, 1024),
                                       (8, 16, 1, 128, 2048)):
        pairs = slots * hkv * PA.group_tiles(hq // hkv)[0]
        c5, n5 = PA.decode_split(max_len, pairs, 128, sms)
        c6, n6 = PA.decode_split(max_len, pairs, PA.DECODE_TILE, sms)
        for name, store, q_dtype in (("bf16", bf16, bf16), ("fp32", f32, f32), ("int8", i8, bf16), ("fp8", f8, bf16)):
            if PA.uses_group_kernel(q_dtype, d, hq // hkv):
                cl, ch, walks = _cluster_split(q_dtype, store, hq // hkv, d, max_len, 128, slots * hkv, True)
                span = cl * ch
                edges = [0, ch - 1, ch, ch + 1, span - 1, span, span + 1, max_len - 1]
                split = f"whole group {cl} blocks x {walks} chunks of {ch}"
            else:
                edges = [0, c5 - 1, c5, c5 + 1, c6 - 1, c6 + 1, 2 * c6, max_len - 1]
                split = f"K5 {n5}x{c5} K6 {n6}x{c6}"
            edges = [min(e, max_len - 1) for e in edges]
            _gather(errs, check_decode(f"split edges {split} hq{hq} hkv{hkv} D{d} L{max_len} {name}", gen, slots, hq,
                                       hkv, d, max_len, store, q_dtype, edges))
            say(f"[decode] split edges hq{hq} hkv{hkv} D{d} L{max_len} {name}: cache lengths {edges}")
    # serving-mqa's layer with most slots past 1024 tokens, so that every
    # block of most clusters walks two chunks
    mqa_lens = [2047, 1919, 1500, 1100, 1025, 2000, 700, 0]
    for name, store in (("bf16", bf16), ("int8", i8)):
        _gather(errs, check_decode(f"serving-mqa layer L2048 {name} cache", gen, 8, 16, 1, 128, 2048, store, bf16,
                                   mqa_lens))
    say(f"[decode] serving-mqa layer (8 slots hq16 hkv1 D128 L2048): cache lengths {mqa_lens}")
    # The wide kernel at time_decode's d512 / d1024 shape (8 slots, GQA 8/2,
    # max_len 2048), so that the split it is timed at is also checked: the
    # cache lengths it times (contexts 1920-2048, every block walking its
    # most chunks), then the edges of K5's split (pages of 128) and of K6's
    # (chunks of one stage, 16 tokens for fp32 at D1024): lengths 0, chunk - 1,
    # chunk, chunk + 1, cluster x chunk - 1, cluster x chunk, cluster x chunk
    # + 1 and max_len - 1; and K5 over permuted pages of 16 at 2048 tokens
    for d in (512, 1024):
        for name, store, q_dtype in (("bf16", bf16, bf16), ("int8", i8, bf16), ("fp32", f32, f32)):
            timed = torch.randint(1919, 2048, (8,), generator=gen).tolist()
            _gather(errs, check_decode(f"wide hq8 hkv2 D{d} L2048 timed lengths {name}", gen, 8, 8, 2, d, 2048, store,
                                       q_dtype, timed))
            say(f"[decode] wide hq8 hkv2 D{d} L2048 {name}: timed cache lengths {timed}")
            for kernel, paged, unit in (("K5", True, 128), ("K6", False, 2048)):
                cl, ch, walks = _cluster_split(q_dtype, store, 4, d, 2048, unit, 16, paged)
                span = cl * ch
                edges = [min(e, 2047) for e in (0, ch - 1, ch, ch + 1, span - 1, span, span + 1, 2047)]
                _gather(errs, check_decode(f"wide D{d} {kernel} edges {cl} blocks x {walks} chunks of {ch} {name}",
                                           gen, 8, 8, 2, d, 2048, store, q_dtype, edges))
                say(f"[decode] wide hq8 hkv2 D{d} L2048 {name}: {kernel} split edges, cache lengths {edges}")
        _gather(errs, check_paged_permuted(f"paged permuted ps16 L2048 NaN past length D{d} hq8 hkv2 int8", gen, 8,
                                           8, 2, d, 16, 128, i8, bf16, [1, 2048, 1920, 2000, 33, 0, 1500, 2047]))
    controls = []
    for key, got in check_decode_configs(gen, controls).items():
        errs.setdefault(key, []).extend(got)
    for key, got in check_decode_padded(gen, controls).items():
        errs.setdefault(key, []).extend(got)
    say(f"[decode] fp16 q control (each case's K5 / K6 outputs rounded to bf16): rejected by fp16's limit in "
        f"{sum(controls)} of {len(controls)} cases")
    if not all(controls):
        raise AssertionError("[decode] fp16 q's limit passes an output rounded to bf16")
    phase = {key: FA.KERNEL_LAUNCHES[key] for key in WIDE_KEYS + NARROW_KEYS}
    say(f"[decode] wide and narrow kernel launches in the phase: {phase}")
    if not all(phase.values()):
        raise AssertionError(f"[decode] a wide or narrow decode kernel never launched: {phase}")
    return {key: max(got) for key, got in errs.items()}, phase


WIDE_KEYS = ("paged_decode_wide", "fused_decode_wide")
NARROW_KEYS = ("paged_decode_narrow", "fused_decode_narrow")


# The whole-group kernel at serving-mqa's own shape (8 slots of 2048, 16 q
# heads on one KV head of 128) and Falcon-40B's layer (8 slots of 2048, GQA
# 128/8 at D64): (label, q heads, KV heads, head dim, cache lengths).  The
# lengths (the kernels read one more) are chosen against each split (both
# printed): a sequence of one token or a few chunks leaves most blocks of
# its cluster empty, one of just under cluster x chunk tokens keeps every
# block live on one chunk, and longer ones have blocks walk several chunks.
GROUP_SHAPES = (
    ("serving-mqa shape hq16 hkv1 D128 L2048", 16, 1, 128, [0, 100, 128, 700, 1022, 1100, 1600, 2047]),
    ("falcon-40b layer hq128 hkv8 D64 L2048", 128, 8, 64, [0, 100, 127, 128, 255, 700, 1500, 2047]),
    # RecurrentGemma-2B's local-attention layer (10 q heads on one KV head of
    # 256, window 2048): stages of 64 tokens on a 16-bit cache
    ("recurrentgemma-2b layer hq10 hkv1 D256 L2048", 10, 1, 256, [0, 62, 63, 64, 511, 700, 1919, 2047]),
)


def check_decode_configs(gen, controls: list) -> dict:
    """K5 and K6 at the configurations the JAX kernels take beyond D64/D128,
    bf16/fp32 q and groups of up to 8: every other head dim (8, 16 and 32,
    run at 32; 256; 384 and 512, run at 512; 640-1024, run at 1024) at
    groups 1 and 16 on bf16 and int8 caches; fp32 q at the narrow and wide
    widths; fp16 q over fp16, int8 and fp8 caches at D64 and D128; above
    D256 (the wide kernel) group 4 on bf16, int8 and fp8 caches, fp32 q over
    fp8, fp16 q over fp16, int8 and fp8, and a group of 12 (two passes of 6
    rows); GQA groups 12, 16, 48 (StarCoder) and 71 (Falcon-7B),
    which at D64 / D128 run the whole-group kernel (fp32 q: the 3xTF32 one,
    also at groups 12 and 48 at D128, two passes at 71 / D128, and 24 / 2 and
    48 at D64, over fp32 and int8 caches); fp32 q at group 16 at D8, D32
    and D256 (the 3xTF32 whole-group kernel since it runs those widths); the
    whole-group kernel at serving-mqa's shape, Falcon-40B's layer and
    RecurrentGemma-2B's D256 layer on bf16, fp16, int8 and fp8 caches and
    with fp32 q on fp32, int8 and fp8 caches at its splits' edges
    (GROUP_SHAPES); the whole-group kernel at D8, D16, D32 and D256 at groups 9,
    10, 16 and 48 on bf16, fp16, int8 and fp8 caches at its splits' edges
    (at D8-32 each fp16 case also on 4 KV heads with 1-token slots), at
    groups 24 and 71 at D8 and D32, and at time_decode's d32_mqa shape; the
    3xTF32 whole-group kernel at D8, D16, D32 and D256 at groups 10 (on two
    KV heads) and 16, and 48 at D256 (two passes), on fp32, int8 and fp8
    caches at its splits' edges, at groups 24 and 71 at D8 and D32 (2 and 5
    row tiles) and 48 at D256 on fp32 and int8 caches, and at time_decode's
    d32_mqa_fp32 shape; K5 over a permuted page table with NaN past the
    lengths at D16 (group 16 on one and on 4 KV heads), D128, D256 (group
    16) and D512, and with fp32 q at D16, D128 and D256 (group 16) and D64
    (group 16 on two KV heads); the narrow kernel at D8, D16 and D32 at
    groups 1, 2, 4 and 8 on every payload for fp32, bf16 and fp16 q at its
    tiles' and splits' edges, at time_decode's d32 and d32_gqa4 shapes, and
    K5 over permuted pages of 16 and 48 tokens (tiles across pages) with
    NaN past the lengths.  Each against its plain version at DECODE_TOL,
    fp16 q's cases with their control.  Returns {launch key: errors}."""
    bf16, f16, f32, i8, f8 = torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.float8_e4m3fn
    ragged = [0, 16, 299, 1022, 511, 63, 799, 127]
    errs = {}

    def one(label, slots, hq, hkv, d, store, q_dtype, lengths=ragged, max_len=1024):
        _gather(errs, check_decode(label, gen, slots, hq, hkv, d, max_len, store, q_dtype, lengths[:slots], controls))

    for d in (8, 16, 32, 256, 384, 512, 640, 768, 896, 1024):
        for name, store in (("bf16", bf16), ("int8", i8)):
            one(f"D{d} group 1 (hq2 hkv2) {name} cache", 8, 2, 2, d, store, bf16)
            one(f"D{d} group 16 (hq16 hkv1) {name} cache", 4, 16, 1, d, store, bf16)
    for d in (8, 32, 256, 512, 1024):
        one(f"D{d} hq8 hkv2 fp32 cache fp32 q", 4, 8, 2, d, f32, f32)
        one(f"D{d} hq2 hkv2 int8 cache fp32 q", 4, 2, 2, d, i8, f32)
    # fp32 q at a group above 8 at D8-32 and D256: the 3xTF32 whole-group
    # kernel (until it ran those widths, the group tiles)
    for d in (8, 32, 256):
        for name, store in (("fp32", f32), ("int8", i8)):
            one(f"D{d} group 16 (hq16 hkv1) {name} cache fp32 q", 4, 16, 1, d, store, f32)
    for d, hq, hkv in ((64, 12, 12), (128, 32, 8)):
        for name, store in (("fp16", f16), ("int8", i8), ("fp8", f8)):
            one(f"fp16 q D{d} hq{hq} hkv{hkv} {name} cache", 8, hq, hkv, d, store, f16)
    for hq, hkv, d in ((12, 1, 128), (16, 1, 128), (48, 1, 128), (71, 1, 64), (24, 2, 64)):
        for name, store in (("bf16", bf16), ("int8", i8)):
            one(f"group {hq // hkv} hq{hq} hkv{hkv} D{d} {name} cache", 8, hq, hkv, d, store, bf16)
        one(f"group {hq // hkv} hq{hq} hkv{hkv} D{d} fp16 cache fp16 q", 8, hq, hkv, d, f16, f16)
    one("group 71 hq71 hkv1 D64 fp32 cache fp32 q", 4, 71, 1, 64, f32, f32)
    # the fp32 whole-group kernel's other row tilings: a padded row tile
    # (12), 2 and 4 row tiles (24 / 2, 48), 8 at D64 (71, above) and at
    # D128 two passes of 48 (71)
    for hq, hkv, d in ((12, 1, 128), (48, 1, 128), (71, 1, 128), (24, 2, 64), (48, 1, 64)):
        for name, store in (("fp32", f32), ("int8", i8)):
            one(f"group {hq // hkv} hq{hq} hkv{hkv} D{d} {name} cache fp32 q", 8, hq, hkv, d, store, f32)
    # the wide kernel's other configurations: group 4 on every payload with
    # bf16 q, fp32 q over fp8, fp16 q over fp16, int8 and fp8 (with their
    # control), a pass of 6 rows (group 12)
    for d in (384, 640, 1024):
        for name, store in (("bf16", bf16), ("int8", i8), ("fp8", f8)):
            one(f"D{d} group 4 (hq8 hkv2) {name} cache", 8, 8, 2, d, store, bf16)
    for d in (512, 1024):
        one(f"D{d} hq8 hkv2 fp8 cache fp32 q", 4, 8, 2, d, f8, f32)
        for name, store in (("fp16", f16), ("int8", i8), ("fp8", f8)):
            one(f"fp16 q D{d} hq8 hkv2 {name} cache", 8, 8, 2, d, store, f16)
    one("D768 group 12 (hq12 hkv1) bf16 cache", 4, 12, 1, 768, bf16, bf16)
    for label, hq, hkv, d, lengths in GROUP_SHAPES:
        for name, store, q_dtype in (("bf16", bf16, bf16), ("fp16", f16, f16), ("int8", i8, bf16), ("fp8", f8, bf16)):
            one(f"{label} {name} cache", 8, hq, hkv, d, store, q_dtype, lengths, max_len=2048)
        cl, ch, walks = _cluster_split(bf16, bf16, hq // hkv, d, 2048, 128, 8 * hkv, True)
        say(f"[decode] {label}: cache lengths {lengths}; split {cl} blocks a cluster x {walks} chunks of {ch} "
            f"tokens; blocks of a cluster live: {[min(cl, -(-(n + 1) // ch)) for n in lengths]}; chunks the busiest "
            f"block walks: {[-(-(-(-(n + 1) // ch)) // cl) for n in lengths]}")
        # fp32 q over fp32, int8 and fp8 caches: the 3xTF32 whole-group
        # kernel, at cache lengths on the edges of K6's split (chunks of one
        # stage: 64 tokens for an fp32 cache at D128, 32 at D256) and of K5's
        # (pages of 128): 0, a chunk - 1 and + 1, a cluster's span - 1 (K6);
        # a chunk, a span and + 1 (K5), the capacity - 1
        for name, store in (("fp32", f32), ("int8", i8), ("fp8", f8)):
            c6, ch6, _ = _cluster_split(f32, store, hq // hkv, d, 2048, 2048, 8 * hkv, False)
            c5, ch5, _ = _cluster_split(f32, store, hq // hkv, d, 2048, 128, 8 * hkv, True)
            edges = [min(e, 2047) for e in (0, ch6 - 1, ch6 + 1, c6 * ch6 - 1, ch5, c5 * ch5, c5 * ch5 + 1, 2047)]
            one(f"{label} fp32 q {name} cache", 8, hq, hkv, d, store, f32, edges, max_len=2048)
            say(f"[decode] {label} fp32 q {name} cache: K6 {c6} blocks x chunks of {ch6}, K5 {c5} blocks x chunks "
                f"of {ch5}; cache lengths {edges}")
    # the whole-group kernel at D8, D16, D32 (all run at 32, P V split by
    # tokens) and D256 (stages of 64 tokens on a 16-bit cache, passes of at
    # most 32 q heads: group 48 in two) at groups 9, 10 (on two KV heads),
    # 16 and 48 on bf16, fp16 (fp16 q, with its control), int8 and fp8
    # caches, at cache lengths on the edges of K6's split (chunks of one
    # stage) and K5's (pages of 128): 0, a chunk - 1, a chunk, a chunk + 1, a
    # cluster's span - 1 and the span (K6), a span + 1 (K5), the capacity - 1.
    # Beside each fp16 case at D8-32, the same group on 4 KV heads with
    # three slots of one token, whose outputs are raw V rows (|v| up to
    # about 4: fp16's limit at its 2e-3 cap)
    for d in (8, 16, 32, 256):
        for group, hkv in ((9, 1), (10, 2), (16, 1), (48, 1)):
            for name, store, q_dtype in (("bf16", bf16, bf16), ("fp16", f16, f16), ("int8", i8, bf16),
                                         ("fp8", f8, bf16)):
                c6, ch6, _ = _cluster_split(q_dtype, store, group, d, 2048, 2048, 8 * hkv, False)
                c5, ch5, _ = _cluster_split(q_dtype, store, group, d, 2048, 128, 8 * hkv, True)
                edges = [min(e, 2047) for e in (0, ch6 - 1, ch6, ch6 + 1, c6 * ch6 - 1, c6 * ch6, c5 * ch5 + 1, 2047)]
                one(f"whole group D{d} group {group} hq{group * hkv} hkv{hkv} {name} cache", 8, group * hkv, hkv, d,
                    store, q_dtype, edges, max_len=2048)
                if q_dtype == f16 and d <= 32:
                    c6, ch6, _ = _cluster_split(q_dtype, store, group, d, 2048, 2048, 32, False)
                    short = [min(e, 2047) for e in (0, 0, 0, 1, ch6 - 1, ch6, ch6 + 1, 2047)]
                    one(f"whole group D{d} group {group} hq{group * 4} hkv4 fp16 cache 1-token slots", 8, group * 4, 4,
                        d, store, q_dtype, short, max_len=2048)
        say(f"[decode] whole group D{d}: K6 chunks of {PA.group_tokens(d, 2)} tokens on a 16-bit cache, "
            f"{PA.group_tokens(d, 1)} on an 8-bit one; q heads a pass at most {PA.group_max_rows(bf16, d)}")
    # the D32 kernel's other row-tile groups, 2 (group 24: 4 token groups a
    # row tile) and 8 (group 71: one token group a row tile, no merge of
    # token groups), at D8 and D32 on bf16 and int8 caches
    for d in (8, 32):
        for group in (24, 71):
            for name, store in (("bf16", bf16), ("int8", i8)):
                one(f"whole group D{d} group {group} hq{group} hkv1 {name} cache", 8, group, 1, d, store, bf16)
    # time_decode's d32_mqa shape (32 slots of 1024, 16 q heads on one KV
    # head of 32) at its timed lengths, so that the split it is timed at is
    # also checked
    timed = torch.randint(960, 1024, (32,), generator=gen).tolist()
    for name, store in (("bf16", bf16), ("int8", i8)):
        one(f"d32_mqa shape hq16 hkv1 D32 L1024 32 slots {name} cache", 32, 16, 1, 32, store, bf16, timed)
    say(f"[decode] d32_mqa shape: timed cache lengths {timed}")
    # the 3xTF32 whole-group kernel at D8, D16, D32 (run at 32: a warp holds
    # all 32 columns, the row tile's warps are token groups) and D256 (four
    # warps share a token's columns, stages of 32 fp32 tokens, passes of at
    # most 32 q heads: group 48 in two) at groups 10 (on two KV heads) and
    # 16, and 48 at D256, on fp32, int8 and fp8 caches at its splits' edges
    # (as the 16-bit q cases above); then its other row tilings, groups 24
    # and 71 at D8 and D32 (2 and 5 row tiles) and 48 at D256, on fp32 and
    # int8 caches at the ragged lengths; then time_decode's d32_mqa_fp32
    # shape at its timed lengths
    for d in (8, 16, 32, 256):
        for group, hkv in ((10, 2), (16, 1)) + (((48, 1),) if d == 256 else ()):
            for name, store in (("fp32", f32), ("int8", i8), ("fp8", f8)):
                c6, ch6, _ = _cluster_split(f32, store, group, d, 2048, 2048, 8 * hkv, False)
                c5, ch5, _ = _cluster_split(f32, store, group, d, 2048, 128, 8 * hkv, True)
                edges = [min(e, 2047) for e in (0, ch6 - 1, ch6, ch6 + 1, c6 * ch6 - 1, c6 * ch6, c5 * ch5 + 1, 2047)]
                one(f"whole group fp32 q D{d} group {group} hq{group * hkv} hkv{hkv} {name} cache", 8, group * hkv,
                    hkv, d, store, f32, edges, max_len=2048)
        say(f"[decode] whole group fp32 q D{d}: K6 chunks of {PA.group_tokens(d, 4)} tokens on an fp32 cache, "
            f"{PA.group_tokens(d, 1)} on an 8-bit one; q heads a pass at most {PA.group_max_rows(f32, d)}")
    for d, groups in ((8, (24, 71)), (32, (24, 71)), (256, (48,))):
        for group in groups:
            for name, store in (("fp32", f32), ("int8", i8)):
                one(f"whole group fp32 q D{d} group {group} hq{group} hkv1 {name} cache", 8, group, 1, d, store, f32)
    timed = torch.randint(960, 1024, (32,), generator=gen).tolist()
    for name, store in (("fp32", f32), ("int8", i8)):
        one(f"d32_mqa_fp32 shape hq16 hkv1 D32 L1024 32 slots {name} cache", 32, 16, 1, 32, store, f32, timed)
    say(f"[decode] d32_mqa_fp32 shape: timed cache lengths {timed}")
    # the narrow kernel (head dims 8-32, groups of up to 8): D8, D16 and D32
    # at groups 1, 2, 4 and 8 (its q-row capacities) on two KV heads, on
    # every payload for fp32, bf16 and fp16 q (fp16's with its control), at
    # cache lengths on the edges of its 32-token tiles (the kernels read one
    # more token: 1, 31, 32 and 33 tokens), of its chunks (128 tokens: K5's
    # pages of 128, K6's chunk: one chunk and one token past it), one token
    # past its cluster's span of chunks, and the capacity
    for d in (8, 16, 32):
        for group in (1, 2, 4, 8):
            c6, ch6, _ = _cluster_split(bf16, i8, group, d, 1024, 1024, 16, False)
            edges = [min(e, 1023) for e in (0, 30, 31, 32, ch6 - 1, ch6, c6 * ch6, 1023)]
            for q_dtype, payloads in ((f32, (("fp32", f32), ("int8", i8), ("fp8", f8))),
                                      (bf16, (("bf16", bf16), ("int8", i8), ("fp8", f8))),
                                      (f16, (("fp16", f16), ("int8", i8), ("fp8", f8)))):
                for name, store in payloads:
                    one(f"narrow D{d} group {group} hq{2 * group} hkv2 {name} cache {str(q_dtype)[6:]} q", 8,
                        2 * group, 2, d, store, q_dtype, edges)
            say(f"[decode] narrow D{d} group {group}: K6 {c6} blocks x chunks of {ch6} (int8 cache); cache lengths "
                f"{edges}")
    # time_decode's d32 and d32_gqa4 shapes (32 slots of 1024, 16 q heads on
    # 16 and on 4 KV heads) at their timed lengths, so that the splits they
    # are timed at are also checked
    timed = torch.randint(959, 1024, (32,), generator=gen).tolist()
    for hkv in (16, 4):
        for name, store, q_dtype in (("int8", i8, bf16), ("fp8", f8, bf16), ("bf16", bf16, bf16), ("fp32", f32, f32)):
            one(f"narrow d32 shape hq16 hkv{hkv} D32 L1024 32 slots {name} cache", 32, 16, hkv, 32, store, q_dtype,
                timed)
    say(f"[decode] narrow d32 / d32_gqa4 shapes: timed cache lengths {timed}")
    lens = [1, 17, 300, 1023, 512, 0, 800, 1024]
    # K5 through the narrow kernel over permuted pages of 16 and 48 tokens
    # (a tile across pages; chunks of 144 tokens at 48), NaN past the lengths
    for d, group in ((8, 1), (16, 4), (32, 8), (32, 2)):
        for page_size in (16, 48):
            for name, store, q_dtype in (("int8", i8, bf16), ("fp16", f16, f16), ("fp32", f32, f32),
                                         ("fp8 fp32 q", f8, f32)):
                pps = -(-1024 // page_size)
                _gather(errs, check_paged_permuted(
                    f"narrow paged permuted ps{page_size} NaN past length D{d} group {group} {name}", gen, 8,
                    2 * group, 2, d, page_size, pps, store, q_dtype, [min(n, pps * page_size) for n in lens],
                    controls))
    # group 16 at D16 also on 4 KV heads, beside one: four times the raw V
    # rows of the two 1-token slots
    for d, hq, hkv in ((16, 16, 1), (16, 64, 4), (128, 16, 1), (256, 16, 1), (512, 8, 2)):
        for name, store, q_dtype in (("int8", i8, bf16), ("fp16", f16, f16)):
            _gather(errs, check_paged_permuted(f"paged permuted ps16 NaN past length D{d} hq{hq} hkv{hkv} {name}",
                                               gen, 8, hq, hkv, d, 16, 64, store, q_dtype, lens, controls))
    # the fp32 whole-group K5 over pages of 16 (a stage over several pages)
    for d, hq, hkv in ((128, 16, 1), (64, 32, 2), (16, 16, 1), (256, 16, 1)):
        for name, store in (("fp32", f32), ("int8 fp32 q", i8), ("fp8 fp32 q", f8)):
            _gather(errs, check_paged_permuted(f"paged permuted ps16 NaN past length D{d} hq{hq} hkv{hkv} {name}",
                                               gen, 8, hq, hkv, d, 16, 64, store, f32, lens, controls))
    return errs


# Head dims below the width the decode kernels are instantiated at
# (`paged_attention.decode_width`): 48 at D64; Phi-2's 80, GPT-NeoX-20B's 96
# and MPT-30B's 112 at D128; StableLM-2-12B's 160, 192 and 240 at D256; 320
# at D512 and 640 at D1024 (the wide kernel, a slab that d ends inside)
PADDED_DECODE_DIMS = (48, 80, 96, 112, 160, 192, 240, 320, 640)
# (name, cache, q dtype): every q dtype over its own dtype, int8 and fp8
PADDED_DECODE_STORES = tuple((f"{name} cache {qn} q", store, q)
                             for q, qn in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"), (torch.float16, "fp16"))
                             for name, store in ((qn, q), ("int8", torch.int8), ("fp8", torch.float8_e4m3fn)))


def _tile_split(slots: int, hq: int, hkv: int, max_len: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The group tiles' (chunk, splits) for K5 over pages of 128 and for K6
    at a capacity of max_len, as their launcher picks them on this card."""
    pairs = slots * hkv * PA.group_tiles(hq // hkv)[0]
    sms = PA._sm_count(torch.cuda.current_device())
    return PA.decode_split(max_len, pairs, 128, sms), PA.decode_split(max_len, pairs, PA.DECODE_TILE, sms)


def _split_edges(q_dtype, store, hq: int, hkv: int, d: int, slots: int, max_len: int) -> tuple[list, str]:
    """Cache lengths on the edges of a configuration's splits, as its
    launchers choose them on this card (the kernels read one more token):
    for a cluster kernel 0, K6's chunk - 1, chunk, chunk + 1, its cluster's
    span - 1 and span, K5's span + 1 (pages of 128) and the capacity - 1;
    for the group tiles 0, K5's chunk - 1, chunk, chunk + 1, K6's chunk - 1
    and + 1, two of K6's chunks and the capacity - 1.  Returns them and the
    split they were taken from."""
    group = hq // hkv
    if PA.uses_wide_kernel(q_dtype, d, group) or PA.uses_group_kernel(q_dtype, d, group):
        c6, ch6, _ = _cluster_split(q_dtype, store, group, d, max_len, max_len, slots * hkv, False)
        c5, ch5, w5 = _cluster_split(q_dtype, store, group, d, max_len, 128, slots * hkv, True)
        edges = (0, ch6 - 1, ch6, ch6 + 1, c6 * ch6 - 1, c6 * ch6, c5 * ch5 + 1, max_len - 1)
        split = f"K5 {c5} blocks x {w5} chunks of {ch5}, K6 {c6} x chunks of {ch6}"
    else:
        (c5, n5), (c6, n6) = _tile_split(slots, hq, hkv, max_len)
        edges = (0, c5 - 1, c5, c5 + 1, c6 - 1, c6 + 1, 2 * c6, max_len - 1)
        split = f"K5 {n5}x{c5} K6 {n6}x{c6}"
    return [min(e, max_len - 1) for e in edges], split


def check_decode_padded(gen, controls: list) -> dict:
    """K5 and K6 at the head dims that run inside a wider instantiation
    (PADDED_DECODE_DIMS: 48-240 in the split-KV and whole-group kernels'
    D64 / D128 / D256, 320 and 640 in the wide kernel's D512 / D1024): at
    each head dim every q dtype over every payload (PADDED_DECODE_STORES),
    once at one of the split-KV kernel's groups 1, 4 and 8 (on 2 KV heads)
    and once at one of the whole-group kernel's 16 and 71 (on one KV head),
    the groups taken in turn and shifted by one at each head dim, so that
    each head dim meets every payload and group and each payload every
    group; at 320 and 640 the same groups through the wide kernel.  Cache
    lengths on the edges of each configuration's splits (`_split_edges`); K5 over
    pages of 128 (`decode_attention_paged`) and K6 against their plain
    versions and their plan's at DECODE_TOL (`check_decode`), fp16 q's
    with its control; then K5 over permuted pages of 16 with NaN past the
    lengths at each head dim, two configurations each; last, head dims 24,
    40 and 1040 on the card must raise NotImplementedError through both
    entry points and launch nothing.  Returns {launch key: errors}."""
    errs = {}
    for j, d in enumerate(PADDED_DECODE_DIMS):
        for i, (name, store, q_dtype) in enumerate(PADDED_DECODE_STORES):
            for group, hkv in (((1, 4, 8)[(i + j) % 3], 2), ((16, 71)[(i + j) % 2], 1)):
                edges, split = _split_edges(q_dtype, store, group * hkv, hkv, d, 8, 1024)
                _gather(errs, check_decode(f"D{d} group {group} hq{group * hkv} hkv{hkv} {name}", gen, 8,
                                           group * hkv, hkv, d, 1024, store, q_dtype, edges, controls))
                say(f"[decode] D{d} group {group} {name}: {split}; cache lengths {edges}")
    lens = [1, 17, 300, 1023, 512, 0, 800, 1024]
    for j, d in enumerate(PADDED_DECODE_DIMS):
        for k in range(2):
            name, store, q_dtype = PADDED_DECODE_STORES[(2 * j + 4 * k) % len(PADDED_DECODE_STORES)]
            group, hkv = ((4, 2), (16, 1))[k]
            _gather(errs, check_paged_permuted(f"paged permuted ps16 NaN past length D{d} group {group} {name}", gen,
                                               8, group * hkv, hkv, d, 16, 64, store, q_dtype, lens, controls))
    before = dict(FA.KERNEL_LAUNCHES)
    for d in (24, 40, 1040):
        cache = KVC.init_cache(1, 2, 2, 128, d, dtype=torch.bfloat16, quant_dtype=torch.int8, device="cuda")
        q = torch.zeros(2, 4, d, dtype=torch.bfloat16, device="cuda")
        for entry in (DA.decode_attention_paged, DA.decode_attention_fused):
            try:
                entry(q, cache, 0)
            except NotImplementedError as e:
                raised = str(e)
            else:
                raise AssertionError(f"[decode] D{d}: {entry.__name__} on the card did not raise")
    if FA.KERNEL_LAUNCHES != before:
        raise AssertionError("[decode] a head dim the kernels do not take launched a kernel")
    say(f"[decode] D24, D40 and D1040 through decode_attention_paged / _fused on the card: NotImplementedError before "
        f"any launch ({raised})")
    return errs


def _reset_launches() -> None:
    for key in FA.KERNEL_LAUNCHES:
        FA.KERNEL_LAUNCHES[key] = 0


def _burst(seed: int, tag: str, model: torch.nn.Module, max_len: int = 1024, **engine_kw) -> dict:
    """The serving burst: 16 requests (prompt lengths 16-900, budgets 32-64, half
    greedy, half sampled; all from `seed`) through an engine on `model` (a
    GPT, or a Llama with prefill_fn / decode_fn in engine_kw).  Every
    request must finish with its exact budget and in-range ids.  Returns the
    run's numbers, the kernels' launches during it and each request's
    (prompt, greedy, output) in submission order."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([
        rng.integers(16, 65, 2), rng.integers(129, 901, 4), rng.integers(16, 901, 10)
    ])
    rng.shuffle(lengths)
    budgets = rng.integers(32, 65, 16)
    eng = InferenceEngine(model, slots=8, max_len=max_len, scan_steps=8, device="cuda", rng_seed=seed, **engine_kw)
    # warm-up: cuBLAS handles, allocator; not counted
    eng.submit(rng.integers(0, cfg.vocab_size, 200).tolist(), max_new_tokens=4)
    eng.run()
    eng.finished.clear()
    eng.reset_stats()
    eng.reset_spec_state()
    torch.cuda.synchronize()

    _reset_launches()
    reqs, prompts = [], []
    for i in range(16):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=50) if i % 4 == 1 else dict(temperature=0.8, top_p=0.95)
        prompt = rng.integers(0, cfg.vocab_size, int(lengths[i])).tolist()
        prompts.append(prompt)
        reqs.append((eng.submit(prompt, max_new_tokens=int(budgets[i]), **kw), int(budgets[i])))
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(FA.KERNEL_LAUNCHES)

    by_uid = {r.uid: r for r in done}
    if len(done) != 16 or set(by_uid) != {u for u, _ in reqs}:
        raise AssertionError(f"[{tag}] {len(done)} of 16 requests finished")
    for uid, budget in reqs:
        out = by_uid[uid].output
        if len(out) != budget:
            raise AssertionError(f"[{tag}] request {uid}: {len(out)} tokens, budget {budget}")
        if not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"[{tag}] request {uid}: token id out of range")
    # K1 runs in every whole-prompt prefill, the target's and the draft's
    # (at admission, at a chunked prompt's end, in a resync); a chunk runs
    # the dense offset attention and launches nothing
    dispatches = eng.stats["prefill_dispatches"]
    draft = engine_kw.get("draft_model")
    draft_dispatches = eng.stats.get("draft_dispatches", 0)
    want = cfg.n_layer * dispatches + (draft.cfg.n_layer * draft_dispatches if draft is not None else 0)
    if launches["flash_fwd"] <= 0 or launches["flash_fwd"] != want:
        raise AssertionError(f"[{tag}] flash_fwd launches {launches['flash_fwd']} != {cfg.n_layer} x {dispatches} "
                             f"prefill dispatches + draft layers x {draft_dispatches} draft prefill dispatches")
    toks = sum(len(r.output) for r in done)
    ttft = sorted(r.ttft for r in done)
    return dict(
        lengths=sorted(lengths.tolist()), launches=launches, dispatches=dispatches, steps=eng.stats["decode_steps"],
        scans=eng.stats.get("decode_scans", 0), stats=dict(eng.stats),
        toks=toks, wall=wall, tokens_s=toks / wall, p50=statistics.median(ttft),
        p95=ttft[min(len(ttft) - 1, int(0.95 * len(ttft)))],
        requests=[(prompt, i % 2 == 0, by_uid[uid].output) for i, (prompt, (uid, _)) in enumerate(zip(prompts, reqs))],
    )


def _gpt2(seed: int) -> GPT:
    cfg = GPT2_124M
    t0 = time.perf_counter()
    model = GPT(cfg, generator=torch.Generator().manual_seed(seed), device="cuda")
    say(f"[serving] GPT-2 124M {cfg.dtype} vocab {cfg.vocab_size} layers {cfg.n_layer} heads {cfg.n_head} "
        f"width {cfg.n_embd}, random weights (seed {seed}) in {time.perf_counter() - t0:.1f} s")
    return model


def phase_serving(seed: int, model: GPT) -> dict:
    cfg = model.cfg
    r = _burst(seed, "serving", model)
    say(f"[serving] 16/16 requests finished with their exact budgets; prompt lengths {r['lengths']}")
    say(f"[serving] flash_fwd launches {r['launches']['flash_fwd']} = {cfg.n_layer} layers x {r['dispatches']} "
        f"prefill dispatches")
    say(f"[serving] {r['toks']} tokens in {r['wall']:.3f} s wall: {r['tokens_s']:.1f} tokens/s, TTFT p50 "
        f"{r['p50'] * 1e3:.1f} ms p95 {r['p95'] * 1e3:.1f} ms, decode steps {r['steps']}")
    return r


def phase_serving_quant(seed: int, model: GPT, base: dict, smi: str) -> tuple[dict, dict]:
    """The serving burst on an int8 cache decoding through K5 and on an fp8
    cache decoding through K6; returns each decode kernel's launches and
    each engine's tokens/s."""
    cases = (("int8", torch.int8, "paged", "paged_decode"), ("fp8", torch.float8_e4m3fn, "fused", "fused_decode"))
    return _decode_bursts(seed, "serving-quant", model, base, smi, cases)


def _decode_bursts(seed: int, tag: str, model: GPT, base: dict, smi: str, cases, max_len: int = 1024,
                   base_label: str = "bf16 cache, einsum, from [serving]") -> tuple[dict, dict]:
    """The serving burst once for each (cache name, kv_quant_dtype or None,
    attn_impl, kernel) of `cases`: exact budgets, `kernel` launched n_layer x
    decode steps, K1 n_layer x prefill dispatches and nothing else; returns
    each decode kernel's launches and each engine's tokens/s."""
    cfg = model.cfg
    launches, rates = {}, {}
    for name, qdt, impl, kernel in cases:
        r = _burst(seed, tag, model, max_len=max_len, kv_quant_dtype=qdt,
                   decode_fn=functools.partial(decode_step, attn_impl=impl))
        want = cfg.n_layer * r["steps"]
        got = r["launches"][kernel]
        others = {k: v for k, v in r["launches"].items() if k not in (kernel, "flash_fwd") and v}
        if got != want or others:
            raise AssertionError(f"[{tag}] {name}/{impl}: {kernel} launched {got} times, want {cfg.n_layer} x "
                                 f"{r['steps']} = {want}; other kernels {others}")
        launches[kernel] = got
        rates[f"{name} {impl}"] = r["tokens_s"]
        say(f"[{tag}] {name} cache, attn_impl={impl}: 16/16 requests finished with their exact budgets; {kernel} "
            f"launches {got} = {cfg.n_layer} layers x {r['steps']} decode steps, flash_fwd "
            f"{r['launches']['flash_fwd']} = {cfg.n_layer} x {r['dispatches']} prefill dispatches")
        say(f"[{tag}] {smi} | {name} cache, {impl}: {r['tokens_s']:.1f} tokens/s, TTFT p50 {r['p50'] * 1e3:.1f} ms "
            f"p95 {r['p95'] * 1e3:.1f} ms ({base_label}: {base['tokens_s']:.1f} tokens/s, "
            f"p50 {base['p50'] * 1e3:.1f} ms, p95 {base['p95'] * 1e3:.1f} ms)")
    return launches, rates


def _chunk_count(n: int, chunk: int, max_len: int) -> int:
    """Chunks the engine runs for an n-token prompt (none up to `chunk`
    tokens, which are prefilled whole), the final chunk shifted back to
    end at max_len when it would cross it."""
    if n <= chunk:
        return 0
    pos = count = 0
    while pos < n:
        start = min(pos, max_len - chunk)
        pos = start + min(chunk, n - start)
        count += 1
    return count


def _rates(r: dict) -> str:
    return f"{r['tokens_s']:.1f} tokens/s, TTFT p50 {r['p50'] * 1e3:.1f} ms p95 {r['p95'] * 1e3:.1f} ms"


def _fp32_gpt2(seed: int) -> GPT:
    """fp32 GPT-2 124M with GPT-2's init, for the greedy checks.  Its top-2
    logit gaps (printed by _min_top2_gap) sit far above the 1e-5 that
    separates two orders of summation.  The CPU tests' weights x25 are
    not used at this depth: over 12 layers they make the forward chaotic,
    and two summation orders of the same prompt then pick different
    tokens."""
    return GPT(dataclasses.replace(GPT2_124M, dtype=torch.float32), generator=torch.Generator().manual_seed(seed),
               device="cuda")


def _min_top2_gap(model: GPT, prompts: list[list[int]], outputs: list[list[int]]) -> float:
    """The smallest top-2 logit gap over the greedy tokens of `outputs`, from
    a full forward of each prompt and its output."""
    gaps = []
    with torch.no_grad():
        for p, out in zip(prompts, outputs):
            logits = model(torch.as_tensor([p + out[:-1]], device="cuda"))[0, len(p) - 1:].float()
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).min().item())
    return min(gaps)


def _greedy_outputs(model: GPT, prompts: list[list[int]], budget: int, **engine_kw) -> tuple[list, dict]:
    eng = InferenceEngine(model, slots=4, max_len=1024, scan_steps=8, device="cuda", **engine_kw)
    uids = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    by_uid = {r.uid: r.output for r in eng.run()}
    return [by_uid[u] for u in uids], eng.stats


CHUNK = 256


def phase_serving_chunked(seed: int, model: GPT, base: dict, smi: str) -> int:
    """The serving burst with chunk_prefill=256: exact budgets, the chunk
    count of the prompt lengths, K1 launched n_layer x whole-prompt
    dispatches only; one 256-token chunk's wall ms through the 12 layers
    and the dense offset attention's ms a layer.  Then fp32 GPT-2 124M: a
    900-token prompt in chunks of 256 against `prefill` (final logits and
    cache rows 1e-3), and greedy outputs of 4 prompts with and without
    chunking equal.  Returns K1's launches in the burst."""
    cfg = model.cfg
    tag = "serving-chunked"
    r = _burst(seed, tag, model, chunk_prefill=CHUNK)
    want = sum(_chunk_count(n, CHUNK, 1024) for n in r["lengths"])
    chunked = sum(n > CHUNK for n in r["lengths"])
    got = r["stats"].get("prefill_chunks", 0)
    if got != want or r["dispatches"] + chunked > 16:
        raise AssertionError(f"[{tag}] {got} chunks, want {want} for prompt lengths {r['lengths']}")
    say(f"[{tag}] 16/16 requests finished with their exact budgets; {got} chunks of {CHUNK} for the {chunked} "
        f"prompts over {CHUNK} tokens (as their lengths give); flash_fwd launches {r['launches']['flash_fwd']} = "
        f"{cfg.n_layer} layers x {r['dispatches']} whole-prompt dispatches")
    say(f"[{tag}] {smi} | chunk_prefill={CHUNK}: {_rates(r)}, decode steps {r['steps']} (no chunking, from "
        f"[serving]: {_rates(base)}, decode steps {base['steps']})")
    # one chunk at start 512 of a 1024-row slot: wall ms (host clock around
    # the call and a sync), and the offset attention alone (CUDA events)
    cache = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, CHUNK), device="cuda")
    walls = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_chunk(model, toks, cache, 0, 512)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q = torch.randn(1, cfg.n_head, CHUNK, cfg.head_dim, device="cuda", dtype=cfg.dtype)
    attn_call = time_ms(lambda: MR._chunk_attention(q, cache, 0, 0, 512))
    starts = torch.full((1,), 512, device="cuda")
    attn_dev = graph_ms(lambda: MR._offset_attention(q, cache.k[0][:, :1], cache.v[0][:, :1], None, None, starts))
    say(f"[{tag}] {smi} | one {CHUNK}-token chunk at position 512 through {cfg.n_layer} layers: "
        f"{statistics.median(walls[2:]):.3f} ms wall (median of 10); its dense offset attention a layer "
        f"{attn_dev:.4f} ms of device time (CUDA graph), {attn_call:.4f} ms a call with the host's enqueue (CUDA "
        f"events); it upcasts the slot's 1024 rows")

    fp32 = _fp32_gpt2(seed + 1)
    prompt = torch.as_tensor(np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, 900), device="cuda")
    _reset_launches()
    whole = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=torch.float32, device="cuda")
    chunks = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=torch.float32, device="cuda")
    _, ref = prefill(fp32, prompt, whole, 0)
    for start in range(0, 900, CHUNK):
        valid = min(CHUNK, 900 - start)
        piece = torch.full((CHUNK,), int(prompt[-1]), device="cuda", dtype=prompt.dtype)
        piece[:valid] = prompt[start:start + valid]
        _, logits = prefill_chunk(fp32, piece, chunks, 0, start, valid)
    e_logits = (logits - ref).abs().max().item()
    e_rows = max((chunks.k[..., :900, :] - whole.k[..., :900, :]).abs().max().item(),
                 (chunks.v[..., :900, :] - whole.v[..., :900, :]).abs().max().item())
    lengths_ok = int(chunks.lengths[0]) == int(whole.lengths[0]) == 900
    del whole, chunks
    rng = np.random.default_rng(seed + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (900, 600, 300, 40)]
    plain, _ = _greedy_outputs(fp32, prompts, 16)
    chunked_out, stats = _greedy_outputs(fp32, prompts, 16, chunk_prefill=CHUNK)
    gap = _min_top2_gap(fp32, prompts, plain)
    del fp32
    torch.cuda.empty_cache()
    # K1 in fp32 runs the 3xTF32 kernel: whole-prompt prefills (the 900-token
    # reference, the 4 plain prompts, the chunked run's prompt of 40)
    k1, k1_16 = FA.KERNEL_LAUNCHES["flash_fwd_fp32"], FA.KERNEL_LAUNCHES["flash_fwd"]
    say(f"[{tag}] fp32 checks: flash_fwd_fp32 launches {k1}, flash_fwd {k1_16}")
    if k1 <= 0 or k1_16:
        raise AssertionError(f"[{tag}] the fp32 checks launched flash_fwd_fp32 {k1} and flash_fwd {k1_16} times")
    ok = e_logits <= 1e-3 and e_rows <= 1e-3 and lengths_ok and plain == chunked_out
    say(f"[{tag}] fp32 GPT-2 124M, a 900-token prompt in chunks of {CHUNK} vs prefill: final logits {e_logits:.3e}, "
        f"cache rows {e_rows:.3e} (atol 1e-3), lengths {'equal' if lengths_ok else 'DIFFER'}; 4 prompts "
        f"(900/600/300/40) x 16 greedy tokens with and without chunking ({stats.get('prefill_chunks', 0)} chunks): "
        f"{'equal' if plain == chunked_out else 'DIFFER'} (smallest top-2 logit gap {gap:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] chunked prefill disagrees with whole-prompt prefill")
    return r["launches"]["flash_fwd"]


def _truncated(model: GPT, n_layer: int) -> GPT:
    """A draft: `model`'s first n_layer blocks, sharing its embeddings, its
    final LayerNorm and its tied head."""
    draft = GPT(dataclasses.replace(model.cfg, n_layer=n_layer, vocab_size=1, block_size=1), device="cuda")
    draft.cfg = dataclasses.replace(model.cfg, n_layer=n_layer)
    draft.blocks = torch.nn.ModuleList(list(model.blocks)[:n_layer])
    draft.wte, draft.wpe, draft.lnf = model.wte, model.wpe, model.lnf
    return draft


class _Acceptance:
    """Records the tokens each speculative iteration emits for its active
    slots, by wrapping the engine module's speculative_decode_loop."""

    def __init__(self):
        self.counts = []

    def __enter__(self):
        self.inner = ENG.speculative_decode_loop

        def loop(*args, active=None, **kw):
            out = self.inner(*args, active=active, **kw)
            self.counts.append(out[3][:, active].flatten())
            return out

        ENG.speculative_decode_loop = loop
        return self

    def __exit__(self, *exc):
        ENG.speculative_decode_loop = self.inner

    def mean(self) -> float:
        return torch.cat(self.counts).float().mean().item() if self.counts else float("nan")


def phase_serving_spec(seed: int, model: GPT, base: dict, smi: str) -> dict:
    """The serving burst with speculative decoding (greedy requests; the
    sampled half takes the regular scan), spec_k 4: (a) the target drafting
    for itself, (b) a 2-layer draft (the target's first two blocks, its
    embeddings and head) with spec_adaptive.  Exact budgets, ids in range,
    K1 launched n_layer x target prefill dispatches + draft layers x draft
    prefill and resync dispatches; acceptance, the retreat and trials.
    Then fp32 GPT-2 124M: verify_step logits against chained decode_step
    logits (1e-3); draft (b) without spec_adaptive gives the plain
    engine's greedy outputs for 4 prompts x 32 tokens, and the
    target drafting for itself accepts every proposal.  Returns K1's
    launches in each burst."""
    cfg = model.cfg
    tag = "serving-spec"
    launches = {}
    drafts = (("self-draft", model, {}), ("2-layer draft", _truncated(model, 2), dict(spec_adaptive=True)))
    for name, draft, kw in drafts:
        with _Acceptance() as acc:
            r = _burst(seed, tag, model, draft_model=draft, **kw)
        st = r["stats"]
        if not st.get("spec_rounds"):
            raise AssertionError(f"[{tag}] {name}: no speculative round ran")
        launches[name] = r["launches"]["flash_fwd"]
        say(f"[{tag}] {name} ({draft.cfg.n_layer} layers{', spec_adaptive' if kw else ''}): 16/16 requests finished "
            f"with their exact budgets, ids in range; flash_fwd launches {r['launches']['flash_fwd']} = "
            f"{cfg.n_layer} x {r['dispatches']} prefill dispatches + {draft.cfg.n_layer} x "
            f"{st.get('draft_dispatches', 0)} draft dispatches ({st.get('draft_prefills', 0)} at admission, "
            f"{st.get('draft_resyncs', 0)} slots resynced)")
        say(f"[{tag}] {smi} | {name}: {_rates(r)}; spec rounds {st['spec_rounds']}, tokens a speculative iteration "
            f"{acc.mean():.3f} of {4 + 1}, EMA {st.get('spec_accept_ema', 'n/a')}, retreat at round "
            f"{st.get('spec_disabled_at_round', 'none')}, trials {st.get('spec_trials', 0)}, re-opened at round "
            f"{st.get('spec_reopened_at_round', 'none')}, regular scans {r['scans']} (no draft, from [serving]: "
            f"{_rates(base)})")

    fp32 = _fp32_gpt2(seed + 1)
    rng = np.random.default_rng(seed + 5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 300), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, 5), device="cuda", dtype=torch.int32)
    caches = [init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=torch.float32, device="cuda")
              for _ in range(2)]
    for c in caches:
        prefill(fp32, prompt, c, 0)
    _, verified = verify_step(fp32, feed[None], caches[0])
    e_verify = max((decode_step(fp32, feed[i:i + 1], caches[1])[1][0] - verified[0, i]).abs().max().item()
                   for i in range(5))
    del caches
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (700, 300, 120, 30)]
    plain, _ = _greedy_outputs(fp32, prompts, 32)
    spec, st = _greedy_outputs(fp32, prompts, 32, draft_model=_truncated(fp32, 2))
    gap = _min_top2_gap(fp32, prompts, plain)
    ct = init_cache(cfg.n_layer, 2, cfg.kv_heads, 1024, cfg.head_dim, dtype=torch.float32, device="cuda")
    cd = init_cache(cfg.n_layer, 2, cfg.kv_heads, 1024, cfg.head_dim, dtype=torch.float32, device="cuda")
    firsts = []
    for slot, p in enumerate(prompts[2:]):
        firsts.append(int(prefill(fp32, torch.as_tensor(p, device="cuda"), ct, slot)[1].argmax()))
        prefill(fp32, torch.as_tensor(p, device="cuda"), cd, slot)
    _, _, _, counts = speculative_decode_loop(fp32, ct, fp32, cd, torch.tensor(firsts, device="cuda"), 4, k=4)
    self_all = bool((counts == 5).all())
    del fp32, ct, cd
    torch.cuda.empty_cache()
    ok = e_verify <= 1e-3 and plain == spec and self_all
    say(f"[{tag}] fp32 GPT-2 124M: verify_step logits of 5 rows vs 5 chained decode steps {e_verify:.3e} (atol "
        f"1e-3); 4 prompts x 32 greedy tokens with the 2-layer draft ({st['spec_rounds']} spec rounds) vs the plain "
        f"engine: {'equal' if plain == spec else 'DIFFER'} (smallest top-2 logit gap {gap:.2e}); the target "
        f"drafting for itself, 4 iterations of window 4 on 2 slots: counts {counts.flatten().tolist()} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] speculative decoding disagrees with greedy decoding")
    return launches


def phase_serving_pipelined(seed: int, model: GPT, base: dict, smi: str) -> dict:
    """The serving burst with pipeline_scans=True, then also with
    scan_tokens_target=64: exact budgets, every regular scan pipelined.
    Returns K1's launches in each burst."""
    tag = "serving-pipelined"
    launches = {}
    for name, kw in (("pipeline_scans", dict(pipeline_scans=True)),
                     ("pipeline_scans + scan_tokens_target=64", dict(pipeline_scans=True, scan_tokens_target=64))):
        r = _burst(seed, tag, model, **kw)
        piped = r["stats"].get("pipelined_scans", 0)
        if piped <= 0 or piped != r["scans"]:
            raise AssertionError(f"[{tag}] {name}: {piped} of {r['scans']} scans pipelined")
        launches[name] = r["launches"]["flash_fwd"]
        say(f"[{tag}] {smi} | {name}: 16/16 requests finished with their exact budgets; {_rates(r)}, {r['scans']} "
            f"scans (all pipelined), decode steps {r['steps']} (synchronous, from [serving]: {_rates(base)}, "
            f"{base['scans']} scans, decode steps {base['steps']})")
    return launches


def phase_parity(seed: int) -> int:
    """fp32 GPT-2 124M: prefill logits and 8 teacher-forced decode steps
    against the model's forward on dense attention.  The prefill runs the
    3xTF32 K1 ("flash_fwd_fp32", one a layer), never the 16-bit one;
    returns its launches."""
    cfg = dataclasses.replace(GPT2_124M, dtype=torch.float32)
    model = GPT(cfg, generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    dense = GPT(dataclasses.replace(cfg, use_flash=False), generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    rng = np.random.default_rng(seed + 1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 300), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, 8), device="cuda", dtype=torch.int32)
    _reset_launches()
    with torch.no_grad():
        ref = dense(torch.cat([prompt, feed.long()])[None])[0].float()  # [308, vocab]
        cache = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
        cache, logits = prefill(model, prompt, cache, 0)
        errs = [(logits - ref[prompt.numel() - 1]).abs().max().item()]
        for i in range(8):
            cache, logits = decode_step(model, feed[i:i + 1], cache)
            errs.append((logits[0] - ref[prompt.numel() + i]).abs().max().item())
    torch.cuda.synchronize()
    worst = max(errs)
    k1 = FA.KERNEL_LAUNCHES["flash_fwd_fp32"]
    say(f"[parity] fp32 GPT-2 124M, prompt 300 + 8 teacher-forced decode steps vs forward on dense attention: "
        f"max abs logit error {worst:.3e} (prefill {errs[0]:.3e}) atol 1e-3 {'ok' if worst <= 1e-3 else 'FAIL'}; "
        f"flash_fwd_fp32 launches {k1} (want {cfg.n_layer}), flash_fwd {FA.KERNEL_LAUNCHES['flash_fwd']}")
    if worst > 1e-3:
        raise AssertionError("[parity] outside tolerance")
    if k1 != cfg.n_layer or FA.KERNEL_LAUNCHES["flash_fwd"]:
        raise AssertionError(f"[parity] the fp32 prefill launched flash_fwd_fp32 {k1} times (want {cfg.n_layer}) "
                             f"and flash_fwd {FA.KERNEL_LAUNCHES['flash_fwd']} (want 0)")
    return k1


def phase_parity_quant(seed: int) -> None:
    """fp32 GPT-2 124M with an int8 cache: 8 teacher-forced decode steps on
    each decode path; paged and fused against einsum on the same cache
    contents (each path fills its own cache with the same prompt and feed)."""
    cfg = dataclasses.replace(GPT2_124M, dtype=torch.float32)
    model = GPT(cfg, generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    dense = GPT(dataclasses.replace(cfg, use_flash=False), generator=torch.Generator().manual_seed(seed + 1), device="cuda")
    rng = np.random.default_rng(seed + 1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 300), device="cuda")
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, 8), device="cuda", dtype=torch.int32)
    with torch.no_grad():
        ref = dense(torch.cat([prompt, feed.long()])[None])[0].float()
    errs, logits = _impl_parity(model, [prompt], feed[:, None], torch.int8)
    qerr = max((lg[0] - ref[prompt.numel() + i]).abs().max().item() for i, lg in enumerate(logits))
    worst = max(errs.values())
    say(f"[parity-quant] fp32 GPT-2 124M, int8 cache, prompt 300 + 8 teacher-forced decode steps: paged vs einsum "
        f"{errs['paged']:.3e}, fused vs einsum {errs['fused']:.3e} (atol 1e-3) {'ok' if worst <= 1e-3 else 'FAIL'}; "
        f"int8 quantization error vs the unquantized dense forward: {qerr:.3e}")
    if worst > 1e-3:
        raise AssertionError("[parity-quant] outside tolerance")


def _impl_parity(model: GPT, prompts: list, feed: torch.Tensor, quant_dtype=None,
                 max_len: int = 1024) -> tuple[dict, list]:
    """Teacher-forced decode steps of `feed` [steps, slots] after `prompts`
    (one a slot) on each decode path, each filling a cache of its own
    (`quant_dtype` payloads, or the model's dtype; max_len tokens a slot)
    with the same tokens: returns the paged and fused paths' max |logit -
    einsum's| and einsum's logits [slots, vocab] a step."""
    cfg = model.cfg
    impls = ("einsum", "paged", "fused")
    errs = {impl: 0.0 for impl in impls[1:]}
    steps = []
    with torch.no_grad():
        caches = {}
        for impl in impls:
            caches[impl] = init_cache(cfg.n_layer, len(prompts), cfg.kv_heads, max_len, cfg.head_dim, dtype=cfg.dtype,
                                      quant_dtype=quant_dtype, device="cuda")
            for slot, prompt in enumerate(prompts):
                prefill(model, prompt, caches[impl], slot)
        for i in range(feed.shape[0]):
            logits = {impl: decode_step(model, feed[i], caches[impl], attn_impl=impl)[1] for impl in impls}
            for impl in impls[1:]:
                errs[impl] = max(errs[impl], (logits[impl].float() - logits["einsum"].float()).abs().max().item())
            steps.append(logits["einsum"].float())
    torch.cuda.synchronize()
    return errs, steps


# SantaCoder (bigcode/gpt_bigcode-santacoder's config.json: GPT-2's
# architecture with multi_query, n_embd 2048, n_head 16, n_layer 24,
# n_positions 2048, vocab 49280): one KV head of 128 for 16 q heads
SANTACODER = dict(vocab_size=49280, block_size=2048, n_layer=24, n_head=16, n_embd=2048, n_kv_head=1)


def _check_impl_parity(tag: str, label: str, model: GPT, seed: int, caches, prompt_lens=(300,),
                       max_len: int = 1024, keys=("paged_decode", "fused_decode")) -> dict:
    """paged and fused logits within 1e-3 of einsum's over 8 teacher-forced
    decode steps after prompts of `prompt_lens` tokens (one a slot, in a
    cache of max_len tokens a slot), for each cache of `caches` ((name,
    quant_dtype or None), fp32 model); the counts set to 0 first, each of
    `keys` (K5's and K6's launch keys for the model) must launch.  Returns
    their launches."""
    rng = np.random.default_rng(seed + 12)
    prompts = [torch.as_tensor(rng.integers(0, model.cfg.vocab_size, n), device="cuda") for n in prompt_lens]
    feed = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (8, len(prompts))), device="cuda",
                           dtype=torch.int32)
    _reset_launches()
    for name, qdt in caches:
        errs, _ = _impl_parity(model, prompts, feed, qdt, max_len)
        worst = max(errs.values())
        say(f"[{tag}] {label}, {name} cache, {len(prompts)} slots of {max_len}, prompts {list(prompt_lens)} + 8 "
            f"teacher-forced decode steps: paged vs einsum "
            f"{errs['paged']:.3e}, fused vs einsum {errs['fused']:.3e} (atol 1e-3) {'ok' if worst <= 1e-3 else 'FAIL'}")
        if worst > 1e-3:
            raise AssertionError(f"[{tag}] {name} cache: paged/fused logits outside 1e-3 of einsum")
    launched = {key: FA.KERNEL_LAUNCHES[key] for key in keys}
    say(f"[{tag}] {label}: launches {launched}")
    if not all(launched.values()):
        raise AssertionError(f"[{tag}] the fp32 check launched none of a key: {launched}")
    return launched


def phase_serving_mqa(seed: int, smi: str) -> dict:
    """Multi-query serving at SantaCoder's published widths (24 layers, 16 q
    heads on one KV head of 128, vocab 49280), bf16 weights drawn on the
    card from the seed, behind the engine (8 slots, max_len 2048): the
    burst on a bf16 cache through einsum, through K5 on a bf16 cache and
    through K6 on an int8 cache (a group of 16 with bf16 q: the whole-group
    kernel), exact budgets, K5 / K6 launched n_layer x decode steps; then the
    fp32 check at SantaCoder's widths with 2 of its 24 layers, in the
    burst's 8 slots of 2048 with most prompts past 1024 tokens (fp32 q: the
    3xTF32 whole-group kernel, "paged_decode_group_fp32" /
    "fused_decode_group_fp32").  Returns the whole-group K5's and K6's
    launches (bf16 in the bursts, fp32 in the check)."""
    tag = "serving-mqa"
    t0 = time.perf_counter()
    model = GPT(GPTConfig(**SANTACODER), generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] SantaCoder widths: {cfg.n_layer} layers, {cfg.n_head} q heads on {cfg.kv_heads} KV head of "
        f"{cfg.head_dim}, width {cfg.n_embd}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.3f} B random "
        f"parameters drawn on the card (seed {seed}) in {time.perf_counter() - t0:.1f} s")
    base = _burst(seed, tag, model, max_len=2048)
    say(f"[{tag}] bf16 cache, einsum: {_rates(base)}, decode steps {base['steps']}")
    launches, _ = _decode_bursts(seed, tag, model, base, smi, (("bf16", None, "paged", "paged_decode_group"),
                                                               ("int8", torch.int8, "fused", "fused_decode_group")),
                                 max_len=2048, base_label="bf16 cache, einsum")
    del model
    fp32 = GPT(GPTConfig(**{**SANTACODER, "n_layer": 2, "dtype": torch.float32}),
               generator=torch.Generator("cuda").manual_seed(seed + 1), device="cuda")
    launches.update(_check_impl_parity(tag, "fp32 SantaCoder widths, 2 layers", fp32, seed,
                                       (("fp32", None), ("int8", torch.int8)),
                                       prompt_lens=(2030, 1900, 1500, 1100, 1030, 700, 300, 16), max_len=2048,
                                       keys=("paged_decode_group_fp32", "fused_decode_group_fp32")))
    return launches


# Phi-2 (microsoft/phi-2's config.json: hidden_size 2560, num_attention_heads
# 32, num_hidden_layers 32, vocab_size 51200, max_position_embeddings 2048,
# intermediate_size 10240, 4 x 2560): heads of 80, which the decode kernels
# run inside their D128 instantiations.  Its partial rotary and parallel
# block are not the repo's GPT; its widths are what this path needs.
PHI2 = dict(vocab_size=51200, block_size=2048, n_layer=32, n_head=32, n_embd=2560)


def phase_serving_phi2(seed: int, smi: str) -> tuple[dict, dict]:
    """Serving at Phi-2's published widths (32 layers, 32 heads of 80, width
    2560, vocab 51200), bf16 weights drawn on the card from the seed, behind
    the engine (8 slots, max_len 2048): the burst on a bf16 cache through
    einsum, through K5 on an int8 cache and through K6 on an fp8 cache (head
    dim 80 in the split-KV kernel's D128), exact budgets, K5 / K6 launched
    n_layer x decode steps; then the fp32 check at Phi-2's widths with 2 of
    its 32 layers, in the burst's 8 slots of 2048 with most prompts past 1024
    tokens.  Returns K5's and K6's launches in the bursts and in the check."""
    tag = "serving-phi2"
    t0 = time.perf_counter()
    model = GPT(GPTConfig(**PHI2), generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[{tag}] Phi-2 widths: {cfg.n_layer} layers, {cfg.n_head} heads of {cfg.head_dim} (the decode kernels' "
        f"D{PA.decode_width(cfg.head_dim)}), width {cfg.n_embd}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{n_params / 1e9:.3f} B random parameters drawn on the card (seed {seed}) in {time.perf_counter() - t0:.1f} s")
    base = _burst(seed, tag, model, max_len=2048)
    say(f"[{tag}] {smi} | bf16 cache, einsum: {_rates(base)}, decode steps {base['steps']}")
    launches, _ = _decode_bursts(seed, tag, model, base, smi, (("int8", torch.int8, "paged", "paged_decode"),
                                                               ("fp8", torch.float8_e4m3fn, "fused", "fused_decode")),
                                 max_len=2048, base_label="bf16 cache, einsum")
    del model
    fp32 = GPT(GPTConfig(**{**PHI2, "n_layer": 2, "dtype": torch.float32}),
               generator=torch.Generator("cuda").manual_seed(seed + 1), device="cuda")
    checked = _check_impl_parity(tag, "fp32 Phi-2 widths, 2 layers", fp32, seed, (("fp32", None), ("int8", torch.int8)),
                                 prompt_lens=(2030, 1900, 1500, 1100, 1030, 700, 300, 16), max_len=2048)
    say(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    return launches, checked


def phase_serving_fp16(seed: int, smi: str) -> dict:
    """GPT-2 124M in fp16 (weights, activations and cache) behind the engine:
    the burst through einsum, through K5 on an fp16 cache and through K6 on
    an fp8 cache (fp16 q), exact budgets, K5 / K6 launched n_layer x decode
    steps; paged / fused logits against einsum's in fp16 printed; then the
    fp32 check (fp32 GPT-2 124M on fp32 and fp8 caches).  Returns K5's and
    K6's launches."""
    tag = "serving-fp16"
    model = GPT(dataclasses.replace(GPT2_124M, dtype=torch.float16), generator=torch.Generator().manual_seed(seed),
                device="cuda")
    base = _burst(seed, tag, model)
    say(f"[{tag}] GPT-2 124M fp16, fp16 cache, einsum: {_rates(base)}, decode steps {base['steps']}")
    launches, _ = _decode_bursts(seed, tag, model, base, smi, (("fp16", None, "paged", "paged_decode"),
                                                               ("fp8", torch.float8_e4m3fn, "fused", "fused_decode")),
                                 base_label="fp16 cache, einsum")
    rng = np.random.default_rng(seed + 13)
    prompt = torch.as_tensor(rng.integers(0, GPT2_124M.vocab_size, 300), device="cuda")
    feed = torch.as_tensor(rng.integers(0, GPT2_124M.vocab_size, 8), device="cuda", dtype=torch.int32)
    errs, steps = _impl_parity(model, [prompt], feed[:, None])
    scale = max(lg.abs().max().item() for lg in steps)
    ok = max(errs.values()) <= 2e-2 * max(scale, 1.0)
    say(f"[{tag}] fp16 model and cache, prompt 300 + 8 teacher-forced decode steps: paged vs einsum "
        f"{errs['paged']:.3e}, fused vs einsum {errs['fused']:.3e} (max |logit| {scale:.2f}; 16-bit tier, 2e-2 "
        f"relative) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] fp16 paged/fused logits outside the 16-bit tier of einsum's")
    del model
    fp32 = GPT(dataclasses.replace(GPT2_124M, dtype=torch.float32), generator=torch.Generator().manual_seed(seed + 1),
               device="cuda")
    _check_impl_parity(tag, "fp32 GPT-2 124M", fp32, seed, (("fp32", None), ("fp8", torch.float8_e4m3fn)))
    return launches


def phase_training(seed: int, smi: str, data: np.ndarray) -> dict:
    """GPT-2 124M through the port's Trainer: returns the kernels' launch
    counts over the run."""
    cfg = GPT2_124M  # bf16 compute, dropout 0; Trainer keeps fp32 master weights
    steps, batch, seq = 20, 8, 1024
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=5)
    trainer = Trainer(cfg, tcfg, seed=seed, device="cuda")
    batches = batch_iterator(data, batch, seq, seed=seed, device="cuda")
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    history = trainer.fit(batches, log=lambda line: None)
    torch.cuda.synchronize()
    launches = dict(FA.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["train_loss"] for r in history]
    say(f"[training] GPT-2 124M {cfg.dtype} compute, fp32 master weights, vocab {cfg.vocab_size}, "
        f"{cfg.n_layer} layers; synthetic_corpus char ids at b{batch} x T{seq}, {steps} steps, lr 6e-4, warmup 5")
    say(f"[training] losses {' '.join(f'{x:.3f}' for x in losses)}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[training] {len(losses)} losses, not all finite")
    last5 = float(np.mean(losses[-5:]))
    ok = last5 < losses[0] - 1.0
    say(f"[training] mean of the last 5 losses {last5:.3f} vs first {losses[0]:.3f} - 1.0 nat: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[training] loss did not fall by more than 1 nat")
    want = cfg.n_layer * steps
    for key in TRAINING_KERNELS:
        if launches[key] != want:
            raise AssertionError(f"[training] {key} launched {launches[key]} times, want {cfg.n_layer} x {steps} = {want}")
    say(f"[training] launches { {k: launches[k] for k in TRAINING_KERNELS} } = {cfg.n_layer} layers x {steps} steps each")
    step_ms = np.diff([0.0] + [r["wall_s"] for r in history]) * 1e3
    med = float(np.median(step_ms[5:]))
    say(f"[training] {smi} | step {med:.2f} ms (median of steps 6-{steps}), {batch * seq / med * 1e3:.0f} tokens/s, "
        f"peak allocated {peak / 2**30:.2f} GiB")
    _trace_steps(trainer, batches, smi, med)
    return launches


def _trace_steps(trainer: Trainer, batches, smi: str, step_ms: float, steps: int = 3) -> dict:
    """torch.profiler over `steps` more training steps (the run before is
    the warm-up): device-busy ms a step (the union of the device's kernel
    and copy intervals), that time by kind of kernel, and the idle share of
    the untraced median step `step_ms` (the profiler's own host time
    lengthens the traced steps' wall time, printed beside it).  Prints them
    and returns them (an empty dict when no device event was recorded)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.tcfg.max_iters = trainer.step + steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(batches, log=lambda line: None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    found = device_time(prof, steps)
    if found is None:
        say(f"[training] trace: torch.profiler recorded no device events over {steps} steps ({wall:.2f} ms a step)")
        return {}
    busy_ms, kinds, top = found
    say(f"[training] {smi} | trace of {steps} steps after {trainer.step - steps}: device busy {busy_ms:.2f} ms a "
        f"step, idle share {1 - busy_ms / step_ms:.1%} of the untraced median step {step_ms:.2f} ms (traced wall "
        f"{wall:.2f} ms a step); by kind, ms a step: " + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items()))
    say("[training] trace: longest kernels, ms a step: " + "; ".join(
        f"{name[:60]} {ms:.3f}" for name, ms in sorted(top.items(), key=lambda x: -x[1])[:8]))
    return dict(device_busy_ms=busy_ms, idle_share=1 - busy_ms / step_ms, traced_wall_ms=wall,
                kernel_ms_by_kind=kinds)


def phase_train_parity(seed: int, data: np.ndarray) -> dict:
    """fp32 GPT-2 124M trained 5 steps with flash attention and with dense
    attention from the same weights and batches; the losses must agree.
    The flash run is the fp32 training path: returns the launches of the
    3xTF32 K1, K2 and K3 in it (one each a layer a step)."""
    cfg = dataclasses.replace(GPT2_124M, dtype=torch.float32)
    steps = 5
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=2)
    curves = {}
    for flash in (True, False):
        trainer = Trainer(dataclasses.replace(cfg, use_flash=flash), tcfg, seed=seed + 4, device="cuda")
        _reset_launches()
        history = trainer.fit(batch_iterator(data, 2, 512, seed=seed + 4, device="cuda"), log=lambda line: None)
        torch.cuda.synchronize()
        if flash:
            launches = {key: FA.KERNEL_LAUNCHES[key] for key in ("flash_fwd_fp32", *FP32_BWD_KERNELS)}
            sixteen = FA.KERNEL_LAUNCHES["flash_fwd"]
        curves[flash] = np.array([r["train_loss"] for r in history])
        del trainer
    want = cfg.n_layer * steps
    say(f"[train-parity] launches of the fp32 K1 / K2 / K3 in the flash run {launches} (want {cfg.n_layer} layers x "
        f"{steps} steps = {want} each), flash_fwd {sixteen}")
    if any(n != want for n in launches.values()) or sixteen:
        raise AssertionError(f"[train-parity] fp32 K1 / K2 / K3 launched {launches}, want {want} each, and flash_fwd "
                             f"{sixteen}, want 0")
    flash, dense = curves[True], curves[False]
    excess = np.abs(flash - dense) - (2e-3 + 2e-3 * np.abs(dense))
    ok = len(flash) == 5 and bool((excess <= 0).all())
    say(f"[train-parity] fp32 GPT-2 124M b2 x T512, 5 steps from the same weights and batches: flash "
        f"{' '.join(f'{x:.5f}' for x in flash)} vs dense {' '.join(f'{x:.5f}' for x in dense)}; "
        f"max |diff| {np.abs(flash - dense).max():.2e} (atol 2e-3 + rtol 2e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[train-parity] flash and dense losses disagree")
    return launches


def _grad_fn(attn, q, k, v, do):
    """A call that runs only the backward of `attn(q, k, v)` with cotangent
    `do`.  The forward runs once, at the first call, on the stream that
    makes it (graph_ms's side stream), so that the backward, which autograd
    runs on the forward's stream, can be captured there."""
    inputs = tuple(t.detach().requires_grad_() for t in (q, k, v))
    out = []

    def run():
        if not out:
            out.append(attn(*inputs))
        return torch.autograd.grad(out[0], inputs, do, retain_graph=True)

    return run


def phase_timing(seed: int, smi: str) -> dict:
    """K1, the backward's pre-pass, K2 and K3 against their plain versions
    and torch's one call for the same function (SDPA forward / backward) at
    GPT-2 shapes, as device time (graph_ms) and, for the kernels, as a call
    costs its caller (time_ms); returns {kernel: row} at b8 D64, a row
    holding the device ms, the plain version's device ms, the bound and the
    library call's device ms."""
    gen = torch.Generator().manual_seed(seed + 2)
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    result = {}
    for b, d in ((1, 64), (8, 64), (8, 128)):
        q, k, v, do = (_rand(gen, (b, 12, 1024, d), torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        elems = b * 12 * 1024 * d  # one [b, 12, 1024, d] tensor
        rows = b * 12 * 1024  # one fp32 [b, 12, 1024] row statistic has rows * 4 bytes
        flops = 4 * b * 12 * 1024 * 1024 * d / 2  # causal half of QK^T and PV
        if d == 64:
            with torch.no_grad():
                kern = time_ms(lambda: FA.flash_attention(q, k, v))
                kern_dev = graph_ms(lambda: FA.flash_attention(q, k, v))
                plain = time_ms(lambda: FA.flash_attention_reference(q, k, v))
                plain_dev = graph_ms(lambda: FA.flash_attention_reference(q, k, v), calls=2, runs=5)
                dense = time_ms(lambda: vanilla_attention_with_lse(q, k, v, sm_scale=scale))
                sdpa_dev = graph_ms(lambda: sdpa(q, k, v))
            bound, by = floor_ms(4 * elems * 2, flops)  # q, k, v read, o written
            say(f"[timing] {smi} | K1 b{b} h12 L1024 D64 bf16 causal: kernel {kern_dev:.4f} ms on the device "
                f"({flops / kern_dev / 1e9:.1f} TFLOP/s, {bound / kern_dev:.1%} of the bound {bound:.4f} ms, "
                f"{by}), {kern:.4f} ms a call; plain tile loop {plain_dev:.4f} ms on the device, {plain:.4f} ms a "
                f"call; vanilla {dense:.4f} ms a call; library torch SDPA forward {sdpa_dev:.4f} ms on the device "
                f"(K1 / SDPA {kern_dev / sdpa_dev:.2f}x)")
            result["flash_fwd"] = dict(ms=kern_dev, plain_ms=plain_dev, library_ms=sdpa_dev, bound_ms=bound,
                                       bound_by=by)

        # The backward: the pre-pass, K2, K3 and the three together, their
        # plain versions, autograd of vanilla, and torch SDPA's backward as
        # the library call for the whole.
        with torch.no_grad():
            o, lse = FA.flash_attention_with_lse(q, k, v)
        spec = FA._Spec(causal=True, sm_scale=scale, window=None, blocks=FA.default_blocks(1024, 1024, d))
        args = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
        FA._launch_bwd_prep(args)
        pre = graph_ms(lambda: FA._launch_bwd_prep(args))
        k2 = graph_ms(lambda: FA._launch_bwd_dkv(args))
        k3 = graph_ms(lambda: FA._launch_bwd_dq(args))
        bwd = graph_ms(lambda: FA._launch_bwd(q, k, v, o, lse, do, None, spec, None))
        bwd_call = time_ms(lambda: FA._launch_bwd(q, k, v, o, lse, do, None, spec, None))
        with torch.no_grad():
            p1 = graph_ms(lambda: FA.flash_attention_bwd_prep_reference(q, o, do, sm_scale=scale))
            p2 = graph_ms(lambda: FA.flash_attention_bwd_dkv_reference(q, k, v, o, lse, do), calls=2, runs=5)
            p3 = graph_ms(lambda: FA.flash_attention_bwd_dq_reference(q, k, v, o, lse, do), calls=2, runs=5)
        van = time_ms(_grad_fn(lambda *t: vanilla_attention_with_lse(*t, sm_scale=scale)[0], q, k, v, do))
        sdpa_b = graph_ms(_grad_fn(sdpa, q, k, v, do))
        # The pre-pass reads q, o, dO and writes qs and di.  K2 does four
        # products of the forward's size (S, dP, dV, dK); its function needs
        # q (or qs), k, v, dO, lse, di read and dK, dV written (the kernel
        # also reads qs beside q: its choice, not counted).  K3 does three
        # (S, dP, dQ), reads qs, k, v, dO, lse, di and writes dQ.  The
        # backward as one function reads q, k, v, o, dO, lse and writes dQ,
        # dK, dV, with five products (2.5 x the forward's); its TFLOP/s and
        # SDPA's count those.
        b1, by1 = floor_ms(4 * elems * 2 + rows * 4)
        b2, by2 = floor_ms(6 * elems * 2 + 2 * rows * 4, 2 * flops)
        b3, by3 = floor_ms(5 * elems * 2 + 2 * rows * 4, 1.5 * flops)
        ball, byall = floor_ms(8 * elems * 2 + rows * 4, 2.5 * flops)
        say(f"[timing] {smi} | backward b{b} h12 L1024 D{d} bf16 causal, on the device: pre-pass {pre:.4f} ms "
            f"({(4 * elems * 2 + rows * 4) / pre / 1e6:.0f} GB/s, {b1 / pre:.1%} of the bound {b1:.4f} ms, {by1}); "
            f"K2 {k2:.4f} ms ({2 * flops / k2 / 1e9:.1f} TFLOP/s, {b2 / k2:.1%} of {b2:.4f} ms, {by2}); K3 {k3:.4f} "
            f"ms ({1.5 * flops / k3 / 1e9:.1f} TFLOP/s, {b3 / k3:.1%} of {b3:.4f} ms, {by3}); pre-pass+K2+K3 "
            f"{bwd:.4f} ms ({2.5 * flops / bwd / 1e9:.1f} TFLOP/s, {ball / bwd:.1%} of {ball:.4f} ms, {byall}; "
            f"{bwd_call:.4f} ms a call); plain pre-pass {p1:.4f} ms, dK/dV {p2:.4f} ms, dQ {p3:.4f} ms; autograd of "
            f"vanilla {van:.4f} ms a call; library torch SDPA backward {sdpa_b:.4f} ms ({2.5 * flops / sdpa_b / 1e9:.1f}"
            f" TFLOP/s, {ball / sdpa_b:.1%} of {ball:.4f} ms; pre-pass+K2+K3 / SDPA {bwd / sdpa_b:.2f}x)")
        if b == 8 and d == 64:
            result["flash_bwd_prep"] = dict(ms=pre, plain_ms=p1, bound_ms=b1, bound_by=by1, library_ms=None)
            result["flash_bwd_dkv"] = dict(ms=k2, plain_ms=p2, bound_ms=b2, bound_by=by2, library_ms=sdpa_b)
            result["flash_bwd_dq"] = dict(ms=k3, plain_ms=p3, bound_ms=b3, bound_by=by3, library_ms=sdpa_b)
    return result


def phase_timing_quant(seed: int, smi: str) -> dict:
    """K4, K5 and K6 against their plain versions, each as a call costs its
    caller (CUDA events around back-to-back calls, which includes the host's
    enqueue time where that is longer) and as device time (graph_ms);
    returns {kernel: row} at b8 (K4) and, for K5 and K6 (`time_decode` at
    every DECODE_SHAPES entry), at the 8-slot L2-hot shape on the int8
    cache, with that shape's bf16 numbers, the 12-layer L2-cold int8 ones
    and every NEW_DECODE_SHAPES row beside them.  K4 has no one library
    call for its function; torch SDPA forward on K/V already dequantized to
    bf16 is printed beside it as a yardstick of the same FLOPs, not of the
    same function.  On a 16-bit cache, SDPA with a boolean length mask over
    the slot-major cache is one call for K5's and K6's function; on an int8
    or fp8 cache there is none."""
    gen = torch.Generator().manual_seed(seed + 7)
    result = {}
    for b in (1, 8):
        q = _rand(gen, (b, 12, 1024, 64), torch.bfloat16)
        kv = QK.quantize_kv(_rand(gen, (b, 12, 1024, 64), torch.float32), _rand(gen, (b, 12, 1024, 64), torch.float32))
        k_t, v_t = QK.dequantize_kv(kv, dtype=torch.bfloat16)
        with torch.no_grad():
            kern = time_ms(lambda: QK.flash_attention_kv_quant(q, kv))
            kern_dev = graph_ms(lambda: QK.flash_attention_kv_quant(q, kv))
            plain = time_ms(lambda: QK.flash_attention_kv_quant_reference(q, kv))
            plain_dev = graph_ms(lambda: QK.flash_attention_kv_quant_reference(q, kv), calls=2, runs=5)
            sdpa_dev = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k_t, v_t, is_causal=True))
        tokens = b * 12 * 1024
        nbytes = tokens * (64 * (2 + 2 + 1 + 1) + 8)  # q, out, K and V payloads, two scales
        flops = 4 * tokens * 1024 * 64 / 2
        bound, by = floor_ms(nbytes, flops)
        say(f"[timing] {smi} | K4 b{b} h12 L1024 D64 bf16 q, int8 K/V, causal: kernel {kern_dev:.4f} ms on the "
            f"device ({flops / kern_dev / 1e9:.1f} TFLOP/s, {bound / kern_dev:.1%} of the bound {bound:.4f} ms, "
            f"{by}), {kern:.4f} ms a call; plain tile loop {plain_dev:.4f} ms on the device, {plain:.4f} ms a call; "
            f"torch SDPA forward on bf16 K/V {sdpa_dev:.4f} ms on the device, the same FLOPs but not the same "
            f"function (K4 / SDPA {kern_dev / sdpa_dev:.2f}x)")
        result["flash_fwd_kv_quant"] = dict(ms=kern_dev, plain_ms=plain_dev, bound_ms=bound, bound_by=by,
                                            library_ms=None)
    rows = {}
    for shape in DECODE_SHAPES:
        for store in shape[-1]:
            rows[shape[0], store] = time_decode(gen, smi, shape, store)
    # SantaCoder's layer with 8 q heads (one group tile) instead of 16 (two):
    # the same K/V bytes, so the difference is what the second tile costs
    one_tile = time_decode(gen, smi, ONE_TILE_SHAPE, "int8")
    hot, hot16 = rows[GPT2_HOT_SHAPE[0], "int8"], rows[GPT2_HOT_SHAPE[0], "bf16"]
    cold = rows[GPT2_COLD_SHAPE[0], "int8"]

    def add_rows(entry: dict, key: str, names) -> None:
        for name in names:
            shape = NEW_DECODE_SHAPES[name]
            for store in shape[-1]:
                row = rows[shape[0], store]
                tag = name if store == "int8" else f"{name}_{store.replace(' ', '_')}"
                entry.update({f"{tag}_ms": row[key], f"{tag}_plain_ms": row[f"{key} plain"],
                              f"{tag}_bound_ms": row["bound"], f"{tag}_library_ms": row.get("SDPA")})

    for kernel, key in (("paged_decode", "K5"), ("fused_decode", "K6")):
        result[kernel] = dict(
            ms=hot[key], plain_ms=hot[f"{key} plain"], bound_ms=hot["bound"], bound_by=hot["by"], library_ms=None,
            bf16_ms=hot16[key], bf16_plain_ms=hot16[f"{key} plain"], bf16_bound_ms=hot16["bound"],
            bf16_library_ms=hot16["SDPA"], l2_cold_ms=cold[key], l2_cold_bound_ms=cold["bound"],
        )
        add_rows(result[kernel], key, [name for name in NEW_DECODE_SHAPES
                                       if name not in GROUP_TIMED + GROUP_FP32_TIMED + WIDE_TIMED + NARROW_TIMED])
        result[kernel]["santacoder_one_tile_ms"] = one_tile[key]
    # the whole-group kernel: SantaCoder's layer on the bf16 cache, SDPA beside
    # it, then its int8 rows and Falcon-40B's
    santa16 = rows[NEW_DECODE_SHAPES["santacoder"][0], "bf16"]
    for kernel, key in (("paged_decode_group", "K5"), ("fused_decode_group", "K6")):
        result[kernel] = dict(ms=santa16[key], plain_ms=santa16[f"{key} plain"], bound_ms=santa16["bound"],
                              bound_by=santa16["by"], library_ms=santa16["SDPA"])
        add_rows(result[kernel], key, GROUP_TIMED)
    # the whole-group kernel with fp32 q: SantaCoder's layer on the fp32 cache,
    # SDPA's fp32 call beside it, then its int8 row and Falcon-40B's
    santa32 = rows[NEW_DECODE_SHAPES["santacoder_fp32"][0], "fp32"]
    for kernel, key in (("paged_decode_group_fp32", "K5"), ("fused_decode_group_fp32", "K6")):
        result[kernel] = dict(ms=santa32[key], plain_ms=santa32[f"{key} plain"], bound_ms=santa32["bound"],
                              bound_by=santa32["by"], library_ms=santa32["SDPA"])
        add_rows(result[kernel], key, GROUP_FP32_TIMED)
    # the wide kernel: the D1024 layer on the bf16 cache, SDPA beside it, then
    # its int8 rows and D512's
    wide16 = rows[NEW_DECODE_SHAPES["d1024"][0], "bf16"]
    for kernel, key in (("paged_decode_wide", "K5"), ("fused_decode_wide", "K6")):
        result[kernel] = dict(ms=wide16[key], plain_ms=wide16[f"{key} plain"], bound_ms=wide16["bound"],
                              bound_by=wide16["by"], library_ms=wide16["SDPA"])
        add_rows(result[kernel], key, WIDE_TIMED)
    # the narrow kernel: the D32 layer on the bf16 cache, SDPA beside it, then
    # its rows on every cache and the GQA 4 layer's
    narrow16 = rows[NEW_DECODE_SHAPES["d32"][0], "bf16"]
    for kernel, key in (("paged_decode_narrow", "K5"), ("fused_decode_narrow", "K6")):
        result[kernel] = dict(ms=narrow16[key], plain_ms=narrow16[f"{key} plain"], bound_ms=narrow16["bound"],
                              bound_by=narrow16["by"], library_ms=narrow16["SDPA"])
        add_rows(result[kernel], key, NARROW_TIMED)
    return result


# K5/K6 timing shapes: (label, layers, slots, q heads, KV heads, head dim,
# max_len, contexts (tokens read, current one included) lo-hi, caches).  The
# first is one layer, which stays in the card's 50 MB L2 between graph
# replays (L2-hot; PERF.md's history is at this shape).  The others walk
# their layers with one call each, enough of them (over 100 MB) that every
# call finds its layer evicted from L2 (L2-cold): the 12 layers of GPT-2
# serving's cache (76 MB at int8), a long context at GPT-2's width (50 MB a
# layer at int8, 100 MB at bf16) and a Llama-shaped layer (GQA 32/8, D128,
# 134 MB at int8).
GPT2_HOT_SHAPE = ("gpt2 8 slots 1 layer L2-hot", 1, 8, 12, 12, 64, 1024, (481, 545), ("int8", "bf16"))
GPT2_COLD_SHAPE = ("gpt2 8 slots 12 layers L2-cold", 12, 8, 12, 12, 64, 1024, (485, 534), ("int8", "bf16"))
# the configurations beyond D64 / D128, bf16 q and groups up to 8, by the
# name the kernels line gives their times (<name>_ms on the int8 cache,
# <name>_<store>_ms on the others): SantaCoder's multi-query layers (group 16, two group tiles),
# Gemma-7B's head dim 256 (16 heads, two column slabs), Falcon-40B's GQA
# 128/8 at D64 (group 16), serving-fp16's configuration (fp16 q over an
# fp16 cache and over an fp8 one), a narrow head (D32, the narrow kernel,
# which also runs d = 8 and 16: on every cache, and at GQA 4) and the wide
# kernel's padded head dims (D512, D1024), each L2-cold
NEW_DECODE_SHAPES = {
    "santacoder": ("santacoder hq16 hkv1 D128 8 slots 24 layers L2-cold", 24, 8, 16, 1, 128, 2048, (1920, 2048),
                   ("int8", "bf16")),
    "gemma7b": ("gemma-7b hq16 hkv16 D256 8 slots 2 layers L2-cold", 2, 8, 16, 16, 256, 4096, (3800, 4096),
                ("int8", "bf16")),
    "falcon40b": ("falcon-40b hq128 hkv8 D64 8 slots 4 layers L2-cold", 4, 8, 128, 8, 64, 2048, (1920, 2048),
                  ("int8", "bf16")),
    "gpt2_12l": ("gpt2 fp16 q 8 slots 12 layers L2-cold", 12, 8, 12, 12, 64, 1024, (485, 534), ("fp16", "fp8 fp16 q")),
    "d32": ("h16 D32 32 slots 3 layers L2-cold", 3, 32, 16, 16, 32, 1024, (960, 1024),
            ("int8", "fp8", "bf16", "fp16", "fp32", "int8 fp32 q")),
    "d512": ("hq8 hkv2 D512 8 slots 4 layers L2-cold", 4, 8, 8, 2, 512, 2048, (1920, 2048), ("int8", "bf16")),
    "d1024": ("hq8 hkv2 D1024 8 slots 4 layers L2-cold", 4, 8, 8, 2, 1024, 2048, (1920, 2048), ("int8", "bf16")),
    # SantaCoder's and Falcon-40B's layers with fp32 q, over an fp32 cache and
    # an int8 one (over 100 MB a walk on both: 8 layers of Falcon-40B's)
    "santacoder_fp32": ("santacoder fp32 q hq16 hkv1 D128 8 slots 24 layers L2-cold", 24, 8, 16, 1, 128, 2048,
                        (1920, 2048), ("fp32", "int8 fp32 q")),
    "falcon40b_fp32": ("falcon-40b fp32 q hq128 hkv8 D64 8 slots 8 layers L2-cold", 8, 8, 128, 8, 64, 2048,
                       (1920, 2048), ("fp32", "int8 fp32 q")),
    # GQA groups above 8 at D256 and D32: RecurrentGemma-2B's local-attention
    # layer (10 q heads on one KV head of 256, window 2048; 16.8 MB a layer on
    # bf16, 8.4 on int8) and PaLM-8B's multi-query layer (16 heads of 256),
    # 8 layers each; a multi-query layer at D32 (32 slots of 1024, 32 layers,
    # 2-4 MB a layer); RecurrentGemma-2B's layer with fp32 q
    "recurrentgemma2b": ("recurrentgemma-2b hq10 hkv1 D256 8 slots 8 layers L2-cold", 8, 8, 10, 1, 256, 2048,
                         (1920, 2048), ("int8", "bf16")),
    "palm8b": ("palm-8b hq16 hkv1 D256 8 slots 8 layers L2-cold", 8, 8, 16, 1, 256, 2048, (1920, 2048),
               ("int8", "bf16")),
    # GQA 4 at D32 (16 q heads on 4 KV heads, 32 slots of 1024, 8 layers:
    # 9.1 MB a layer on int8, 16.2 MB on bf16): 4 q rows a KV row
    "d32_gqa4": ("hq16 hkv4 D32 32 slots 8 layers L2-cold", 8, 32, 16, 4, 32, 1024, (960, 1024), ("int8", "bf16")),
    "d32_mqa": ("hq16 hkv1 D32 32 slots 32 layers L2-cold", 32, 32, 16, 1, 32, 1024, (960, 1024), ("int8", "bf16")),
    "recurrentgemma2b_fp32": ("recurrentgemma-2b fp32 q hq10 hkv1 D256 8 slots 8 layers L2-cold", 8, 8, 10, 1, 256,
                              2048, (1920, 2048), ("fp32", "int8 fp32 q")),
    # PaLM-8B's multi-query layer and the D32 multi-query layer with fp32 q
    # (33.6 MB a layer of PaLM-8B's on fp32; 8.4 MB of the D32 one)
    "palm8b_fp32": ("palm-8b fp32 q hq16 hkv1 D256 8 slots 8 layers L2-cold", 8, 8, 16, 1, 256, 2048, (1920, 2048),
                    ("fp32", "int8 fp32 q")),
    "d32_mqa_fp32": ("hq16 hkv1 D32 fp32 q 32 slots 32 layers L2-cold", 32, 32, 16, 1, 32, 1024, (960, 1024),
                     ("fp32", "int8 fp32 q")),
    # head dims that run inside a wider instantiation, each model's
    # published layer at 8 slots: Phi-2's (32 heads of 80, run at D128; 84 MB
    # a layer on int8, 168 on bf16), GPT-NeoX-20B's (64 of 96), MPT-30B's (64
    # of 112), StableLM-2-12B's (32 q heads of 160 on 8 KV heads, run at D256,
    # 4096 tokens) through the split-KV kernel, 2 layers each; a multi-query
    # layer of 80 (16 q heads on one KV head: the whole-group kernel at D128,
    # 2.6 MB a layer on int8, so 40 layers)
    "phi2": ("phi-2 hq32 hkv32 D80 8 slots 2 layers L2-cold", 2, 8, 32, 32, 80, 2048, (1920, 2048), ("int8", "bf16")),
    "neox20b": ("gpt-neox-20b hq64 hkv64 D96 8 slots 2 layers L2-cold", 2, 8, 64, 64, 96, 2048, (1920, 2048),
                ("int8", "bf16")),
    "mpt30b": ("mpt-30b hq64 hkv64 D112 8 slots 2 layers L2-cold", 2, 8, 64, 64, 112, 2048, (1920, 2048),
               ("int8", "bf16")),
    "stablelm2_12b": ("stablelm-2-12b hq32 hkv8 D160 8 slots 2 layers L2-cold", 2, 8, 32, 8, 160, 4096, (3800, 4096),
                      ("int8", "bf16")),
    "mqa_d80": ("hq16 hkv1 D80 8 slots 40 layers L2-cold", 40, 8, 16, 1, 80, 2048, (1920, 2048), ("int8", "bf16")),
}
DECODE_SHAPES = (
    GPT2_HOT_SHAPE,
    GPT2_COLD_SHAPE,
    ("h12 D64 32 slots 3 layers L2-cold", 3, 32, 12, 12, 64, 1024, (960, 1024), ("int8", "bf16")),
    ("llama hq32 hkv8 D128 16 slots 2 layers L2-cold", 2, 16, 32, 8, 128, 4096, (3800, 4096), ("int8",)),
) + tuple(NEW_DECODE_SHAPES.values())
# the NEW_DECODE_SHAPES that run the whole-group kernel (a group above 8, bf16
# or fp16 q, D8-D256)
GROUP_TIMED = ("santacoder", "falcon40b", "recurrentgemma2b", "palm8b", "d32_mqa", "mqa_d80")
# the NEW_DECODE_SHAPES that run the whole-group kernel with fp32 q
GROUP_FP32_TIMED = ("santacoder_fp32", "falcon40b_fp32", "recurrentgemma2b_fp32", "palm8b_fp32", "d32_mqa_fp32")
# the NEW_DECODE_SHAPES that run the wide kernel (head dims above 256)
WIDE_TIMED = ("d512", "d1024")
# the NEW_DECODE_SHAPES that run the narrow kernel (head dims 8-32, groups of up to 8)
NARROW_TIMED = ("d32", "d32_gqa4")
# SantaCoder's layer with 8 q heads (one group tile) in place of 16 (two)
_SANTA = NEW_DECODE_SHAPES["santacoder"]
ONE_TILE_SHAPE = ("santacoder layer, hq8 hkv1 (one group tile)",) + _SANTA[1:3] + (8,) + _SANTA[4:]
# store: (cache dtype, q dtype)
STORES = {"int8": (torch.int8, torch.bfloat16), "fp8": (torch.float8_e4m3fn, torch.bfloat16),
          "bf16": (torch.bfloat16, torch.bfloat16), "fp16": (torch.float16, torch.float16),
          "fp8 fp16 q": (torch.float8_e4m3fn, torch.float16), "fp32": (torch.float32, torch.float32),
          "int8 fp32 q": (torch.int8, torch.float32)}


def _sdpa_backend(*args, **kw) -> str:
    """The backend torch SDPA picks for these arguments (its own choice
    function; "unknown" where this torch has none)."""
    try:
        return torch.nn.attention.SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except Exception:  # an internal function: absent or of another signature in some torch versions
        return "unknown"


def time_decode(gen: torch.Generator, smi: str, shape: tuple, store: str) -> dict:
    """K5 and K6 at one of DECODE_SHAPES: device ms a call (a CUDA graph of
    20 walks over the layers, one call a layer, between CUDA events, per
    call), beside the plain versions and, on a 16-bit cache, SDPA with a
    boolean length mask over the slot-major cache (one library call for the
    same function; GQA expanded by SDPA itself), and the byte bound; and ms
    a call as the engine calls them (`decode_attention_paged` /
    `decode_attention_fused`, CUDA events around back-to-back calls, which
    counts the host's enqueue where it is longer).  K5's device time is
    `paged_attention`'s, the kernel alone.  Returns {name: device ms,
    "<name> call": ms a call, "bound": ms, "by": what sets it}."""
    label, layers, slots, hq, hkv, d, max_len, (lo, hi), _ = shape
    dev_gen = torch.Generator(device="cuda").manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    contexts = torch.randint(lo, hi + 1, (slots,), generator=gen)
    payload, q_dtype = STORES[store]
    cache = _filled_cache(dev_gen, slots, hkv, max_len, d, payload, q_dtype, contexts - 1, layers)
    q = torch.randn(slots, hq, d, generator=dev_gen, device="cuda").to(q_dtype)
    views = [KVC.page_view(cache, layer, 128) for layer in range(layers)]
    pi = KVC.identity_page_indices(slots, max_len, 128, device="cuda")
    total = cache.lengths + 1

    def walk(f):
        return lambda: [f(layer) for layer in range(layers)]

    dev_fns = {
        "K5": walk(lambda i: PA.paged_attention(q, *views[i][:2], total, pi, k_scales=views[i][2],
                                                v_scales=views[i][3])),
        "K6": walk(lambda i: DA.decode_attention_fused(q, cache, i)),
        "K5 plain": walk(lambda i: PA.paged_attention_ref(q, *views[i][:2], total, pi, k_scales=views[i][2],
                                                          v_scales=views[i][3])),
        "K6 plain": walk(lambda i: DA.decode_attention(q, cache, i)),
    }
    call_fns = {
        "K5": walk(lambda i: DA.decode_attention_paged(q, cache, i, page_size=128)),
        "K6": dev_fns["K6"],
    }
    lib = ""
    if payload == q_dtype:
        mask = (torch.arange(max_len, device="cuda") <= cache.lengths[:, None])[:, None, None, :]

        def sdpa(i):
            k_c, v_c = (x[i].transpose(0, 1) for x in (cache.k, cache.v))
            return torch.nn.functional.scaled_dot_product_attention(q[:, :, None], k_c, v_c, attn_mask=mask,
                                                                    enable_gqa=hq != hkv)[:, :, 0]

        dev_fns["SDPA"] = walk(sdpa)
        with torch.no_grad():
            err, ok = _error(sdpa(0), DA.decode_attention(q, cache, 0), 2e-2, 1e-2)
        if not ok:
            raise AssertionError(f"[timing] SDPA over the {store} cache is {err:.3e} from the plain decode")
        k_c, v_c = (x[0].transpose(0, 1) for x in (cache.k, cache.v))
        backend = _sdpa_backend(q[:, :, None], k_c, v_c, attn_mask=mask, enable_gqa=hq != hkv)
        lib = f"; SDPA ({backend} backend) computes the same function within {err:.1e} of the plain decode"
    res = {}
    with torch.no_grad():
        for k, fn in dev_fns.items():
            plain = "plain" in k
            res[k] = graph_ms(fn, calls=2 if plain else 20, runs=3 if plain else 10) / layers
        for k, fn in call_fns.items():
            res[f"{k} call"] = time_ms(fn, inner=20) / layers
    if lib:
        res["SDPA backend"] = backend
    live = int(contexts.sum()) * hkv  # tokens x KV heads read
    nbytes = (live * d * cache.k.element_size() * 2 + (live * 8 if cache.quantized else 0)
              + slots * hq * d * q.element_size() * 2)
    # q.k and p.v per row read, at the peak of q's dtype: fp32 runs 3xTF32 on the tensor cores
    peak = TF32X3_FLOPS if q_dtype == torch.float32 else BF16_FLOPS
    res["bound"], res["by"] = floor_ms(nbytes, 4 * live * (hq // hkv) * d, peak)
    say(f"[timing] {smi} | decode {label}, contexts {int(contexts.min())}-{int(contexts.max())} of {max_len}, "
        f"{store} cache, {str(q_dtype).split('.')[-1]} q, ms a call on the device (share of the bound; ms a call as "
        f"the engine calls it): "
        + ", ".join(f"{k} {res[k]:.4f}" + (f" ({res['bound'] / res[k]:.1%}; {res[k + ' call']:.4f})"
                                           if k in call_fns else "") for k in dev_fns)
        + f"; bound {res['bound']:.4f} ms ({res['by']}{', 3xTF32' if peak == TF32X3_FLOPS else ''}, "
          f"{nbytes / 1e6:.2f} MB a layer){lib}")
    return res


# ---------------------------------------------------------------------------
# Head dims 129-256 (csrc/flash_d256.cuh)
# ---------------------------------------------------------------------------


def _key(name: str, d: int, dtype: torch.dtype) -> str:
    """The KERNEL_LAUNCHES key of kernel `name` for an input of head dim d."""
    return FA._route(name, FA.padded_head_dim(d), dtype)[0]


def _keep_worst(worst: dict, key: str, err: float) -> None:
    worst[key] = max(worst.get(key, 0.0), err)


def phase_d256(seed: int) -> dict:
    """K1, the pre-pass, K2/K3 and K4 at head dims 160 and 256 (both run at
    256: bf16/fp16 on the wgmma K1, K4, K2 and K3; fp32 on the 3xTF32 K1,
    K4, K2 and K3), 288 and 520 (padded to
    512 and 1024: bf16/fp16 K1, K4, K2 and K3 on the wide wgmma kernels;
    fp32 as at 256) against their plain versions and fp32 vanilla, with
    GQA 8/2, windows, segment ids, rows that see no key, the tiles' ragged
    edges, lse, non-causal, batch x heads past 32767, and K4 on int8 and
    fp8; then the 3xTF32 K1, K4, K2 and K3 at D256, D288, D520 and D1024.
    Returns each kernel's worst error against its plain version, by
    KERNEL_LAUNCHES key."""
    gen = torch.Generator().manual_seed(seed + 9)
    bf16, f16, f32, i8, f8 = torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.float8_e4m3fn
    say("[d256] head dims 160 and 256 (the wgmma K1, K4, K2, K3 for bf16/fp16; for fp32 the 3xTF32 K1, K4, K2 "
        "and K3), 288 and 520 (zero-padded to 512 and 1024: the wide wgmma K1, K4, K2 and K3 for bf16/fp16; fp32 "
        "as at 256): tolerances as at 64 / 128")
    worst: dict = {}
    for label, b, hq, hkv, lq, lk, d, dtype, causal, atol, kw in (
        ("d256 gqa 8/2 q129 kv257 window 100 bf16", 2, 8, 2, 129, 257, 256, bf16, True, 2e-2, dict(window=100)),
        ("d256 b2 h12 L1024 3 segments bf16", 2, 12, 12, 1024, 1024, 256, bf16, True, 2e-2, dict(segments=True)),
        # the d256-path's shape with no mask but causality: every tile below
        # the diagonal takes the kernel's unmasked branch
        ("d256 b4 h3 L1024 bf16 (d256-path)", 4, 3, 3, 1024, 1024, 256, bf16, True, 2e-2, {}),
        ("d256 b4 h3 L1024 fp16", 4, 3, 3, 1024, 1024, 256, f16, True, 2e-2, {}),
        ("d160 gqa 8/2 L384 window 100 fp16", 1, 8, 2, 384, 384, 160, f16, True, 2e-2, dict(window=100)),
        ("d160 fp32 b1 h4 L300 3 segments", 1, 4, 4, 300, 300, 160, f32, True, 1e-5, dict(segments=True)),
        ("d256 fp32 non-causal q200 kv300", 1, 4, 2, 200, 300, 256, f32, False, 1e-5, {}),
        # the wide wgmma forward: GQA with the group crossing the diagonal,
        # the tiles' ragged edges (q129 x kv257), windows, segment ids, rows
        # that see no key, several tiles through the ring, non-causal
        ("d288 gqa 8/2 q129 kv257 window 100 bf16", 2, 8, 2, 129, 257, 288, bf16, True, 2e-2, dict(window=100)),
        ("d288 gqa 8/2 q129 kv257 window 100 fp16", 2, 8, 2, 129, 257, 288, f16, True, 2e-2, dict(window=100)),
        ("d520 gqa 8/2 q129 kv257 window 100 bf16", 2, 8, 2, 129, 257, 520, bf16, True, 2e-2, dict(window=100)),
        ("d520 gqa 8/2 q129 kv257 window 100 fp16", 2, 8, 2, 129, 257, 520, f16, True, 2e-2, dict(window=100)),
        ("d520 b1 h4 L300 3 segments fp16", 1, 4, 4, 300, 300, 520, f16, True, 2e-2, dict(segments=True)),
        ("d288 b1 h4 L300 3 segments bf16", 1, 4, 4, 300, 300, 288, bf16, True, 2e-2, dict(segments=True)),
        ("d288 no-key rows q300 kv200 fp16", 1, 4, 4, 300, 200, 288, f16, True, 2e-2, dict(no_key_rows=100)),
        ("d520 no-key rows q300 kv200 bf16", 1, 4, 4, 300, 200, 520, bf16, True, 2e-2, dict(no_key_rows=100)),
        ("d288 b2 h4 L1024 bf16", 2, 4, 4, 1024, 1024, 288, bf16, True, 2e-2, {}),
        ("d520 b2 h4 L1024 fp16", 2, 4, 4, 1024, 1024, 520, f16, True, 2e-2, {}),
        ("d520 bf16 non-causal q200 kv300", 1, 4, 2, 200, 300, 520, bf16, False, 2e-2, {}),
        ("d288 fp32 non-causal q200 kv300", 1, 4, 2, 200, 300, 288, f32, False, 1e-5, {}),
        ("d520 fp32 gqa 4/2 L200 window 64", 1, 4, 2, 200, 200, 520, f32, True, 1e-5, dict(window=64)),
        # batch x heads above 32767 at D1024: the two slabs of a tile lie in
        # grid.x, so grid.y holds batch x heads up to 65535, as elsewhere
        ("d520 b2 h16400 gqa /4 L2 bf16", 2, 16400, 4100, 2, 2, 520, bf16, True, 2e-2, {}),
    ):
        _keep_worst(worst, _key("flash_fwd", d, dtype),
                    check_k1(label, gen, b, hq, hkv, lq, lk, d, dtype, causal, atol, **kw))
    for d in (160, 256, 288, 520):
        q, k, v = (_rand(gen, (1, 4, 300, d), f32) for _ in range(3))
        with torch.no_grad():
            out, lse = FA.flash_attention_with_lse(q, k, v)
            d_out, d_lse = vanilla_attention_with_lse(q, k, v, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        e = max((out - d_out).abs().max().item(), (lse - d_lse).abs().max().item())
        say(f"[d256] lse fp32 b1 h4 L300 D{d}: out and lse vs vanilla {e:.3e} atol 1e-05 {'ok' if e <= 1e-5 else 'FAIL'}")
        if e > 1e-5 or out.shape != q.shape:
            raise AssertionError("[d256] lse outside tolerance")
    # the wide wgmma forward's lse, which the wide K2/K3 read: against the
    # plain version's (the same roundings) at 1e-3 and fp32 vanilla's at
    # 2e-2 (q * scale rounded to 16 bits moves each score by up to 2^-8 of it)
    for d, dtype in ((288, bf16), (288, f16), (520, bf16), (520, f16)):
        q = _rand(gen, (1, 8, 300, d), dtype)
        k, v = (_rand(gen, (1, 2, 300, d), dtype) for _ in range(2))
        with torch.no_grad():
            out, lse = FA.flash_attention_with_lse(q, k, v)
            o_p, lse_p = FA.flash_attention_reference(q, k, v)
            o_d, lse_d = vanilla_attention_with_lse(q.float(), k.float().repeat_interleave(4, 1),
                                                    v.float().repeat_interleave(4, 1), sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        e_o = (out.float() - o_p.float()).abs().max().item()
        e_l = (lse - lse_p).abs().max().item()
        e_d = max((out.float() - o_d).abs().max().item(), (lse - lse_d).abs().max().item())
        ok = e_o <= 2e-2 and e_l <= 1e-3 and e_d <= 2e-2
        say(f"[d256] lse gqa 8/2 L300 D{d} {dtype}: out vs plain {e_o:.3e} (atol 2e-2), lse vs plain {e_l:.3e} "
            f"(atol 1e-3), out and lse vs vanilla {e_d:.3e} (atol 2e-2) {'ok' if ok else 'FAIL'}")
        if not ok or out.shape != q.shape or lse.shape != lse_p.shape:
            raise AssertionError("[d256] wide lse outside tolerance")
        _keep_worst(worst, _key("flash_fwd", d, dtype), max(e_o, e_l))
    for label, b, hq, lq, d, dtype, kw in (
        ("d256 b2 h12 L1024 bf16", 2, 12, 1024, 256, bf16, dict(with_lse=True)),
        ("d256 fp32 b1 h4 L300", 1, 4, 300, 256, f32, {}),
        ("d512 b1 h4 L300 bf16", 1, 4, 300, 512, bf16, dict(with_lse=True)),
        ("d1024 fp32 b1 h4 L300", 1, 4, 300, 1024, f32, {}),
    ):
        _keep_worst(worst, _key("flash_bwd_prep", d, dtype), check_prep(label, gen, b, hq, lq, d, dtype, **kw))
    for label, b, hq, hkv, lq, lk, d, dtype, kw in (
        ("d256 gqa 8/2 q129 kv257 w100 bf16", 2, 8, 2, 129, 257, 256, bf16, dict(window=100)),
        ("d256 b1 h4 L512 3 segments bf16", 1, 4, 4, 512, 512, 256, bf16, dict(segments=True)),
        ("d256 no-key rows q300 kv200 bf16", 1, 4, 4, 300, 200, 256, bf16, dict(no_key_rows=100)),
        ("d256 lse cotangent b2 h4 L1024 bf16", 2, 4, 2, 1024, 1024, 256, bf16, dict(with_lse=True)),
        ("d256 b4 h3 L1024 bf16 (d256-path)", 4, 3, 3, 1024, 1024, 256, bf16, {}),
        ("d256 gqa 8/2 L1024 fp16", 1, 8, 2, 1024, 1024, 256, f16, {}),
        ("d256 no-key rows q300 kv200 fp16", 1, 4, 4, 300, 200, 256, f16, dict(no_key_rows=100)),
        ("d160 gqa 8/2 L300 fp16", 1, 8, 2, 300, 300, 160, f16, {}),
        ("d160 fp32 gqa 4/2 L200 window 64", 1, 4, 2, 200, 200, 160, f32, dict(window=64)),
        ("d256 lse cotangent fp32 b1 h4 L300", 1, 4, 2, 300, 300, 256, f32, dict(with_lse=True)),
        ("d256 no-key rows fp32 q300 kv200", 1, 4, 4, 300, 200, 256, f32, dict(no_key_rows=100)),
        # the wide wgmma K2/K3 (bf16/fp16) on the wide wgmma forward's o and
        # lse, each edge in both dtypes and at both padded head dims: GQA 8/2
        # with ragged q129 x kv257 and window 100, 3 segments, rows that see
        # no key, the lse cotangent, non-causal Lq < Lk, and batch x heads
        # past 32767 (grid.y) at L2
        ("d288 gqa 8/2 q129 kv257 w100 bf16", 2, 8, 2, 129, 257, 288, bf16, dict(window=100)),
        ("d288 gqa 8/2 q129 kv257 w100 fp16", 2, 8, 2, 129, 257, 288, f16, dict(window=100)),
        ("d520 gqa 8/2 q129 kv257 w100 bf16", 2, 8, 2, 129, 257, 520, bf16, dict(window=100)),
        ("d520 gqa 8/2 q129 kv257 w100 fp16", 2, 8, 2, 129, 257, 520, f16, dict(window=100)),
        ("d520 b1 h4 L300 3 segments fp16", 1, 4, 4, 300, 300, 520, f16, dict(segments=True)),
        ("d288 b1 h4 L300 3 segments bf16", 1, 4, 4, 300, 300, 288, bf16, dict(segments=True)),
        ("d288 no-key rows q300 kv200 fp16", 1, 4, 4, 300, 200, 288, f16, dict(no_key_rows=100)),
        ("d520 no-key rows q300 kv200 bf16", 1, 4, 4, 300, 200, 520, bf16, dict(no_key_rows=100)),
        ("d520 lse cotangent gqa 8/2 L300 bf16", 1, 8, 2, 300, 300, 520, bf16, dict(with_lse=True)),
        ("d288 lse cotangent gqa 8/2 L300 fp16", 1, 8, 2, 300, 300, 288, f16, dict(with_lse=True)),
        ("d288 non-causal q200 kv300 bf16", 1, 4, 2, 200, 300, 288, bf16, dict(causal=False)),
        ("d520 non-causal q200 kv300 fp16", 1, 4, 2, 200, 300, 520, f16, dict(causal=False)),
        ("d520 b2 h16400 gqa /4 L2 bf16", 2, 16400, 4100, 2, 2, 520, bf16, {}),
        ("d288 b2 h16400 gqa /4 L2 fp16", 2, 16400, 4100, 2, 2, 288, f16, {}),
        # fp32 there: the 3xTF32 K2 / K3
        ("d288 lse cotangent fp32 b1 h4 L300", 1, 4, 2, 300, 300, 288, f32, dict(with_lse=True)),
        ("d520 no-key rows fp32 q300 kv200", 1, 4, 4, 300, 200, 520, f32, dict(no_key_rows=100)),
    ):
        r = check_grads(label, gen, b, hq, hkv, lq, lk, d, dtype, **kw)
        _keep_worst(worst, _key("flash_bwd_dkv", d, dtype), max(r["dk"], r["dv"]))
        _keep_worst(worst, _key("flash_bwd_dq", d, dtype), r["dq"])
    for label, b, hq, hkv, lq, lk, d, dtype, qdt, atol, kw in (
        ("d256 gqa 8/2 L1024 bf16 int8 window 256", 1, 8, 2, 1024, 1024, 256, bf16, i8, 2e-2, dict(window=256)),
        ("d256 b2 h4 L300 bf16 fp8 3 segments", 2, 4, 4, 300, 300, 256, bf16, f8, 2e-2, dict(segments=True)),
        ("d160 lk%4=3 q1023 gqa 8/2 fp16 fp8", 1, 8, 2, 1023, 1023, 160, f16, f8, 2e-2, {}),
        ("d256 fp32 b1 h4 L384 int8", 1, 4, 4, 384, 384, 256, f32, i8, 5e-5, {}),
        ("d160 fp32 gqa 4/2 L300 fp8 window 100", 1, 4, 2, 300, 300, 160, f32, f8, 5e-5, dict(window=100)),
        ("d288 gqa 8/2 L1024 bf16 int8 window 256", 1, 8, 2, 1024, 1024, 288, bf16, i8, 2e-2, dict(window=256)),
        ("d520 b2 h4 L300 fp16 fp8 3 segments", 2, 4, 4, 300, 300, 520, f16, f8, 2e-2, dict(segments=True)),
        ("d288 gqa 8/2 q129 kv257 fp16 fp8 w100", 2, 8, 2, 129, 257, 288, f16, f8, 2e-2, dict(window=100)),
        ("d520 lk%4=3 q1023 gqa 8/2 bf16 int8", 1, 8, 2, 1023, 1023, 520, bf16, i8, 2e-2, {}),
        ("d288 b1 h4 L300 bf16 fp8 3 segments", 1, 4, 4, 300, 300, 288, bf16, f8, 2e-2, dict(segments=True)),
        ("d520 gqa 8/2 q129 kv257 fp16 int8 w100", 2, 8, 2, 129, 257, 520, f16, i8, 2e-2, dict(window=100)),
        ("d520 fp32 b1 h4 L384 int8", 1, 4, 4, 384, 384, 520, f32, i8, 5e-5, {}),
    ):
        _keep_worst(worst, _key("flash_fwd_kv_quant", d, dtype),
                    check_k4(label, gen, b, hq, hkv, lq, lk, d, dtype, qdt, atol, **kw))
    # The 3xTF32 forward above head dim 128 (csrc/flash_fwd_fp32_wide.cuh):
    # K1 through the entry points, output and lse at 1e-5, each call
    # launching its key once (check_k1_fp32); K4 over int8 and fp8 at 5e-5,
    # one launch a case; at D256, D288 and D520 (padded to 512 and 1024) and
    # D1024.  The segment cases at q1014 x kv1024 put the causal diagonal 10
    # keys into a KV tile, so the groups of a block end their walks on
    # different tiles while the producer refills the ring.
    for d in (256, 288, 520, 1024):
        for label, b, hq, hkv, lq, lk, kw in (
            ("gqa 8/2 b2 L1024", 2, 8, 2, 1024, 1024, {}),
            ("edges q129 kv257 8/2 w100 3 segments", 2, 8, 2, 129, 257, dict(window=100, segments=True, no_key_rows=3)),
            ("3 segments q1014 kv1024", 2, 4, 4, 1014, 1024, dict(segments=True)),
            ("no-key rows q300 kv200 gqa 4/2", 1, 4, 2, 300, 200, dict(no_key_rows=100)),
            ("non-causal q200 kv300 gqa 4/2", 1, 4, 2, 200, 300, dict(causal=False)),
            ("lq<lk q128 kv384", 1, 4, 4, 128, 384, {}),
        ):
            _keep_worst(worst, _key("flash_fwd", d, f32),
                        check_k1_fp32(f"fp32 {label} D{d}", gen, b, hq, hkv, lq, lk, d, **kw))
        key = _key("flash_fwd_kv_quant", d, f32)
        for qn, qdt in (("int8", i8), ("fp8", f8)):
            for label, b, hq, hkv, lq, lk, kw in (
                ("gqa 8/2 b2 L1024", 2, 8, 2, 1024, 1024, {}),
                ("3 segments q1014 kv1024", 2, 4, 4, 1014, 1024, dict(segments=True)),
            ):
                before = dict(FA.KERNEL_LAUNCHES)
                _keep_worst(worst, key, check_k4(f"fp32 {label} D{d} {qn}", gen, b, hq, hkv, lq, lk, d, f32, qdt,
                                                 5e-5, **kw))
                launched = {k: n - before[k] for k, n in FA.KERNEL_LAUNCHES.items() if n != before[k]}
                if launched != {key: 1}:
                    raise AssertionError(f"[d256] fp32 K4 D{d} {qn}: launched {launched}, want {key} once")
    # The 3xTF32 backward above head dim 128 (csrc/flash_bwd_fp32_wide.cuh):
    # the grads of K1 + pre-pass + K2 + K3 through the entry points at 1e-4
    # against plain and vanilla (check_grads), each call launching the
    # "_d256_fp32" / "_wide_fp32" K2 and K3 once; at D256, D288 and D520
    # (padded to 512 and 1024; at 1024 on clusters of two blocks) and D1024.
    # The segment case at q1014 x kv1024 puts the causal diagonal 10 keys
    # into a KV tile, so the groups of a block end their walks on different
    # tiles while the producer refills the ring; the window over segment ids
    # at q129 x kv257 leaves rows in the middle that see no key.
    for d in (256, 288, 520, 1024):
        keys = [_key(name, d, f32) for name in ("flash_bwd_dkv", "flash_bwd_dq")]
        for label, b, hq, hkv, lq, lk, kw in (
            ("gqa 8/2 b2 L1024", 2, 8, 2, 1024, 1024, {}),
            ("edges q129 kv257 8/2 w100 3 segments", 2, 8, 2, 129, 257, dict(window=100, segments=True)),
            ("3 segments q1014 kv1024", 2, 4, 4, 1014, 1024, dict(segments=True)),
            ("no-key rows q300 kv200 gqa 4/2", 1, 4, 2, 300, 200, dict(no_key_rows=100)),
            ("non-causal q200 kv300 gqa 4/2", 1, 4, 2, 200, 300, dict(causal=False)),
            ("lq<lk q128 kv384", 1, 4, 4, 128, 384, {}),
            ("lse cotangent gqa 8/2 L300", 1, 8, 2, 300, 300, dict(with_lse=True)),
        ):
            before = dict(FA.KERNEL_LAUNCHES)
            r = check_grads(f"fp32 {label} D{d}", gen, b, hq, hkv, lq, lk, d, f32, **kw)
            launched = {k: n - before[k] for k, n in FA.KERNEL_LAUNCHES.items() if n != before[k]}
            if any(launched.get(key) != 1 for key in keys):
                raise AssertionError(f"[d256] fp32 grads {label} D{d}: launched {launched}, want {keys} once each")
            _keep_worst(worst, keys[0], max(r["dk"], r["dv"]))
            _keep_worst(worst, keys[1], r["dq"])
    return worst


def phase_d256_path(seed: int, data: np.ndarray) -> dict:
    """The D256 route through the entry points: a GPT at GPT-2's width with
    3 heads of 256 (the head dim of Gemma-7B), 2 layers, trained 6 steps
    at b4 x T1024 by the port's Trainer in bf16, which must launch the
    "_d256" keys (the wgmma K1, K2 and K3, the pre-pass) n_layer x steps
    times each and nothing else; the median step.  Then
    quantize_kv + flash_attention_kv_quant over 4 layers at b4 h3 T1024
    D256 (int8 and fp8), which must launch the wgmma K4 at D256 4 times.
    Returns the launches."""
    cfg = dataclasses.replace(GPT2_124M, n_layer=2, n_head=3)
    steps = 6
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=1)
    trainer = Trainer(cfg, tcfg, seed=seed, device="cuda")
    batches = batch_iterator(data, 4, 1024, seed=seed, device="cuda")
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit(batches, log=lambda line: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(FA.KERNEL_LAUNCHES)
    losses = [r["train_loss"] for r in history]
    want = cfg.n_layer * steps
    others = {k: n for k, n in launches.items() if k not in D256_TRAINING_KERNELS and n}
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[d256-path] losses {losses}")
    if any(launches[k] != want for k in D256_TRAINING_KERNELS) or others:
        raise AssertionError(f"[d256-path] launches {launches}, want {want} of each D256 training kernel only")
    step_ms = np.diff([0.0] + [r["wall_s"] for r in history]) * 1e3
    say(f"[d256-path] GPT width {cfg.n_embd}, {cfg.n_head} heads of D{cfg.head_dim}, {cfg.n_layer} layers, "
        f"{steps} Trainer steps at b4 x T1024 in {wall:.2f} s: losses {' '.join(f'{x:.3f}' for x in losses)}; "
        f"launches { {k: launches[k] for k in D256_TRAINING_KERNELS} } = {cfg.n_layer} layers x {steps} steps each; "
        f"step {float(np.median(step_ms[1:])):.2f} ms (median of steps 2-{steps})")
    gen = torch.Generator().manual_seed(seed + 10)
    layers = [tuple(_rand(gen, (4, 3, 1024, 256), torch.bfloat16) for _ in range(3)) for _ in range(4)]
    torch.cuda.synchronize()
    _reset_launches()
    with torch.no_grad():
        outs = [QK.flash_attention_kv_quant(q, QK.quantize_kv(k, v, dtype=(torch.int8, torch.float8_e4m3fn)[i % 2]))
                for i, (q, k, v) in enumerate(layers)]
    torch.cuda.synchronize()
    n4 = FA.KERNEL_LAUNCHES["flash_fwd_kv_quant_d256"]
    others = {k: n for k, n in FA.KERNEL_LAUNCHES.items() if k != "flash_fwd_kv_quant_d256" and n}
    if n4 != 4 or others or not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"[d256-path] quant op path: {n4} K4 launches of 4 (others {others}), or bad outputs")
    say(f"[d256-path] quant op path, 4 layers at b4 h3 T1024 D256 bf16 (int8, fp8): flash_fwd_kv_quant_d256 "
        f"launches {n4}, outputs finite")
    launches["flash_fwd_kv_quant_d256"] = n4
    return {k: launches[k] for k in (*D256_TRAINING_KERNELS, "flash_fwd_kv_quant_d256")}


# The path of head dims above 256 and of fp32 at 256 (`phase_wide_path`):
# what it must launch.  bf16 at D288 and D520 runs the wide wgmma K1, K4, K2
# and K3 ("_wide"); fp32 at D520 the 3xTF32 K1, K4, K2 and K3
# ("_wide_fp32"); the pre-pass of both ("_wide"); fp32 at D256 the
# "_d256_fp32" K1, K4, K2 and K3.
WIDE_PATH_LAUNCHES = {
    "flash_fwd_wide": 2, "flash_bwd_prep_wide": 3, "flash_bwd_dkv_wide": 2, "flash_bwd_dq_wide": 2,
    "flash_fwd_kv_quant_wide": 2, "flash_fwd_wide_fp32": 1, "flash_fwd_kv_quant_wide_fp32": 1,
    "flash_bwd_dkv_wide_fp32": 1, "flash_bwd_dq_wide_fp32": 1,
    "flash_fwd_d256_fp32": 1, "flash_bwd_prep_d256": 1, "flash_bwd_dkv_d256_fp32": 1, "flash_bwd_dq_d256_fp32": 1,
    "flash_fwd_kv_quant_d256_fp32": 1,
}


def _hold(label: str, name: str, got: torch.Tensor, plain: torch.Tensor, dense: torch.Tensor, tol: float) -> str:
    """`got` against its plain version and fp32 vanilla within `tol`, of
    their shape and finite; returns the two errors and the tolerance."""
    if got.shape != dense.shape or not torch.isfinite(got).all():
        raise AssertionError(f"[wide-path] {label}: bad {name} {tuple(got.shape)}")
    e_p = (got.float() - plain.float()).abs().max().item()
    e_d = (got.float() - dense.float()).abs().max().item()
    if not (e_p <= tol and e_d <= tol):
        raise AssertionError(f"[wide-path] {label}: {name} vs plain {e_p:.3e}, vs vanilla {e_d:.3e}, tol {tol:.3e}")
    return f"{name} {e_p:.2e}/{e_d:.2e} tol {tol:.2e}"


def phase_wide_path(seed: int) -> dict:
    """The kernels a caller with a head dim above 256, or fp32 at 256,
    reaches, through the entry points: a forward and backward step of
    flash_attention at b2 h4 L1024 for head dims 288 (padded to 512) and
    520 (to 1024) in bf16 (the wide wgmma K1, K2 and K3), 256 and 520 in
    fp32 (the 3xTF32 K1, K2 and K3), and flash_attention_kv_quant (int8) at
    each.  Each "_wide", "_wide_fp32" and "_d256_fp32" key must launch as
    WIDE_PATH_LAUNCHES says, and nothing else.  Then every output against
    its plain version (flash_attention_reference, flash_attention_bwd_reference,
    flash_attention_kv_quant_reference) and fp32 vanilla on the same inputs
    (K4's on the K/V dequantized the kernel's way): bf16 out and K4 2e-2,
    grads 2e-2 x max |grad| of the fp32 reference; fp32 out 1e-5, grads
    1e-4, K4 5e-5.  Returns the launches."""
    gen = torch.Generator().manual_seed(seed + 11)
    cases = [(288, torch.bfloat16), (520, torch.bfloat16), (256, torch.float32), (520, torch.float32)]
    inputs = [tuple(_rand(gen, (2, 4, 1024, d), dtype) for _ in range(4)) for d, dtype in cases]
    torch.cuda.synchronize()
    _reset_launches()
    results = []
    for q, k, v, do in inputs:
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = FA.flash_attention(q, k, v)
        out.backward(do)
        with torch.no_grad():
            kv = QK.quantize_kv(k.detach(), v.detach())
            o4 = QK.flash_attention_kv_quant(q.detach(), kv)
        results.append((q, k, v, do, kv, out.detach(), o4, (q.grad, k.grad, v.grad)))
    torch.cuda.synchronize()
    launches = {k: n for k, n in FA.KERNEL_LAUNCHES.items() if n}
    if launches != WIDE_PATH_LAUNCHES:
        raise AssertionError(f"[wide-path] launches {launches}, want {WIDE_PATH_LAUNCHES}")
    # The plain backward at the D64 kernels' tiles: at the wide kernels'
    # 16-64-row tiles it costs thousands of small launches a call, and the
    # tiling changes only the order of its fp32 sums
    # (test_plain_backward_tiling_does_not_change_result).
    bwd_tiles = FA.default_blocks(1024, 1024, 64)
    for (d, dtype), (q, k, v, do, kv, out, o4, grads) in zip(cases, results):
        label = f"b2 h4 L1024 D{d} {dtype}"
        fp32 = dtype == torch.float32
        q, k, v = (x.detach() for x in (q, k, v))
        with torch.no_grad():
            o_p, lse_p = FA.flash_attention_reference(q, k, v)
            g_p = FA.flash_attention_bwd_reference(q, k, v, o_p, lse_p, do, block_sizes=bwd_tiles)
            o4_p = QK.flash_attention_kv_quant_reference(q, kv)
            k_t, v_t = (QK._dequantize_like_kernel(x, sc, dtype) for x, sc in ((kv.k, kv.k_scale), (kv.v, kv.v_scale)))
            o4_d = _dense_on(q, k_t, v_t)
        qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
        o_d, _ = vanilla_attention_with_lse(qf, kf, vf, sm_scale=d ** -0.5)
        g_d = torch.autograd.grad((o_d * do.float()).sum(), (qf, kf, vf))
        errs = [_hold(label, "out", out, o_p, o_d.detach(), 1e-5 if fp32 else 2e-2)]
        errs += [_hold(label, n, a, p_, r, 1e-4 if fp32 else 2e-2 * r.abs().max().item())
                 for n, a, p_, r in zip(("dq", "dk", "dv"), grads, g_p, g_d)]
        errs.append(_hold(label, "K4 int8", o4, o4_p, o4_d, 5e-5 if fp32 else 2e-2))
        say(f"[wide-path] {label} vs plain/vanilla: {'  '.join(errs)}  ok")
    say(f"[wide-path] forward + backward + K4 (int8) at b2 h4 L1024 D288 / D520 bf16 and D256 / D520 fp32: "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# The Llama slice
# ---------------------------------------------------------------------------


def _llama3_8b(seed: int) -> llama.Llama:
    cfg = llama.LLAMA3_8B
    t0 = time.perf_counter()
    model = llama.Llama(cfg, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    say(f"[llama] Llama-3 8B: {cfg.dtype} weights, vocab {cfg.vocab_size}, {cfg.n_layer} layers, heads "
        f"{cfg.n_head}/{cfg.n_kv_head} (GQA group {cfg.n_head // cfg.n_kv_head}) of D{cfg.head_dim}, width "
        f"{cfg.n_embd}, MLP {cfg.intermediate}: {llama.num_params(model) / 1e9:.3f} B parameters drawn on the card "
        f"(seed {seed}) in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return model


def _trace_llama_decode(model: llama.Llama, smi: str, label: str, cache_dtype=None, steps: int = 4) -> dict:
    """torch.profiler over `steps` Llama decode steps at the bursts' shape (8
    slots, max_len 1024, every slot at length 512, greedy tokens fed back)
    after 4 untraced ones: device-busy ms a step (the union of kernel and
    copy intervals), that time by kind of kernel, the longest kernels, and
    the idle share of the untraced step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    cache = init_cache(cfg.n_layer, 8, cfg.n_kv_head, 1024, cfg.head_dim, dtype=cfg.dtype, quant_dtype=cache_dtype,
                       device="cuda")
    toks = torch.zeros(8, dtype=torch.int32, device="cuda")

    def run(n):
        nonlocal toks
        for _ in range(n):
            cache.lengths.fill_(512)
            toks = llama.decode_step(model, toks, cache)[1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()

    run(4)
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
    found = device_time(prof, steps)
    if found is None:
        say(f"[llama] trace: torch.profiler recorded no device events ({label})")
        return {}
    busy_ms, kinds, top = found
    say(f"[llama] {smi} | decode step trace, {label}, 8 slots at length 512: wall {wall:.2f} ms a step untraced, "
        f"device busy {busy_ms:.2f} ms (idle share {1 - busy_ms / wall:.1%}); by kind, ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items())
        + "; longest: " + "; ".join(f"{n[:50]} {ms:.3f}" for n, ms in sorted(top.items(), key=lambda x: -x[1])[:5]))
    return dict(wall_ms=wall, busy_ms=busy_ms, kinds=kinds)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 error of a against b."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# Bounds of the fp8 burst's checks.  Logits, relative L2 in fp32: the
# engine's prefill and a full forward of the same bucket-padded prompt run
# the same kernels on the same shapes but for the LM head (one row against
# all), a bf16 ulp of a logit at most.  Every other logit comparison takes
# other matmul shapes (the unpadded forward, decode against recompute) or
# another cache through 32 layers of random weights, which spread a bf16
# ulp to a few percent (0.04-0.05 on an H100 for prompts whose unpadded
# forward takes other GEMM kernels; decode against recompute 0.06), and
# the fp8 cache's rounding, a few percent of each K/V element at every
# layer, spreads the same way (0.26-0.35 against a bf16 cache); logits of
# the wrong position read about 1.4.  So the fp8 cache is checked layer by
# layer as well: every K/V element stored by prefill (and, in layer 0,
# whose input is the same on both caches, by the first decode step)
# within half an e4m3 step of its bf16 value (at most
# 16 / 448 of its row's amax, which a bf16 value on a midpoint of the top
# step reaches; 1e-3 more for the fp32 rounding of the scale and of the
# check itself), and decode's attention over the cache
# against fp32 attention over the dequantized rows (bf16 probabilities:
# a few 1e-3).
LLAMA_PREFILL_VS_PADDED_FORWARD = 0.01
LLAMA_OTHER_SHAPES = 0.25
LLAMA_FP8_VS_BF16_CACHE = 0.5
LLAMA_FP8_WRITE = 16 / 448 * 1.001
LLAMA_FP8_READ = 0.01


def _check_llama_fp8(model: llama.Llama, fp8: dict, steps: int = 4) -> None:
    """The fp8 burst against the same (int4) weights.  Each greedy request's
    first token must be the argmax of llama.prefill's fp32 logits on its
    prompt padded to the engine's bucket (the same call the engine makes),
    and those logits agree with a full forward of the padded prompt (and,
    within the spread of bf16 rounding, of the unpadded one).  The first
    token reads no cache, so one prompt is then prefilled into an fp8 and a
    bf16 cache: their stored K/V compared (every layer's prompt rows, layer
    0's first decoded row), `steps` tokens decoded
    teacher-forced (its own output fed back) on both and against full
    recompute, and every layer's decode attention over the fp8 cache
    against fp32 attention over its dequantized rows."""
    cfg = model.cfg
    greedy = [(prompt, out) for prompt, is_greedy, out in fp8["requests"] if is_greedy]

    def padded(prompt):
        n = len(prompt)
        toks = torch.full((min(1024, max(64, 1 << (n - 1).bit_length())),), prompt[-1], device="cuda")
        toks[:n] = torch.as_tensor(prompt, device="cuda")
        return toks

    def prefilled(prompt, quant_dtype):
        cache = init_cache(cfg.n_layer, 1, cfg.n_kv_head, 1024, cfg.head_dim, dtype=cfg.dtype,
                           quant_dtype=quant_dtype, device="cuda")
        return llama.prefill(model, padded(prompt), cache, 0, len(prompt))

    def forward(seq, pos=-1):
        return model(torch.as_tensor(seq, device="cuda")[None])[0, pos].float()

    same, other = [], []
    with torch.no_grad():
        for prompt, out in greedy:
            logits = prefilled(prompt, torch.float8_e4m3fn)[1]
            if out[0] != int(logits.argmax()):
                raise AssertionError(f"[llama] first token {out[0]} is not the argmax {int(logits.argmax())} of "
                                     f"llama.prefill's logits on the same prompt")
            same.append(_rel(logits, forward(padded(prompt), len(prompt) - 1)))
            other.append(_rel(logits, forward(prompt)))
    ok = max(same) <= LLAMA_PREFILL_VS_PADDED_FORWARD and max(other) <= LLAMA_OTHER_SHAPES
    say(f"[llama] fp8 burst, {len(greedy)} greedy requests: first token = argmax of llama.prefill's logits on the "
        f"bucket-padded prompt on all; those logits vs a full forward of the same int4 weights, relative L2: padded "
        f"{' '.join(f'{r:.4f}' for r in same)} (bound {LLAMA_PREFILL_VS_PADDED_FORWARD}), unpadded "
        f"{' '.join(f'{r:.4f}' for r in other)} (bound {LLAMA_OTHER_SHAPES}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[llama] prefill logits disagree with the full forward")

    prompt, out = min(greedy, key=lambda r: abs(len(r[0]) - 512))
    n = len(prompt)
    (c8, _), (c16, _) = prefilled(prompt, torch.float8_e4m3fn), prefilled(prompt, None)

    def write_error(layers, lo, hi):
        """Worst |stored fp8 K/V - bf16 cache's| / row amax over rows [lo, hi)."""
        worst = 0.0
        for pay, scale, ref in ((c8.k, c8.k_scale, c16.k), (c8.v, c8.v_scale, c16.v)):
            ref = ref[layers, :, 0, lo:hi].float()  # [layers, head, rows, D]
            err = (pay[layers, :, 0, lo:hi].float() * scale[layers, :, 0, lo:hi, None] - ref).abs()
            worst = max(worst, (err / ref.abs().amax(-1, keepdim=True)).max().item())
        return worst

    write = write_error(slice(None), 0, n)
    r16, r8 = [], []
    with torch.no_grad():
        for i in range(steps):
            tok = torch.tensor([out[i]], dtype=torch.int32, device="cuda")
            c16, l16 = llama.decode_step(model, tok, c16)
            c8, l8 = llama.decode_step(model, tok, c8)
            if i == 0:
                write = max(write, write_error(slice(0, 1), n, n + 1))
            r16.append(_rel(l16[0], forward(prompt + out[:i + 1])))
            r8.append(_rel(l8[0], l16[0]))
        # decode attention of every layer over the fp8 cache as decode_step
        # reads it: lengths + 1 rows, GQA 32/8
        q = _rand(torch.Generator().manual_seed(n), (1, cfg.n_head, cfg.head_dim), cfg.dtype)
        rows = int(c8.lengths[0]) + 1
        read = 0.0
        for li in range(cfg.n_layer):
            k, v = ((pay[li, :, 0, :rows].float() * scale[li, :, 0, :rows, None]).repeat_interleave(
                cfg.n_head // cfg.n_kv_head, 0) for pay, scale in ((c8.k, c8.k_scale), (c8.v, c8.v_scale)))
            p = torch.softmax(torch.einsum("hd,hld->hl", q[0].float(), k) * cfg.head_dim ** -0.5, -1)
            read = max(read, _rel(DA.decode_attention(q, c8, li)[0], torch.einsum("hl,hld->hd", p, v)))
    ok = (write <= LLAMA_FP8_WRITE and read <= LLAMA_FP8_READ and max(r16) <= LLAMA_OTHER_SHAPES
          and max(r8) <= LLAMA_FP8_VS_BF16_CACHE)
    say(f"[llama] fp8 cache of a {n}-token prompt, int4 weights, {cfg.n_layer} layers: stored K/V vs the bf16 "
        f"cache's, worst error / row amax {write:.6f} (bound 16/448 + 0.1%, {LLAMA_FP8_WRITE:.6f}); decode attention over "
        f"{rows} rows vs fp32 attention on the dequantized rows, worst relative L2 {read:.2e} (bound "
        f"{LLAMA_FP8_READ}); {steps} teacher-forced decode steps, relative L2: bf16 cache vs full recompute "
        f"{' '.join(f'{r:.4f}' for r in r16)} (bound {LLAMA_OTHER_SHAPES}), fp8 cache vs bf16 cache "
        f"{' '.join(f'{r:.4f}' for r in r8)} (bound {LLAMA_FP8_VS_BF16_CACHE}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[llama] the fp8 cache or decode over it outside its bounds")


def phase_llama(seed: int, smi: str) -> dict:
    """The slice's path: Llama-3 8B at full width and depth behind the
    engine (prefill_fn=llama.prefill, decode_fn=llama.decode_step), the
    serving burst twice: bf16 weights on a bf16 cache, then int4
    weight-only (quantized in place) on an fp8 cache, each followed by a
    profiler trace of its decode step.  K1 launched n_layer x prefill
    dispatches (one prompt each), nothing else (decode is the einsum).  The
    fp8 burst is then checked against the same int4 model
    (_check_llama_fp8).  Returns K1's launches in each burst."""
    model = _llama3_8b(seed)
    cfg = model.cfg
    kw = dict(prefill_fn=llama.prefill, decode_fn=llama.decode_step)
    runs = {}
    for name, cache in (("bf16 weights, bf16 cache", None), ("int4 weights, fp8 cache", torch.float8_e4m3fn)):
        if cache is not None:
            t0 = time.perf_counter()
            quantize_llama_params(model, bits=4)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            say(f"[llama] int4 weight-only (split-halves packing, per-channel scales) of every projection and the LM "
                f"head in {time.perf_counter() - t0:.1f} s: {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
        r = _burst(seed, "llama", model, kv_quant_dtype=cache, **kw)
        others = {k: n for k, n in r["launches"].items() if k != "flash_fwd" and n}
        if r["dispatches"] != 16 or others:
            raise AssertionError(f"[llama] {r['dispatches']} prefill dispatches of 16, other kernels {others}")
        runs[name] = r
        _trace_llama_decode(model, smi, name, cache)
        say(f"[llama] {name}: 16/16 requests finished with their exact budgets, ids in range; flash_fwd (K1, GQA "
            f"{cfg.n_head}/{cfg.n_kv_head} D{cfg.head_dim}) launches {r['launches']['flash_fwd']} = {cfg.n_layer} "
            f"layers x {r['dispatches']} prefill dispatches; prompt lengths {r['lengths']}")
        say(f"[llama] {smi} | {name}: {r['toks']} tokens in {r['wall']:.3f} s wall: {r['tokens_s']:.1f} tokens/s, "
            f"TTFT p50 {r['p50'] * 1e3:.1f} ms p95 {r['p95'] * 1e3:.1f} ms, decode steps {r['steps']}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if cache is None:
            runs["bf16, chunk_prefill=256"] = _llama_chunked(seed, model, r, smi, kw)
    _check_llama_fp8(model, runs["int4 weights, fp8 cache"])
    del model
    torch.cuda.empty_cache()
    return {name: r["launches"]["flash_fwd"] for name, r in runs.items()}


def _llama_chunked(seed: int, model: llama.Llama, base: dict, smi: str, kw: dict) -> dict:
    """llama-chunked: the bf16 burst with prefill_chunk_fn=llama.prefill_chunk
    and chunk_prefill=256: exact budgets, the chunk count of the prompt
    lengths, K1 launched n_layer x whole-prompt dispatches; one chunk's
    wall ms through the 32 layers."""
    tag = "llama-chunked"
    cfg = model.cfg
    r = _burst(seed, tag, model, prefill_chunk_fn=llama.prefill_chunk, chunk_prefill=CHUNK, **kw)
    want = sum(_chunk_count(n, CHUNK, 1024) for n in r["lengths"])
    chunked = sum(n > CHUNK for n in r["lengths"])
    got = r["stats"].get("prefill_chunks", 0)
    others = {k: n for k, n in r["launches"].items() if k != "flash_fwd" and n}
    if got != want or r["dispatches"] != 16 - chunked or others:
        raise AssertionError(f"[{tag}] {got} chunks (want {want}), {r['dispatches']} whole-prompt dispatches (want "
                             f"{16 - chunked}), other kernels {others}")
    say(f"[{tag}] Llama-3 8B bf16: 16/16 requests finished with their exact budgets; {got} chunks of {CHUNK} for "
        f"the {chunked} prompts over {CHUNK} tokens; flash_fwd launches {r['launches']['flash_fwd']} = "
        f"{cfg.n_layer} layers x {r['dispatches']} whole-prompt dispatches")
    say(f"[{tag}] {smi} | chunk_prefill={CHUNK}: {_rates(r)}, decode steps {r['steps']} (whole prompts: "
        f"{_rates(base)}, decode steps {base['steps']})")
    cache = init_cache(cfg.n_layer, 1, cfg.n_kv_head, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, CHUNK), device="cuda")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llama.prefill_chunk(model, toks, cache, 0, 512)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    say(f"[{tag}] {smi} | one {CHUNK}-token chunk at position 512 through {cfg.n_layer} layers: "
        f"{statistics.median(walls[1:]):.3f} ms wall (median of 5)")
    return r


def phase_llama_parity(seed: int) -> int:
    """fp32 Llama-3 8B widths at 2 layers: prefill logits and those of
    llama.prefill_chunk (chunks of 128) against a full forward (1e-3); 6
    greedy tokens of cached decode equal full recompute;
    int8 / int4 weight-only forwards finite, against fp32 (printed; bounded
    between the readings of random weights at this width and those of two
    broken int4 forwards, which must fail it), and held to the JAX test's
    bounds (0.05 / 1.0) at its own config, TINY_LLAMA."""
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layer=2, dtype=torch.float32)
    model = llama.Llama(cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda")
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    _reset_launches()
    with torch.no_grad():
        ref = model(torch.as_tensor(prompt, device="cuda")[None])[0, -1]
        cache = init_cache(cfg.n_layer, 1, cfg.n_kv_head, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
        cache, logits = llama.prefill(model, torch.as_tensor(prompt, device="cuda"), cache, 0)
        e_prefill = (logits - ref).abs().max().item()
        cached = [int(logits.argmax())]
        for _ in range(5):
            cache, lg = llama.decode_step(model, torch.tensor([cached[-1]], dtype=torch.int32, device="cuda"), cache)
            cached.append(int(lg[0].argmax()))
        seq = list(prompt)
        for _ in range(6):
            seq.append(int(model(torch.as_tensor(seq, device="cuda")[None])[0, -1].argmax()))
        # llama-chunked's parity: the prompt in chunks of 128 (RoPE at
        # absolute positions)
        chunks = init_cache(cfg.n_layer, 1, cfg.n_kv_head, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
        for start in range(0, len(prompt), 128):
            piece = prompt[start:start + 128]
            valid = len(piece)
            piece = piece + [prompt[-1]] * (128 - valid)
            _, lg = llama.prefill_chunk(model, torch.as_tensor(piece, device="cuda"), chunks, 0, start, valid)
        e_chunk = (lg - ref).abs().max().item()
    torch.cuda.synchronize()
    # K1 in the full forwards (1 + 6) and in llama.prefill, a layer each; the
    # chunks and the decode steps run dense attention
    k1, k1_16 = FA.KERNEL_LAUNCHES["flash_fwd_fp32"], FA.KERNEL_LAUNCHES["flash_fwd"]
    want = cfg.n_layer * 8
    ok = e_prefill <= 1e-3 and e_chunk <= 1e-3 and cached == seq[len(prompt):]
    say(f"[llama-parity] fp32 Llama-3 8B widths, 2 layers, prompt 300: prefill logits vs full forward "
        f"{e_prefill:.3e}, llama.prefill_chunk in chunks of 128 vs full forward {e_chunk:.3e} (atol 1e-3); 6 "
        f"greedy tokens of cached decode {cached} vs full recompute {seq[len(prompt):]} {'ok' if ok else 'FAIL'}; "
        f"flash_fwd_fp32 (GQA 32/8 D128) launches {k1} (want {want}), flash_fwd {k1_16}")
    if not ok:
        raise AssertionError("[llama-parity] cached path disagrees with full recompute")
    if k1 != want or k1_16:
        raise AssertionError(f"[llama-parity] flash_fwd_fp32 launched {k1} times (want {want}), flash_fwd {k1_16}")
    # int8 / int4: copies of the fp32 model quantized in place.  Bounds on
    # the logits' relative L2, above the readings of random weights at this
    # width (0.041 / 0.674 on the H100) and, for int4, below those of the two
    # broken int4 forwards checked after it: an all-zero forward reads 1.0
    idx = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 32)), device="cuda")
    bounds = {8: 0.1, 4: 0.8}
    parts = []

    def broken(q, how):
        """A copy of the int4 model q with every packed byte's nibble halves
        swapped, or every scale zeroed."""
        q = copy.deepcopy(q)
        for m in q.modules():
            if isinstance(m, QuantizedLinear):
                if how == "nibble halves swapped":
                    m.values.copy_(((m.values & 0x0F) << 4) | ((m.values >> 4) & 0x0F))
                else:
                    m.scales.zero_()
        return q

    with torch.no_grad():
        ref = model(idx)
        for bits in (8, 4):
            q = quantize_llama_params(copy.deepcopy(model), bits=bits)
            out = q(idx)
            rel = _rel(out, ref)
            ok = bool(torch.isfinite(out).all()) and rel <= bounds[bits]
            parts.append(f"int{bits} max |err| {(out - ref).abs().max().item():.3f}, relative L2 {rel:.3f} "
                         f"(bound {bounds[bits]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[llama-parity] int{bits} forward outside its bound")
        for how in ("nibble halves swapped", "scales zeroed"):
            rel = _rel(broken(q, how)(idx), ref)
            caught = rel > bounds[4]
            parts.append(f"int4 with {how} relative L2 {rel:.3f} ({'outside' if caught else 'INSIDE'} the bound)")
            if not caught:
                raise AssertionError(f"[llama-parity] an int4 forward with {how} passes the int4 bound")
        del q
    del model
    torch.cuda.empty_cache()
    tiny = llama.Llama(llama.TINY_LLAMA, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    idx = torch.as_tensor(rng.integers(0, tiny.cfg.vocab_size, (1, 32)), device="cuda")
    with torch.no_grad():
        ref = tiny(idx)
        for bits, tol in ((8, 0.05), (4, 1.0)):
            err = (quantize_llama_params(copy.deepcopy(tiny), bits=bits)(idx) - ref).abs().max().item()
            parts.append(f"TINY_LLAMA int{bits} max |err| {err:.4f} (the JAX test's bound {tol}) "
                         f"{'ok' if err < tol else 'FAIL'}")
            if not err < tol:
                raise AssertionError(f"[llama-parity] TINY_LLAMA int{bits} outside the JAX test's bound")
    say("[llama-parity] weight-only vs fp32 logits, 32 tokens: " + "; ".join(parts))
    return k1


def phase_llama_train(seed: int, smi: str, data: np.ndarray) -> dict:
    """Llama-3 8B's width and vocab at 2 layers through the port's Trainer
    (bf16 compute, fp32 master weights drawn on the card): 10 steps at
    b4 x T1024, losses finite and falling; K1, the pre-pass, K2 and K3
    launched n_layer x steps times each.  Returns the launches."""
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layer=2)
    steps = 10
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=2)
    trainer = Trainer(cfg, tcfg, seed=seed, device="cuda")
    batches = batch_iterator(data, 4, 1024, seed=seed, device="cuda")
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    history = trainer.fit(batches, log=lambda line: None)
    torch.cuda.synchronize()
    launches = dict(FA.KERNEL_LAUNCHES)
    losses = [r["train_loss"] for r in history]
    say(f"[llama-train] Llama-3 8B widths (vocab {cfg.vocab_size}, width {cfg.n_embd}, GQA "
        f"{cfg.n_head}/{cfg.n_kv_head} D{cfg.head_dim}), {cfg.n_layer} layers, bf16 compute, fp32 master weights; "
        f"synthetic_corpus char ids at b4 x T1024, {steps} steps: losses {' '.join(f'{x:.3f}' for x in losses)}")
    ok = len(losses) == steps and all(np.isfinite(losses)) and float(np.mean(losses[-3:])) < losses[0] - 0.5
    if not ok:
        raise AssertionError("[llama-train] losses not finite, or the last 3 not 0.5 nat below the first")
    want = cfg.n_layer * steps
    for key in TRAINING_KERNELS:
        if launches[key] != want:
            raise AssertionError(f"[llama-train] {key} launched {launches[key]} times, want {want}")
    step_ms = np.diff([0.0] + [r["wall_s"] for r in history]) * 1e3
    med = float(np.median(step_ms[2:]))
    say(f"[llama-train] mean of the last 3 losses {np.mean(losses[-3:]):.3f} < first {losses[0]:.3f} - 0.5: ok; "
        f"launches { {k: launches[k] for k in TRAINING_KERNELS} } = {cfg.n_layer} layers x {steps} steps each")
    say(f"[llama-train] {smi} | step {med:.2f} ms (median of steps 3-{steps}), {4 * 1024 / med * 1e3:.0f} tokens/s, "
        f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del trainer
    torch.cuda.empty_cache()
    return {k: launches[k] for k in TRAINING_KERNELS}


def phase_serving_wquant(seed: int, model: GPT, smi: str) -> int:
    """GPT-2 124M with int8 weight-only projections (quantized in place) on
    an fp8 cache decoding through K6: one prompt's prefill logits against
    the bf16 model's within the quantization's error (relative L2 <= 0.05:
    int8 per-channel rounding puts about 1-2% relative noise on each
    product), then the serving burst, K6 launched n_layer x decode steps.
    Returns K6's launches."""
    cfg = model.cfg
    prompt = torch.as_tensor(np.random.default_rng(seed + 11).integers(0, cfg.vocab_size, 300), device="cuda")

    def logits():
        cache = init_cache(cfg.n_layer, 1, cfg.kv_heads, 1024, cfg.head_dim, dtype=cfg.dtype, device="cuda")
        return prefill(model, prompt, cache, 0)[1]

    ref = logits()
    quantize_gpt_params(model, bits=8)
    out = logits()
    rel = ((out - ref).norm() / ref.norm()).item()
    ok = rel <= 0.05 and bool(torch.isfinite(out).all())
    say(f"[serving-wquant] GPT-2 124M int8 weight-only (wqkv, wo, wfc, wproj): prefill logits of a 300-token prompt "
        f"vs the bf16 model: max |err| {(out - ref).abs().max().item():.4f}, relative L2 {rel:.4f} (bound 0.05), "
        f"argmax {'equal' if int(out.argmax()) == int(ref.argmax()) else 'differs'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[serving-wquant] int8 logits outside the quantization's error")
    r = _burst(seed, "serving-wquant", model, kv_quant_dtype=torch.float8_e4m3fn,
               decode_fn=functools.partial(decode_step, attn_impl="fused"))
    want = cfg.n_layer * r["steps"]
    got = r["launches"]["fused_decode"]
    others = {k: v for k, v in r["launches"].items() if k not in ("fused_decode", "flash_fwd") and v}
    if got != want or others:
        raise AssertionError(f"[serving-wquant] fused_decode launched {got} times, want {want}; others {others}")
    say(f"[serving-wquant] int8 weights, fp8 cache, attn_impl=fused: 16/16 requests finished with their exact "
        f"budgets; fused_decode launches {got} = {cfg.n_layer} layers x {r['steps']} decode steps, flash_fwd "
        f"{r['launches']['flash_fwd']} = {cfg.n_layer} x {r['dispatches']} prefill dispatches")
    say(f"[serving-wquant] {smi} | {r['tokens_s']:.1f} tokens/s, TTFT p50 {r['p50'] * 1e3:.1f} ms p95 "
        f"{r['p95'] * 1e3:.1f} ms")
    return got


def phase_timing_llama_d256(seed: int, smi: str) -> dict:
    """K1 at the Llama prefill shape (b1, GQA 32/8, L1024, D128, bf16), and
    the D256 kernels at b8 h12 L1024 bf16 (K4 on int8 K/V, `_time_family`),
    each as device time (graph_ms) beside its plain version, its bound and
    torch SDPA's forward / backward at the same shape.  Returns {"llama":
    K1's row, kernel: row} for the D256 kernels."""
    gen = torch.Generator().manual_seed(seed + 12)
    bf16 = torch.bfloat16
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    result = {}
    q = _rand(gen, (1, 32, 1024, 128), bf16)
    k, v = (_rand(gen, (1, 8, 1024, 128), bf16) for _ in range(2))
    flops = 4 * 32 * 1024 * 1024 * 128 / 2
    with torch.no_grad():
        kern = graph_ms(lambda: FA.flash_attention(q, k, v))
        plain = graph_ms(lambda: FA.flash_attention_reference(q, k, v), calls=2, runs=5)
        lib = graph_ms(lambda: sdpa(q, k, v, enable_gqa=True))
    bound, by = floor_ms((2 * 32 + 2 * 8) * 1024 * 128 * 2, flops)
    say(f"[timing] {smi} | K1 llama prefill b1 hq32 hkv8 L1024 D128 bf16 causal: kernel {kern:.4f} ms on the device "
        f"({flops / kern / 1e9:.1f} TFLOP/s, {bound / kern:.1%} of the bound {bound:.4f} ms, {by}); plain tile loop "
        f"{plain:.4f} ms; library torch SDPA forward (enable_gqa) {lib:.4f} ms (K1 / SDPA {kern / lib:.2f}x)")
    result["llama"] = dict(ms=kern, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib)

    for name, row in _time_family(gen, smi, "D256", 8, 12, 1024, 256, bf16, BF16_FLOPS, True).items():
        result[f"{name}_d256"] = row
    return result


def _time_family(gen, smi: str, label: str, b: int, h: int, L: int, d: int, dtype, peak: float, plain: bool) -> dict:
    """K1, the pre-pass, K2, K3 and K4 (int8) at [b, h, L, d] causal (d one
    of the padded head dims), device ms (graph_ms), beside the plain
    versions (when `plain`), the bounds at `peak` FLOP/s and torch SDPA's
    forward / backward.  Returns {kernel: row}."""
    q, k, v, do = (_rand(gen, (b, h, L, d), dtype) for _ in range(4))
    elems, rows = b * h * L * d, b * h * L
    flops = 4 * b * h * L * L * d / 2
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, is_causal=True)
    spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None, blocks=FA.default_blocks(L, L, d, dtype=dtype))
    kv = QK.quantize_kv(k.float(), v.float())
    with torch.no_grad():
        o, lse = FA._launch(q, k, v, spec, None, True)
        f_ms = graph_ms(lambda: FA._launch(q, k, v, spec, None, False), calls=5, runs=5)
        k4 = graph_ms(lambda: QK._launch(q, kv, True, d ** -0.5, None, None), calls=5, runs=5)
        f_lib = graph_ms(lambda: sdpa(q, k, v), calls=5, runs=5)
    args = FA._bwd_args(q, k, v, o, lse, do, None, spec, None)
    FA._launch_bwd_prep(args)
    pre = graph_ms(lambda: FA._launch_bwd_prep(args))
    k2 = graph_ms(lambda: FA._launch_bwd_dkv(args), calls=3, runs=5)
    k3 = graph_ms(lambda: FA._launch_bwd_dq(args), calls=2, runs=3)
    b_lib = graph_ms(_grad_fn(sdpa, q, k, v, do), calls=2, runs=3)
    p = [None] * 5
    if plain:
        with torch.no_grad():
            p = [graph_ms(fn, calls=1, runs=3) for fn in (
                lambda: FA.flash_attention_reference(q, k, v),
                lambda: FA.flash_attention_bwd_prep_reference(q, o, do, sm_scale=d ** -0.5),
                lambda: FA.flash_attention_bwd_dkv_reference(q, k, v, o, lse, do),
                lambda: FA.flash_attention_bwd_dq_reference(q, k, v, o, lse, do),
                lambda: QK.flash_attention_kv_quant_reference(q, kv),
            )]
    eb = q.element_size()
    rate = ", 3xTF32" if peak == TF32X3_FLOPS else ""  # what an "operations" bound is counted at
    rows_ = {
        "flash_fwd": (f_ms, p[0], floor_ms(4 * elems * eb, flops, peak), f_lib),
        # o and dO read, di written; q read and qs written where the
        # backward reads qs (16-bit inputs up to head dim 256)
        "flash_bwd_prep": (pre, p[1], floor_ms((2 + 2 * (args["qs"] is not None)) * elems * eb + rows * 4), None),
        "flash_bwd_dkv": (k2, p[2], floor_ms(6 * elems * eb + 2 * rows * 4, 2 * flops, peak), b_lib),
        "flash_bwd_dq": (k3, p[3], floor_ms(5 * elems * eb + 2 * rows * 4, 1.5 * flops, peak), b_lib),
        "flash_fwd_kv_quant": (k4, p[4], floor_ms(rows * (d * (2 * eb + 2) + 8), flops, peak), None),
    }
    say(f"[timing] {smi} | {label} b{b} h{h} L{L} D{d} {dtype} causal, ms on the device (share of the bound; plain "
        f"version): " + "; ".join(
            f"{name} {ms:.4f} ({bd / ms:.1%} of {bd:.4f} ms, {by}{rate if by == 'operations' else ''}; plain "
            f"{'not measured' if pl is None else f'{pl:.4f}'})" for name, (ms, pl, (bd, by), _) in rows_.items())
        + f"; library torch SDPA forward {f_lib:.4f} ms, backward {b_lib:.4f} ms (K1 / SDPA {f_ms / f_lib:.2f}x, "
          f"K2 / SDPA backward {k2 / b_lib:.2f}x, pre-pass + K2 + K3 / SDPA backward {(pre + k2 + k3) / b_lib:.2f}x)")
    return {name: dict(ms=ms, plain_ms=pl, bound_ms=bd, bound_by=by, library_ms=lib)
            for name, (ms, pl, (bd, by), lib) in rows_.items()}


# Device ms of the 16-bit SIMT forward that the wide wgmma K1 and K4
# replaced, at b8 h12 L1024 bf16 causal, {key: (D512, D1024)}: the earlier
# times in PERF.md's kernel table, read by this script's timing phase while
# that kernel still ran (NVIDIA H100 80GB HBM3, 700.00 W).  No run can
# measure them now, so they stand on the [timing] line only, as the earlier
# reading, and never in the kernels line.
SIMT_16BIT_MS = {"flash_fwd_wide": (14.1363, 41.5888), "flash_fwd_kv_quant_wide": (12.7607, 34.0706)}
# Device ms of the 16-bit SIMT K2 / K3 that the wide wgmma backward replaced,
# at b8 h12 L1024 bf16 causal, {key: (D512, D1024)}, read the same way (the
# timing phase of an earlier run, NVIDIA H100 80GB HBM3, 700.00 W): printed
# on the [timing] line only.
SIMT_16BIT_BWD_MS = {"flash_bwd_dkv_wide": (20.5184, 51.6841), "flash_bwd_dq_wide": (19.3413, 51.7461)}
# Device ms of the fp32 SIMT K2 / K3 that the 3xTF32 kernels replaced, at b8
# h12 L1024 fp32 causal, {key: (D64, D128)}, read the same way (NVIDIA H100
# 80GB HBM3, 700.00 W): printed on the [timing] line only.
SIMT_FP32_BWD_MS = {"flash_bwd_dkv_fp32": (3.1288, 21.2925), "flash_bwd_dq_fp32": (2.6852, 11.2136)}
# Device ms of the fp32 SIMT K1 / K4 that the 3xTF32 forward replaced, at b8
# h12 L1024 fp32 causal (K4 on int8 K/V), {key: (D64, D128)}, read the same
# way (NVIDIA H100 80GB HBM3, 700.00 W): printed on the [timing] line only.
SIMT_FP32_FWD_MS = {"flash_fwd_fp32": (1.4926, 3.3879), "flash_fwd_kv_quant_fp32": (1.5631, 3.5028)}
# Device ms of the fp32 SIMT K1 / K4 that the 3xTF32 forward of
# csrc/flash_fwd_fp32_wide.cuh replaced, at b8 h12 L1024 fp32 causal (K4 on
# int8 K/V), {kernel: (D256, D512, D1024)}, read the same way (NVIDIA H100
# 80GB HBM3, 700.00 W; D256 and D512 in one run, D1024 in a later one):
# printed on the [timing] line only.
SIMT_FP32_WIDE_FWD_MS = {"flash_fwd": (5.4546, 12.1646, 39.3718), "flash_fwd_kv_quant": (5.6516, 12.7133, 31.4340)}
# Device ms of the fp32 SIMT K2 / K3 that the 3xTF32 backward of
# csrc/flash_bwd_fp32_wide.cuh replaced, at b8 h12 L1024 fp32 causal,
# {kernel: (D256, D512, D1024)}, read the same way (NVIDIA H100 80GB HBM3,
# 700.00 W; D256 in one run, D512 in a later one, D1024 in a third):
# printed on the [timing] line only.
SIMT_FP32_WIDE_BWD_MS = {"flash_bwd_dkv": (8.6335, 18.8348, 47.9969), "flash_bwd_dq": (7.5863, 16.8841, 42.1545)}


def phase_timing_wide(seed: int, smi: str) -> tuple[dict, dict]:
    """The kernels of head dims above 128 that the D256 timing does not
    cover, and fp32 at 64 and 128, at b8 h12 L1024 (every tensor above L2's
    50 MB, as at the D256 timing shape): fp32 at D256 (the "_d256_fp32" rows
    of the 3xTF32 K1, K4, K2 and K3);
    bf16 at D512 (the "_wide" rows: the wide wgmma K1, K4, K2 and
    K3 and the pre-pass; they carry the D1024 times beside them as
    d1024_*), with K1's and K4's speed-up over the SIMT forward they
    replaced (SIMT_16BIT_MS, an earlier reading, printed on the [timing]
    line only) and K1's ratio to SDPA's forward, and K2's and K3's beside
    their bounds, SDPA's whole backward and the SIMT K2 / K3 they replaced
    (SIMT_16BIT_BWD_MS, printed only); fp32 at D512 (the "_wide_fp32"
    rows of the 3xTF32 K1, K4, K2 and K3; they carry the D1024 times, no
    plain run, beside them as d1024_*), and the 3xTF32 K1 with lse
    (lse_ms) and K4 over fp8 (fp8_ms) at D256, D512 and D1024, printed
    beside their bounds, SDPA's fp32 forward and the SIMT forward they
    replaced (SIMT_FP32_WIDE_FWD_MS, an earlier reading, printed only), and
    the pre-pass, K2 and K3 there beside their bounds, SDPA's fp32 whole
    backward (pre-pass + K2 + K3 against it) and the SIMT K2 / K3 they
    replaced (SIMT_FP32_WIDE_BWD_MS, printed only); fp32 at D64 and D128
    (K1, K4, the pre-pass, K2, K3 in the entry points' fp32 kernels, SDPA
    fp32): the
    "_fp32" rows of the 3xTF32 K1, K4, K2 and K3 (D64, with the D128
    times beside them as d128_*; K1 also with lse as lse_ms), with their
    speed-up over the SIMT kernels they replaced (SIMT_FP32_FWD_MS,
    SIMT_FP32_BWD_MS, printed only) and K1's ratio to SDPA's fp32
    forward.  Every fp32 bound is at the 3xTF32 rate.  Returns
    ({kernel: row}, {"flash_bwd_prep": {"fp32_d64": row, "fp32_d128":
    row}})."""
    gen = torch.Generator().manual_seed(seed + 13)
    f32, bf16 = torch.float32, torch.bfloat16
    result = {}
    fwd_names, bwd_names = ("flash_fwd", "flash_fwd_kv_quant"), ("flash_bwd_dkv", "flash_bwd_dq")
    launched = {_key(name, d, f32): FA.KERNEL_LAUNCHES[_key(name, d, f32)]
                for name in (*fwd_names, *bwd_names) for d in (256, 512)}
    d256 = _time_family(gen, smi, "fp32 (the 3xTF32 K1, K4, K2 and K3)", 8, 12, 1024, 256, f32, TF32X3_FLOPS, True)
    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_kv_quant"):
        result[_key(name, 256, f32)] = d256[name]
    wide = _time_family(gen, smi, "padded head dim 512 (the wide wgmma K1, K4, K2, K3)", 8, 12, 1024, 512, bf16,
                        BF16_FLOPS, True)
    wide1024 = _time_family(gen, smi, "padded head dim 1024 (the wide wgmma K1, K4, K2, K3)", 8, 12, 1024, 1024,
                            bf16, BF16_FLOPS, False)
    for name, row in wide.items():
        row.update({f"d1024_{k}": v for k, v in wide1024[name].items() if k != "plain_ms"})
        result[f"{name}_wide"] = row
    for key, simt in SIMT_16BIT_MS.items():
        row = result[key]
        parts = []
        for tag, pre in (("D512", ""), ("D1024", "d1024_")):
            ms, bound = row[f"{pre}ms"], row[f"{pre}bound_ms"]
            old = simt[0 if tag == "D512" else 1]
            lib = row[f"{pre}library_ms"]
            sdpa = f"; SDPA forward {lib:.4f} ms, {key} / SDPA {ms / lib:.2f}x" if lib else ""
            parts.append(f"{tag} {ms:.4f} ms ({bound / ms:.1%} of the bound {bound:.4f} ms; the SIMT forward's "
                         f"{old} ms, read in an earlier run, not this one, {old / ms:.1f}x{sdpa})")
        say(f"[timing] {smi} | wide wgmma {key} b8 h12 L1024 bf16 causal: " + "; ".join(parts))
    for tag, pre in (("D512", ""), ("D1024", "d1024_")):
        prep, k2, k3 = (result[k][f"{pre}ms"] for k in ("flash_bwd_prep_wide", *SIMT_16BIT_BWD_MS))
        lib = result["flash_bwd_dkv_wide"][f"{pre}library_ms"]
        parts = []
        for key, simt in SIMT_16BIT_BWD_MS.items():
            ms, bound = result[key][f"{pre}ms"], result[key][f"{pre}bound_ms"]
            old = simt[0 if tag == "D512" else 1]
            parts.append(f"{key} {ms:.4f} ms ({bound / ms:.1%} of the bound {bound:.4f} ms, operations; the SIMT "
                         f"kernel's {old} ms, read in an earlier run, not this one, {old / ms:.1f}x)")
        say(f"[timing] {smi} | wide wgmma backward {tag} b8 h12 L1024 bf16 causal: " + "; ".join(parts)
            + f"; pre-pass {prep:.4f} ms; pre-pass + K2 + K3 {prep + k2 + k3:.4f} ms against SDPA's whole backward "
              f"{lib:.4f} ms: {(prep + k2 + k3) / lib:.2f}x")
    fp32_wide = _time_family(gen, smi, "fp32, padded head dim 512 (the 3xTF32 K1, K4, K2 and K3)", 8, 12, 1024, 512,
                             f32, TF32X3_FLOPS, True)
    fp32_1024 = _time_family(gen, smi, "fp32, padded head dim 1024 (the 3xTF32 K1, K4, K2 and K3)", 8, 12, 1024,
                             1024, f32, TF32X3_FLOPS, False)
    for name in ("flash_fwd", "flash_fwd_kv_quant", "flash_bwd_dkv", "flash_bwd_dq"):
        key = _key(name, 512, f32)
        result[key] = fp32_wide[name]
        result[key].update({f"d1024_{k}": v for k, v in fp32_1024[name].items() if k != "plain_ms"})
    # the 3xTF32 K1 with lse, as the autograd Function's forward runs it,
    # and K4 over fp8 K/V, at each padded head dim
    for d, pre in ((256, ""), (512, ""), (1024, "d1024_")):
        q, k, v = (_rand(gen, (8, 12, 1024, d), f32) for _ in range(3))
        spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None,
                        blocks=FA.default_blocks(1024, 1024, d, dtype=f32))
        kv8 = QK.quantize_kv(k, v, dtype=torch.float8_e4m3fn)
        with torch.no_grad():
            result[_key("flash_fwd", d, f32)][f"{pre}lse_ms"] = graph_ms(
                lambda: FA._launch(q, k, v, spec, None, True), calls=5, runs=5)
            result[_key("flash_fwd_kv_quant", d, f32)][f"{pre}fp8_ms"] = graph_ms(
                lambda: QK._launch(q, kv8, True, d ** -0.5, None, None), calls=5, runs=5)
        del q, k, v, kv8
    launched = {key: FA.KERNEL_LAUNCHES[key] - n for key, n in launched.items()}
    if not all(launched.values()):
        raise AssertionError(f"[timing] the fp32 timing launched {launched}: a 3xTF32 kernel did not run")
    for name in fwd_names:
        parts = []
        for i, (tag, d, pre) in enumerate((("D256", 256, ""), ("D512", 512, ""), ("D1024", 512, "d1024_"))):
            row, old = result[_key(name, d, f32)], SIMT_FP32_WIDE_FWD_MS[name][i]
            ms, bound, lib = row[f"{pre}ms"], row[f"{pre}bound_ms"], row[f"{pre}library_ms"]
            note = (f", with lse {row[f'{pre}lse_ms']:.4f} ms; SDPA's fp32 forward {lib:.4f} ms, {name} / SDPA "
                    f"{ms / lib:.2f}x" if name == "flash_fwd" else f", over fp8 {row[f'{pre}fp8_ms']:.4f} ms")
            parts.append(f"{tag} {ms:.4f} ms ({bound / ms:.1%} of the bound {bound:.4f} ms, operations, 3xTF32; the "
                         f"SIMT forward's {old} ms, read in an earlier run, not this one, {old / ms:.1f}x{note})")
        say(f"[timing] {smi} | 3xTF32 {name} above head dim 128, b8 h12 L1024 fp32 causal (launched {launched}): "
            + "; ".join(parts))
    for i, (tag, fam) in enumerate((("D256", d256), ("D512", fp32_wide), ("D1024", fp32_1024))):
        prep, k2, k3 = (fam[name]["ms"] for name in ("flash_bwd_prep", *bwd_names))
        lib = fam["flash_bwd_dkv"]["library_ms"]
        parts = []
        for name in bwd_names:
            ms, bound, old = fam[name]["ms"], fam[name]["bound_ms"], SIMT_FP32_WIDE_BWD_MS[name][i]
            parts.append(f"{name} {ms:.4f} ms ({bound / ms:.1%} of the bound {bound:.4f} ms, operations, 3xTF32; the "
                         f"SIMT kernel's {old} ms, read in an earlier run, not this one, {old / ms:.1f}x)")
        say(f"[timing] {smi} | 3xTF32 backward {tag} b8 h12 L1024 fp32 causal: " + "; ".join(parts)
            + f"; pre-pass {prep:.4f} ms; pre-pass + K2 + K3 {prep + k2 + k3:.4f} ms against SDPA's fp32 whole "
              f"backward {lib:.4f} ms: {(prep + k2 + k3) / lib:.2f}x")
    extra: dict = {}
    _reset_launches()
    lse_ms = {}
    for d in (64, 128):
        rows = _time_family(gen, smi, f"fp32 D{d} (the entry points' 3xTF32 kernels)", 8, 12, 1024, d, f32,
                            TF32X3_FLOPS, True)
        # K1 with lse, as the autograd Function's forward runs it
        q, k, v = (_rand(gen, (8, 12, 1024, d), f32) for _ in range(3))
        spec = FA._Spec(causal=True, sm_scale=d ** -0.5, window=None, blocks=FA.default_blocks(1024, 1024, d, dtype=f32))
        with torch.no_grad():
            lse_ms[d] = graph_ms(lambda: FA._launch(q, k, v, spec, None, True), calls=5, runs=5)
        del q, k, v
        for name, row in rows.items():
            if name == "flash_bwd_prep":
                extra.setdefault(name, {})[f"fp32_d{d}"] = row
                continue
            key = f"{name}_fp32"
            if d == 64:
                result[key] = row
            else:
                result[key].update({f"d128_{k}": v for k, v in row.items()})
    result["flash_fwd_fp32"].update(lse_ms=lse_ms[64], d128_lse_ms=lse_ms[128])
    counts = {key: FA.KERNEL_LAUNCHES[key] for key in (*FP32_FWD_KERNELS, *FP32_BWD_KERNELS)}
    if not all(counts.values()):
        raise AssertionError(f"[timing] the fp32 timing launched {counts}: a 3xTF32 kernel did not run")
    for key, (d64, d128) in {**SIMT_FP32_FWD_MS, **SIMT_FP32_BWD_MS}.items():
        row = result[key]
        lib = (f"; SDPA's fp32 forward {row['library_ms']:.4f} / {row['d128_library_ms']:.4f} ms, {key} / SDPA "
               f"{row['ms'] / row['library_ms']:.2f}x / {row['d128_ms'] / row['d128_library_ms']:.2f}x"
               if key == "flash_fwd_fp32" else "")
        with_lse = (f"; with lse {row['lse_ms']:.4f} / {row['d128_lse_ms']:.4f} ms" if key == "flash_fwd_fp32"
                    else "")
        say(f"[timing] {smi} | 3xTF32 {key} b8 h12 L1024 fp32 causal (launched {counts[key]} times in this timing, "
            f"graph captures included): D64 {row['ms']:.4f} ms, D128 {row['d128_ms']:.4f} ms; the SIMT kernel's "
            f"{d64} / {d128} ms, read in an earlier run, not this one: {d64 / row['ms']:.1f}x / "
            f"{d128 / row['d128_ms']:.1f}x; bound {row['bound_ms']:.4f} / {row['d128_bound_ms']:.4f} ms "
            f"({row['bound_by']}, 3xTF32; {row['bound_ms'] / row['ms']:.1%} / "
            f"{row['d128_bound_ms'] / row['d128_ms']:.1%} of it){lib}{with_lse}")
    return result, extra


AT = importlib.import_module("flash_attention_tpu_torch.kernels.autotune")


class _TileRecorder:
    """Within the block, records the block_q (the last argument) of every
    fa_flash_fwd launch, the real launch still made."""

    def __enter__(self):
        self.tiles, self._real = [], FA._call

        def record(entry, device, *args):
            if entry == "fa_flash_fwd":
                self.tiles.append(args[-1])
            self._real(entry, device, *args)

        FA._call = record
        return self

    def __exit__(self, *exc):
        FA._call = self._real


def phase_measure(seed: int, smi: str) -> dict:
    """utils.measure on K1 at GPT-2's training shape: chain_timer, and
    ab_compare over K1's tiles with the recheck's drift band, beside
    graph_ms of the same call and K1's bound; a time at or below the bound
    is impossible and fails."""
    gen = torch.Generator().manual_seed(seed + 8)
    b, h, L, d = 8, 12, 1024, 64
    q, k, v = (_rand(gen, (b, h, L, d), torch.bfloat16) for _ in range(3))
    bound, by = floor_ms(4 * b * h * L * d * 2, 4 * b * h * L * L * d / 2)
    variants = {f"k1 block_q {bq}": (lambda c, kk, vv, bq=bq: FA.flash_attention(
        c, kk, vv, block_sizes=dataclasses.replace(FA.default_blocks(L, L, d), block_q=bq))) for bq in FA.K1_TILES[d]}
    with torch.no_grad():
        chain = chain_timer(lambda c, kk, vv: FA.flash_attention(c, kk, vv), q, k, v, depth=64, iters=5) * 1e3
        ab = {name: t * 1e3 for name, t in ab_compare(variants, q, k, v, depth=64, iters=5).items()}
        graph = graph_ms(lambda: FA.flash_attention(q, k, v))
    base = next(iter(variants))
    drift = abs(ab[base] - ab[f"{base}+recheck"]) / ab[base]
    say(f"[measure] {smi} | K1 b{b} h{h} L{L} D{d} bf16 causal, device ms a call: chain_timer (depth 64, best of 5) "
        f"{chain:.4f}; graph_ms {graph:.4f}; ab_compare " + ", ".join(f"{n} {t:.4f}" for n, t in ab.items())
        + f"; drift band {drift:.1%}; bound {bound:.4f} ({by})")
    for name, t in {"chain_timer": chain, "graph_ms": graph, **ab}.items():
        if not t > bound:
            raise AssertionError(f"[measure] {name} read {t:.4f} ms, at or below the bound {bound:.4f} ms")
    return dict(chain_ms=chain, graph_ms=graph, ab_ms=ab, drift=drift)


def phase_memory(smi: str) -> dict:
    """utils.profiling.memory_report on the card: dense attention against
    the CUDA K1 at the reference's OOM shape, flash's growth from L2048 to
    L4096, and the reference's own foil: dense runs out of memory at b1 h16
    L65536 where flash runs."""
    mib = 2**20
    b, h, L, d = 1, 16, 2048, 64
    q = torch.zeros(b, h, L, d, device="cuda")
    with torch.no_grad():
        dense = memory_report(lambda q, k, v: vanilla_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
        flash = memory_report(lambda q, k, v: FA.flash_attention(q, k, v, causal=True, sm_scale=1.0), q, q, q)
    scores = b * h * L * L * 4
    ok = dense.temp_bytes >= scores and flash.temp_bytes * 4 <= dense.temp_bytes
    say(f"[memory] {smi} | b{b} h{h} L{L} D{d} fp32: dense {dense}; flash (K1) {flash}; scores {scores / mib:.0f} "
        f"MiB; dense temps >= scores and flash temps <= a quarter of dense's: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[memory] the OOM shape's temps")
    grow = {}
    with torch.no_grad():
        for L2 in (2048, 4096):
            x = torch.zeros(1, 4, L2, 128, device="cuda", dtype=torch.bfloat16)
            grow[L2] = memory_report(lambda x: FA.flash_attention(x, x, x), x)
    t_ok = grow[4096].temp_bytes <= 3 * grow[2048].temp_bytes
    p_ok = grow[4096].allocator_peak_bytes < 3 * grow[2048].allocator_peak_bytes
    say(f"[memory] flash b1 h4 D128 bf16: L2048 {grow[2048]}; L4096 {grow[4096]}; temps and allocator peak grow "
        f"less than 3x: {'ok' if t_ok and p_ok else 'FAIL'}")
    if not (t_ok and p_ok):
        raise AssertionError("[memory] flash's memory grew 3x or more from L2048 to L4096")
    L = 65536
    x = _rand(torch.Generator().manual_seed(5), (1, 16, L, 64), torch.bfloat16)
    try:
        with torch.no_grad():
            vanilla_attention(x, x, x, causal=True)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        oom = str(exc).split("\n")[0][:160]
    else:
        raise AssertionError(f"[memory] dense attention at b1 h16 L{L} D64 bf16 did not run out of memory")
    torch.cuda.empty_cache()
    with torch.no_grad():
        rep = memory_report(lambda x: FA.flash_attention(x, x, x), x)
        out = FA.flash_attention(x, x, x)
    torch.cuda.synchronize()
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise AssertionError("[memory] flash at L65536 gave a bad output")
    say(f"[memory] b1 h16 L{L} D64 bf16: dense ran out of memory ({oom}); flash ran, {rep} "
        f"(scores alone would be {16 * L * L * 4 / 2**30:.0f} GiB in fp32 against "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.0f} GiB)")
    return dict(dense=dense, flash=flash, grow=grow, foil=rep)


# (label, batch, q heads, KV heads, length, head dim) of the autotune phase
AUTOTUNE_SHAPES = (
    *((f"gpt2 prefill b1 h12 L{n} D64", 1, 12, 12, n, 64) for n in (128, 256, 512, 1024)),
    ("llama3-8b prefill b1 gqa 32/8 L1024 D128", 1, 32, 8, 1024, 128),
    ("gpt2 train b8 h12 L1024 D64", 8, 12, 12, 1024, 64),
)


def phase_autotune(seed: int, smi: str, data: np.ndarray) -> tuple[dict, float, dict, dict]:
    """kernels.autotune on the card, the cache in a temporary directory:
    at each AUTOTUNE_SHAPES entry every candidate tile of K1 against the
    plain version at the same tile, its device ms, the sweep's winner, and a
    default flash_attention launching the winner's block_q; then the
    engine's warmup_autotune and a Trainer with autotune_blocks on GPT-2 124M
    hit the cache (no sweep launches) and launch the winners.  Beside each
    shape's tiles, torch SDPA's device ms for the same function.  Returns
    ({shape: {block_q: ms}}, the worst error, the path's launches, {shape:
    SDPA ms})."""
    gen = torch.Generator().manual_seed(seed + 9)
    tiles, winners, worst, library = {}, {}, 0.0, {}
    AT.clear_cache()
    for label, b, hq, hkv, L, d in AUTOTUNE_SHAPES:
        q = _rand(gen, (b, hq, L, d), torch.bfloat16)
        k, v = (_rand(gen, (b, hkv, L, d), torch.bfloat16) for _ in range(2))
        row = {}
        with torch.no_grad():
            for bs in AT.candidate_blocks(L, L, d, hq // hkv, torch.bfloat16):
                with _TileRecorder() as rec:
                    out = FA.flash_attention(q, k, v, block_sizes=bs)
                plain, _ = FA.flash_attention_reference(q, k, v, block_sizes=bs)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                worst = max(worst, err)
                if rec.tiles != [bs.block_q] or not err <= 2e-2:
                    raise AssertionError(f"[autotune] {label} block_q {bs.block_q}: launched {rec.tiles}, "
                                         f"error {err:.3e} against the plain version (atol 2e-2)")
                row[bs.block_q] = graph_ms(lambda bs=bs: FA.flash_attention(q, k, v, block_sizes=bs))
            best = AT.autotune(q, k, v)
            with _TileRecorder() as rec:
                FA.flash_attention(q, k, v)
            library[label] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hq != hkv))
        if rec.tiles != [best.block_q]:
            raise AssertionError(f"[autotune] {label}: the default path launched {rec.tiles}, the winner is "
                                 f"{best.block_q}")
        tiles[label], winners[label] = row, best.block_q
        say(f"[autotune] {smi} | {label} bf16: device ms by block_q " + ", ".join(
            f"{bq} {ms:.4f}" for bq, ms in row.items()) + f"; each vs plain <= 2e-2 (worst so far {worst:.2e}); "
            f"autotune's winner {best.block_q} (chain_timer), which the default path launches; library torch "
            f"SDPA {library[label]:.4f}")
    cfg = GPT2_124M
    eng = InferenceEngine(_gpt2(seed), slots=2, max_len=1024, device="cuda")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 1000).tolist()
    _reset_launches()
    with _TileRecorder() as rec:
        eng.warmup_autotune()
        swept = FA.KERNEL_LAUNCHES["flash_fwd"]
        eng.submit(prompt, max_new_tokens=4)
        eng.run()
        torch.cuda.synchronize()
    launches = dict(FA.KERNEL_LAUNCHES)
    want = winners["gpt2 prefill b1 h12 L1024 D64"]
    ok = swept == 0 and rec.tiles == [want] * cfg.n_layer
    say(f"[autotune] engine.warmup_autotune() on GPT-2 124M (buckets {eng.buckets}): {swept} K1 launches (every "
        f"bucket a cache hit); then a 1000-token prompt: K1 launched {rec.tiles.count(want)} of {cfg.n_layer} "
        f"times at the L1024 winner {want}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[autotune] engine: {swept} sweep launches, prefill tiles {rec.tiles}")
    del eng
    steps, logs = 3, []
    tcfg = TrainerConfig(max_iters=steps, log_interval=1, learning_rate=6e-4, warmup_iters=1, autotune_blocks=True)
    trainer = Trainer(cfg, tcfg, seed=seed, device="cuda")
    _reset_launches()
    with _TileRecorder() as rec:
        trainer.fit(batch_iterator(data, 8, 1024, seed=seed, device="cuda"), log=logs.append)
        torch.cuda.synchronize()
    train_launches = dict(FA.KERNEL_LAUNCHES)
    want = winners["gpt2 train b8 h12 L1024 D64"]
    line = next((x for x in logs if "autotuned attention blocks" in x), None)
    n = cfg.n_layer * steps
    ok = (line is not None and rec.tiles == [want] * n
          and all(train_launches[key] == n for key in TRAINING_KERNELS))
    say(f"[autotune] Trainer(autotune_blocks=True) GPT-2 124M b8 x T1024, {steps} steps: logged {line!r}; K1 "
        f"launched {len(rec.tiles)} times (no sweep), each at the winner {want}; K2/K3 and the pre-pass "
        f"{[train_launches[key] for key in TRAINING_KERNELS[1:]]}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[autotune] trainer: tiles {rec.tiles}, launches {train_launches}, log {line!r}")
    del trainer
    AT.clear_cache()
    return tiles, worst, {"engine": launches["flash_fwd"], "trainer": train_launches["flash_fwd"]}, library


RA = importlib.import_module("flash_attention_tpu_torch.parallel.ring_attention")
# The ring phase's full-width shapes: (label, b, hq, hkv, L, d) over a ring
# of RING_N ranks; GPT-2 124M's heads at 4096 tokens, Llama-3 8B's at 8192.
RING_N = 4
RING_SHAPES = (("gpt2 heads b8 h12 L4096 D64", 8, 12, 12, 4096, 64),
               ("llama3-8b heads b1 GQA 32/8 L8192 D128", 1, 32, 8, 8192, 128))


def _ring_shards(x: torch.Tensor, n: int, zigzag: bool) -> list:
    """Every rank's shard of x [B, H, L, D] (zig-zag chunk order if asked)."""
    if zigzag:
        x = x.index_select(2, RA.zigzag_indices(x.shape[2], n).to(x.device))
    return [c.contiguous() for c in x.chunk(n, dim=2)]


def _ring_unshard(parts: list, n: int, zigzag: bool) -> torch.Tensor:
    x = torch.cat(parts, dim=2)
    return x.index_select(2, RA.zigzag_inverse(x.shape[2], n).to(x.device)) if zigzag else x


class _RingSim:
    """Ring attention's schedule for every rank of an n-ring in one process,
    through the rank-local step functions (RA.ring_fwd_step,
    RA.ring_bwd_step, RA.merge_partials): rank `my` at step s holds the KV
    shard of rank (my - s) mod n, as the rotations would give it."""

    def __init__(self, q, k, v, do, n: int, zigzag: bool):
        self.n, self.zigzag, self.dtype = n, zigzag, q.dtype
        self.q, self.k, self.v, self.do = (_ring_shards(x, n, zigzag) for x in (q, k, v, do))
        self.kw = dict(causal=True, zigzag=zigzag, sm_scale=q.shape[-1] ** -0.5)

    def forward(self):
        self.o, self.lse = [], []
        for my in range(self.n):
            o_acc, lse_acc = RA._empty_partial(self.q[my])
            for step in range(self.n):
                src = (my - step) % self.n
                RA.merge_partials(o_acc, lse_acc, RA.ring_fwd_step(self.q[my], self.k[src], self.v[src], src, my,
                                                                   **self.kw))
            self.o.append(o_acc.to(self.dtype))
            self.lse.append(lse_acc)
        return self.o

    def backward(self):
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in self.q]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in self.k]
        dv = [torch.zeros_like(x) for x in dk]
        for my in range(self.n):
            for step in range(self.n):
                src = (my - step) % self.n
                for qr, kr, gq, gk, gv in RA.ring_bwd_step(self.q[my], self.k[src], self.v[src], self.o[my],
                                                           self.lse[my], self.do[my], src, my, **self.kw):
                    dq[my][:, :, qr] += gq.float()
                    dk[src][:, :, kr] += gk.float()
                    dv[src][:, :, kr] += gv.float()
        return dq, dk, dv

    def whole(self, parts: list) -> torch.Tensor:
        return _ring_unshard(parts, self.n, self.zigzag)


def _hold_call(a, b_, c, mo, ml, dd, causal: bool, where: str) -> tuple[float, float]:
    """One ring kernel call on the card against its plain version on the
    same inputs: K1 with lse on (a, b_, c) (Lq < Lk is aligned to the end of
    KV), then, with the merged o and lse (mo, ml) and dO (dd), the pre-pass
    (di, qs), K2 and K3.  Raises outside the bf16 tier (K1 and lse atol
    2e-2, di 1e-3, qs exact, grads 2e-2 x max |grad| of the plain); returns
    (the K1 output's max abs error, the worst grad error of max |grad|)."""
    spec = RA._spec(a, b_, causal, a.shape[-1] ** -0.5, None)
    o, lse = FA._launch(a, b_, c, spec, None, need_lse=True)
    po, plse = FA.flash_attention_reference(a, b_, c, causal=causal, block_sizes=spec.blocks)
    e1 = (o.float() - po.float()).abs().max().item()
    e2 = (lse - plse).abs().max().item()
    args = FA._bwd_args(a, b_, c, mo, ml, dd, None, spec, None)
    FA._launch_bwd_prep(args)
    di, qs = FA.flash_attention_bwd_prep_reference(a, mo, dd, sm_scale=a.shape[-1] ** -0.5)
    e3 = (args["tensors"][5] - di).abs().max().item()
    e4 = (args["qs"].float() - qs.float()).abs().max().item()
    gk, gv = FA._launch_bwd_dkv(args)
    gq = FA._launch_bwd_dq(args)
    pq, pk, pv = FA.flash_attention_bwd_reference(a, b_, c, mo, ml, dd, causal=causal, block_sizes=spec.blocks)
    eg = max((x.float() - y.float()).abs().max().item() / max(y.float().abs().max().item(), 1e-6)
             for x, y in ((gq, pq), (gk, pk), (gv, pv)))
    torch.cuda.synchronize()
    if not (e1 <= 2e-2 and e2 <= 2e-2 and e3 <= 1e-3 and e4 == 0.0 and eg <= 2e-2):
        raise AssertionError(
            f"[ring] {where} b{a.shape[0]} h{a.shape[1]} q{a.shape[2]} x kv{b_.shape[2]} causal={causal}: K1 {e1:.3e} "
            f"lse {e2:.3e}, pre-pass di {e3:.3e} qs {e4:.3e}, K2/K3 {eg:.3e} of max |grad|")
    return e1, eg


def _check_ring_steps(gen, n: int) -> float:
    """Every kernel call of every step of every rank of an n-ring at b1 h2
    L1024 D64 bf16, contiguous and zig-zag, against its plain version on
    the same inputs (`_hold_call`): K1 with lse (non-causal past shards,
    the causal diagonal, the zig-zag diagonal's Lq = L/2n < Lk = L/n),
    then, with the merged o and lse, the pre-pass (di, qs), K2 and K3.
    Returns the worst K1 error."""
    worst = 0.0
    q, k, v, do = (_rand(gen, (1, 2, 1024, 64), torch.bfloat16) for _ in range(4))
    for zigzag in (False, True):
        sim = _RingSim(q, k, v, do, n, zigzag)
        sim.forward()
        calls = 0
        for my in range(n):
            for step in range(n):
                src = (my - step) % n
                qm, ks, vs = sim.q[my], sim.k[src], sim.v[src]
                for qr, kr, causal in RA.ring_step_calls(src, my, qm.shape[2], ks.shape[2], causal=True,
                                                         zigzag=zigzag):
                    e1, _ = _hold_call(qm[:, :, qr], ks[:, :, kr], vs[:, :, kr], sim.o[my][:, :, qr],
                                       sim.lse[my][:, :, qr], sim.do[my][:, :, qr], causal,
                                       f"{'zigzag' if zigzag else 'contiguous'} rank {my} step {step} (src {src})")
                    calls += 1
                    worst = max(worst, e1)
        say(f"[ring] b1 h2 L1024 D64 bf16, n={n} {'zig-zag' if zigzag else 'contiguous'}: {calls} kernel calls "
            f"(K1 with lse, then pre-pass, K2, K3 on the merged o/lse), each against its plain version: ok "
            f"(worst K1 error so far {worst:.3e}, atol 2e-2)")
    return worst


def phase_ring(seed: int, smi: str) -> tuple[float, dict]:
    """Ring attention's step functions on the card for every rank of a
    4-ring in one process (one card cannot hold two NCCL ranks): each
    step's kernel calls against their plain versions at a small shape, then
    the merged output and q/k/v grads at full width against one K1 and one
    K2/K3 call on the whole sequence, contiguous and zig-zag, with the
    ring's summed device ms beside the one call's; then the call shapes at
    GPT-2's heads that the ring and the context-parallel trainer send, each
    held against its plain version and timed alone beside its bound and
    SDPA (`_time_ring_shapes`).  Returns (the worst K1 error, {kernel:
    {ring timings}})."""
    gen = torch.Generator().manual_seed(seed + 11)
    worst = _check_ring_steps(gen, RING_N)
    ring_ms = {}
    for label, b, hq, hkv, L, d in RING_SHAPES:
        q = _rand(gen, (b, hq, L, d), torch.bfloat16)
        k, v = (_rand(gen, (b, hkv, L, d), torch.bfloat16) for _ in range(2))
        do = _rand(gen, (b, hq, L, d), torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        one = FA.flash_attention(*leaves)
        ref = torch.autograd.grad(one, leaves, do)
        with torch.no_grad():
            one_fwd = graph_ms(lambda: FA.flash_attention(q, k, v), calls=5, runs=5)
        o1, lse1 = FA.flash_attention_with_lse(q, k, v)
        spec = FA._Spec(True, d ** -0.5, None, FA.default_blocks(L, L, d, hq // hkv, dtype=q.dtype))
        one_bwd = graph_ms(lambda: FA._launch_bwd(q, k, v, o1, lse1, do, None, spec, None), calls=5, runs=5)
        for zigzag in (False, True):
            sim = _RingSim(q, k, v, do, RING_N, zigzag)
            out = sim.whole(sim.forward())
            grads = [sim.whole(g) for g in sim.backward()]
            torch.cuda.synchronize()
            e_out = (out.float() - one.float()).abs().max().item()
            e_grad = max((g - r.float()).abs().max().item() / r.float().abs().max().item() for g, r in zip(grads, ref))
            with torch.no_grad():
                fwd_ms = graph_ms(sim.forward, calls=2, runs=5)
            bwd_ms = graph_ms(sim.backward, calls=2, runs=5)
            kind = "zig-zag" if zigzag else "contiguous"
            ok = e_out <= 1e-2 and e_grad <= 2e-2
            say(f"[ring] {smi} | {label} bf16, {RING_N} shards of {L // RING_N}, {kind}: merged output vs one K1 "
                f"call {e_out:.3e} (atol 1e-2), q/k/v grads vs one K2/K3 call {e_grad:.3e} of max |grad| (2e-2): "
                f"{'ok' if ok else 'FAIL'}; device ms, the ring's calls summed over ranks: forward {fwd_ms:.4f} "
                f"(one call {one_fwd:.4f}), backward {bwd_ms:.4f} (one call {one_bwd:.4f})")
            if not ok:
                raise AssertionError(f"[ring] {label} {kind} outside tolerance")
            ring_ms[f"{label} {kind}"] = dict(fwd_ms=fwd_ms, one_call_fwd_ms=one_fwd, bwd_ms=bwd_ms,
                                              one_call_bwd_ms=one_bwd)
        worst = max(worst, e_out)
    shapes, err = _time_ring_shapes(gen, smi, ring_ms)
    return max(worst, err), shapes


def _time_ring_shapes(gen, smi: str, ring_ms: dict) -> tuple[dict, float]:
    """The ring's kernel call shapes at GPT-2's heads (b8 h12 D64 bf16), the
    shapes the context-parallel trainer sends (a zig-zag ring of one rank
    over T1024: q512 x kv512 causal and q512 x kv1024 causal end-aligned)
    and a ring's non-causal past shard (q1024 x kv1024): each call held
    against its plain version on the same inputs (`_hold_call`: K1 with
    lse, then the pre-pass, K2 and K3 with that o and lse, which are the
    merged ones when each query row has one call), then timed as device
    time beside its bound and the library call for the same function (SDPA
    forward; SDPA with a causal or lower-right causal mask; SDPA backward).
    Returns ({kernel: {row: timings}}, the worst K1 error)."""
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, L, d = 8, 12, 1024, 64
    q, k, v, do = (_rand(gen, (b, h, L, d), torch.bfloat16) for _ in range(4))
    held = {}
    for label, qq, kk, vv, dd, causal in (
            ("q1024 x kv1024 non-causal", q, k, v, do, False),
            ("q512 x kv1024 causal end-aligned", q[:, :, L // 2:], k, v, do[:, :, L // 2:], True),
            ("q512 x kv512 causal", q[:, :, :L // 2], k[:, :, :L // 2], v[:, :, :L // 2], do[:, :, :L // 2], True)):
        qq, kk, vv, dd = (x.contiguous() for x in (qq, kk, vv, dd))
        with torch.no_grad():
            o, lse = FA._launch(qq, kk, vv, RA._spec(qq, kk, causal, d ** -0.5, None), None, need_lse=True)
        held[label] = _hold_call(qq, kk, vv, o, lse, dd, causal, "call shape")
    say(f"[ring] b8 h12 D64 bf16 call shapes against their plain versions (K1 + lse atol 2e-2; pre-pass, K2, K3 "
        f"with that o/lse 2e-2 x max |grad|): " + "; ".join(
            f"{label}: K1 {e1:.3e}, grads {eg:.3e}" for label, (e1, eg) in held.items()) + ": ok")
    elems, rows = b * h * L * d, b * h * L
    full = 4 * b * h * L * L * d  # QK^T and PV over every (query, key)
    nc = FA._Spec(False, d ** -0.5, None, FA.default_blocks(L, L, d))
    with torch.no_grad():
        k1_nc = graph_ms(lambda: FA._launch(q, k, v, nc, None, need_lse=True))
        k1_nc_plain = graph_ms(lambda: FA.flash_attention_reference(q, k, v, causal=False), calls=2, runs=5)
        sdpa_nc = graph_ms(lambda: sdpa(q, k, v))
    b_nc, by_nc = floor_ms(4 * elems * 2 + rows * 4, full)
    qh = q[:, :, L // 2:].contiguous()
    diag = FA._Spec(True, d ** -0.5, None, FA.default_blocks(L // 2, L, d))
    mask = causal_lower_right(L // 2, L)
    with torch.no_grad():
        k1_lt = graph_ms(lambda: FA._launch(qh, k, v, diag, None, need_lse=True))
        k1_lt_plain = graph_ms(lambda: FA.flash_attention_reference(qh, k, v, causal=True), calls=2, runs=5)
        sdpa_lt = graph_ms(lambda: sdpa(qh, k, v, attn_mask=mask))
    # Lq 512 against Lk 1024 end-aligned: 3/4 of the (query, key) pairs
    b_lt, by_lt = floor_ms((2 * elems // 2 + 2 * elems) * 2 + rows // 2 * 4, full // 2 * 3 / 4)
    ql, kl, vl = (x[:, :, :L // 2].contiguous() for x in (q, k, v))
    lo = FA._Spec(True, d ** -0.5, None, FA.default_blocks(L // 2, L // 2, d))
    with torch.no_grad():
        k1_lo = graph_ms(lambda: FA._launch(ql, kl, vl, lo, None, need_lse=True))
        k1_lo_plain = graph_ms(lambda: FA.flash_attention_reference(ql, kl, vl, causal=True), calls=2, runs=5)
        sdpa_lo = graph_ms(lambda: sdpa(ql, kl, vl, is_causal=True))
    # q512 x kv512 causal: half of its (query, key) pairs
    b_lo, by_lo = floor_ms(4 * elems // 2 * 2 + rows // 2 * 4, full / 8)
    with torch.no_grad():
        o, lse = FA._launch(q, k, v, nc, None, need_lse=True)
    args = FA._bwd_args(q, k, v, o, lse, do, None, nc, None)
    pre = graph_ms(lambda: FA._launch_bwd_prep(args))
    k2 = graph_ms(lambda: FA._launch_bwd_dkv(args))
    k3 = graph_ms(lambda: FA._launch_bwd_dq(args))
    with torch.no_grad():
        p2 = graph_ms(lambda: FA.flash_attention_bwd_dkv_reference(q, k, v, o, lse, do, causal=False), calls=2, runs=3)
        p3 = graph_ms(lambda: FA.flash_attention_bwd_dq_reference(q, k, v, o, lse, do, causal=False), calls=2, runs=3)
        p1 = graph_ms(lambda: FA.flash_attention_bwd_prep_reference(q, o, do, sm_scale=d ** -0.5))
    sdpa_b = graph_ms(_grad_fn(sdpa, q, k, v, do))
    b1, by1 = floor_ms(4 * elems * 2 + rows * 4)
    b2, by2 = floor_ms(6 * elems * 2 + 2 * rows * 4, 2 * full)
    b3, by3 = floor_ms(5 * elems * 2 + 2 * rows * 4, 1.5 * full)
    say(f"[ring] {smi} | call shapes, b8 h12 D64 bf16, device ms: K1 non-causal + lse over a 1024 shard "
        f"{k1_nc:.4f} (plain {k1_nc_plain:.4f}, bound {b_nc:.4f} {by_nc}, SDPA {sdpa_nc:.4f}); K1 causal q512 x kv1024 "
        f"end-aligned {k1_lt:.4f} (plain {k1_lt_plain:.4f}, bound {b_lt:.4f} {by_lt}, SDPA lower-right mask "
        f"{sdpa_lt:.4f}); K1 causal q512 x kv512 {k1_lo:.4f} (plain {k1_lo_plain:.4f}, bound {b_lo:.4f} {by_lo}, "
        f"SDPA causal {sdpa_lo:.4f}); on a non-causal 1024 shard with the merged lse: pre-pass {pre:.4f} (bound "
        f"{b1:.4f}), K2 {k2:.4f} (plain {p2:.4f}, bound {b2:.4f} {by2}), K3 {k3:.4f} (plain {p3:.4f}, bound "
        f"{b3:.4f} {by3}); SDPA backward non-causal {sdpa_b:.4f}")
    e_nc, e_lt, e_lo = held.values()
    shapes = {
        "flash_fwd": {"ring_noncausal_shard": dict(ms=k1_nc, plain_ms=k1_nc_plain, bound_ms=b_nc, bound_by=by_nc,
                                                   library_ms=sdpa_nc, max_abs_err=e_nc[0]),
                      "ring_causal_lq_lt_lk": dict(ms=k1_lt, plain_ms=k1_lt_plain, bound_ms=b_lt, bound_by=by_lt,
                                                   library_ms=sdpa_lt, max_abs_err=e_lt[0]),
                      "ring_causal_diagonal": dict(ms=k1_lo, plain_ms=k1_lo_plain, bound_ms=b_lo, bound_by=by_lo,
                                                   library_ms=sdpa_lo, max_abs_err=e_lo[0]),
                      "ring_vs_one_call": ring_ms},
        "flash_bwd_prep": {"ring_noncausal_shard": dict(ms=pre, plain_ms=p1, bound_ms=b1, bound_by=by1,
                                                        library_ms=None)},
        "flash_bwd_dkv": {"ring_noncausal_shard": dict(ms=k2, plain_ms=p2, bound_ms=b2, bound_by=by2,
                                                       library_ms=sdpa_b, grad_err_of_max=e_nc[1])},
        "flash_bwd_dq": {"ring_noncausal_shard": dict(ms=k3, plain_ms=p3, bound_ms=b3, bound_by=by3,
                                                      library_ms=sdpa_b, grad_err_of_max=e_nc[1])},
    }
    return shapes, max(e for e, _ in held.values())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(seed: int, smi: str, data: np.ndarray) -> dict:
    """The parallel package through its public entry points on a real
    1-rank NCCL group (one card; NCCL takes one rank per device): the mesh;
    ring attention (contiguous, zig-zag) and head-parallel attention
    against one flash_attention call, with grads; a context-parallel
    Trainer on GPT-2 124M (full width and depth, b8 x T1024, seq_zigzag,
    seq_batch_sharding) for 4 steps, its losses and its first step's
    gradients against the unsharded Trainer's, K1, the pre-pass, K2 and K3
    counted from 0 over that run; dp x tp steps with DTensor parameters
    (fused AdamW) held the same way; and TP Llama serving at Llama-3 8B's widths with 2
    layers, its greedy tokens against llama.prefill / decode_loop's.
    Returns {kernel: launches on the context-parallel run}."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from flash_attention_tpu_torch import parallel as par
    from flash_attention_tpu_torch.models.gpt import loss_fn as gpt_loss_fn
    from flash_attention_tpu_torch.parallel.sharding import whole

    topo = par.initialize_multihost(f"tcp://localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh = par.make_mesh()
        par.assert_same_across_hosts(seed, "seed")
        say(f"[parallel] process group {dist.get_backend()} {topo}; mesh {mesh}")
        gen = torch.Generator().manual_seed(seed + 12)
        q, k, v, do = (_rand(gen, (2, 8, 2048, 64), torch.bfloat16) for _ in range(4))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out = FA.flash_attention(*leaves)
        ref = torch.autograd.grad(ref_out, leaves, do)
        for label, fn in (("ring contiguous", lambda *t: par.ring_attention(*t, mesh)),
                          ("ring zig-zag", lambda *t: par.ring_attention(*t, mesh, zigzag=True)),
                          ("head-parallel", lambda *t: par.head_parallel_attention(*t, mesh))):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            grads = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            e_out = (out.float() - ref_out.float()).abs().max().item()
            e_grad = max((g.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                         for g, r in zip(grads, ref))
            ok = e_out <= 1e-2 and e_grad <= 2e-2
            say(f"[parallel] {label} b2 h8 L2048 D64 bf16 vs one flash_attention call: output {e_out:.3e} (1e-2), "
                f"grads {e_grad:.3e} of max |grad| (2e-2): {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[parallel] {label} outside tolerance")

        steps, bsz = 4, 8
        cfg = GPT2_124M
        tcfg = TrainerConfig(max_iters=steps, learning_rate=6e-4, warmup_iters=2, lr_decay_iters=steps,
                             log_interval=1, eval_interval=10 ** 9)

        def losses(trainer) -> list:
            batches = batch_iterator(data, bsz, cfg.block_size, seed=seed, device="cuda")
            hist = trainer.fit(batches, log=lambda s: None)
            torch.cuda.synchronize()
            return [r["train_loss"] for r in hist]

        idx, tgt = next(batch_iterator(data, bsz, cfg.block_size, seed=seed, device="cuda"))

        def grad_gap(sharded: Trainer, ref: Trainer) -> tuple[float, str]:
            """Both models' gradients of the first batch's loss at their
            (equal) initial weights, compared tensor by tensor in the
            unsharded layout: the worst ||g - g_ref|| / ||g_ref|| and its
            parameter.  The gradients are cleared after."""
            got = {}
            for tr in (sharded, ref):
                gpt_loss_fn(tr.model, idx, tgt).backward()
                got[tr] = {n: whole(p, p.grad).float() for n, p in tr.model.named_parameters()}
                tr.model.zero_grad(set_to_none=True)
            gaps = {n: ((g - got[ref][n]).norm() / got[ref][n].norm()).item() for n, g in got[sharded].items()}
            name = max(gaps, key=gaps.get)
            return gaps[name], name

        # the sharded runs against the unsharded ones: losses within 1e-4
        # relative over the steps (the loss sits near ln V at init whatever
        # attention does, so this alone would not see a causal leak); every
        # gradient of one step from the same weights within 1e-2 (bf16)
        cp_cfg = dataclasses.replace(cfg, seq_mesh=mesh, seq_zigzag=True)
        base_cfg = dataclasses.replace(cp_cfg, seq_mesh=None, seq_zigzag=False)
        cp = Trainer(cp_cfg, tcfg, seed=seed, batch_sharding=par.seq_batch_sharding(mesh))
        base = Trainer(base_cfg, tcfg, seed=seed)
        gap, gap_at = grad_gap(cp, base)
        _reset_launches()
        t0 = time.time()
        cp_losses = losses(cp)
        wall = time.time() - t0
        launches = {key: FA.KERNEL_LAUNCHES[key] for key in TRAINING_KERNELS}
        others = {key: n for key, n in FA.KERNEL_LAUNCHES.items() if n and key not in TRAINING_KERNELS}
        base_losses = losses(base)
        diff = max(abs(a - b) / abs(b) for a, b in zip(cp_losses, base_losses))
        # zig-zag at one rank: each layer's diagonal step is two K1 calls
        # (q_lo/kv_lo, q_hi/kv) and two backward calls
        want = 2 * cfg.n_layer * steps
        ok = (all(math.isfinite(x) for x in cp_losses) and diff <= 1e-4 and gap <= 1e-2
              and all(n == want for n in launches.values()) and not others)
        say(f"[parallel] {smi} | context-parallel Trainer, GPT-2 124M b{bsz} x T{cfg.block_size} zig-zag: losses "
            f"{cp_losses} vs unsharded {base_losses} (max relative diff {diff:.3e}, 1e-4); first-step gradients vs "
            f"unsharded: worst relative norm {gap:.3e} ({gap_at}; 1e-2); launches {launches} (want {want} each), "
            f"others {others}; {wall:.1f} s: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[parallel] context-parallel training")

        tp_model = GPT(dataclasses.replace(base_cfg), generator=torch.Generator().manual_seed(seed),
                       device="cuda", param_dtype=torch.float32)
        tp_tr = Trainer(base_cfg, tcfg, model=tp_model, param_sharding=par.gpt_param_sharding(mesh, tp_model),
                        batch_sharding=par.batch_sharding(mesh))
        un_tr = Trainer(base_cfg, tcfg, model=GPT(base_cfg, generator=torch.Generator().manual_seed(seed),
                                                  device="cuda", param_dtype=torch.float32))
        gap, gap_at = grad_gap(tp_tr, un_tr)
        tp_losses = losses(tp_tr)
        un_losses = losses(un_tr)
        diff = max(abs(a - b) / abs(b) for a, b in zip(tp_losses, un_losses))
        fused = all(g.get("fused") for g in tp_tr.optimizer.param_groups)
        placed = all(isinstance(p, DTensor) for p in tp_tr.model.parameters())
        ok = diff <= 1e-4 and gap <= 1e-2 and fused and placed
        say(f"[parallel] dp x tp Trainer (DTensor parameters {placed}, fused AdamW {fused}) on GPT-2 124M: losses "
            f"{tp_losses} vs unsharded {un_losses} (max relative diff {diff:.3e}, 1e-4); first-step gradients vs "
            f"unsharded: worst relative norm {gap:.3e} ({gap_at}; 1e-2): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[parallel] dp x tp training")

        lcfg = dataclasses.replace(llama.LLAMA3_8B, n_layer=2)
        prompt = torch.as_tensor(np.random.default_rng(seed).integers(0, lcfg.vocab_size, 200), device="cuda")

        def serve(shard: bool):
            m = llama.Llama(lcfg, generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
            cache = init_cache(lcfg.n_layer, 2, lcfg.n_kv_head, 1024, lcfg.head_dim, dtype=lcfg.dtype, device="cuda")
            if shard:
                m, cache = par.shard_llama_for_inference(m, cache, mesh)
                cache, logits = par.tp_prefill(m, prompt, cache, 0, mesh)
                cache, _ = par.tp_prefill(m, prompt[:100], cache, 1, mesh)
                first = torch.full((2,), int(logits.argmax()), dtype=torch.int32, device="cuda")
                return par.tp_decode_loop(m, cache, first, 16, mesh)[1], type(cache.k).__name__
            cache, logits = llama.prefill(m, prompt, cache, 0)
            cache, _ = llama.prefill(m, prompt[:100], cache, 1)
            first = torch.full((2,), int(logits.argmax()), dtype=torch.int32, device="cuda")
            return llama.decode_loop(m, cache, first, 16)[1], type(cache.k).__name__

        tp_toks, kind = serve(True)
        ref_toks, _ = serve(False)
        ok = torch.equal(tp_toks, ref_toks) and kind == "DTensor"
        say(f"[parallel] TP Llama serving, Llama-3 8B widths x 2 layers: 16 greedy tokens of 2 slots equal to "
            f"llama.prefill/decode_loop's: {torch.equal(tp_toks, ref_toks)}; the cache a {kind}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[parallel] TP serving")
        return launches
    finally:
        dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    # the autotuner's cache in a directory of this run's own: no earlier
    # tuning changes a phase's tiles, and the autotune phase starts empty
    cache_dir = tempfile.TemporaryDirectory(prefix="fa_autotune_")
    os.environ["FA_AUTOTUNE_CACHE"] = os.path.join(cache_dir.name, "tune.json")
    name, smi = phase_device()
    phase_build()
    errors = dict(zip(("flash_fwd", "flash_fwd_fp32"), phase_k1(args.seed)), **phase_k2k3(args.seed))
    k4 = phase_k4(args.seed)
    errors.update({key: err for key, (err, _) in k4.items()})
    decode_errors, decode_phase_launches = phase_decode(args.seed)
    errors.update(decode_errors)
    errors.update(phase_d256(args.seed))
    text = synthetic_corpus()
    data = CharTokenizer(text).encode(text)
    d256_launches = phase_d256_path(args.seed, data)
    wide_launches = phase_wide_path(args.seed)
    llama_k1 = phase_llama(args.seed, smi)
    llama_parity_k1 = phase_llama_parity(args.seed)
    llama_train = phase_llama_train(args.seed, smi, data)
    model = _gpt2(args.seed)
    base = phase_serving(args.seed, model)
    decode_launches, _ = phase_serving_quant(args.seed, model, base, smi)
    chunked_k1 = phase_serving_chunked(args.seed, model, base, smi)
    spec_k1 = phase_serving_spec(args.seed, model, base, smi)
    pipelined_k1 = phase_serving_pipelined(args.seed, model, base, smi)
    wquant_k6 = phase_serving_wquant(args.seed, model, smi)
    del model
    mqa_launches = phase_serving_mqa(args.seed, smi)
    phi2_launches, phi2_fp32_launches = phase_serving_phi2(args.seed, smi)
    fp16_launches = phase_serving_fp16(args.seed, smi)
    parity_k1 = phase_parity(args.seed)
    phase_parity_quant(args.seed)
    launches = phase_training(args.seed, smi, data)
    launches.update({key: n for key, (_, n) in k4.items()}, **decode_launches, **d256_launches)
    launches.update({k: n for k, n in wide_launches.items() if k not in d256_launches})
    # the fp32 K1 / K2 / K3: their launches on the fp32 training path
    launches.update(phase_train_parity(args.seed, data))
    llama_times = phase_timing_llama_d256(args.seed, smi)
    wide_times, fp32_times = phase_timing_wide(args.seed, smi)
    times = {**phase_timing(args.seed, smi), **phase_timing_quant(args.seed, smi), **llama_times, **wide_times}
    # the fp32 pre-pass at D64 / D128, beside its base row; the fp32 K1's
    # launches on the fp32 GPT-2 and Llama prefill paths
    for key, rows in fp32_times.items():
        times[key].update(rows)
    times["flash_fwd_fp32"].update(parity_launches=parity_k1, llama_parity_launches=llama_parity_k1)
    # K1 on the Llama path: its launches in the two bursts and in Llama
    # training, and its time at the Llama prefill shape
    times["flash_fwd"].update(
        llama_serving_launches=llama_k1, llama_train_launches=llama_train,
        serving_chunked_launches=chunked_k1, serving_spec_launches=spec_k1, serving_pipelined_launches=pipelined_k1,
        **{f"llama_{k}": v for k, v in llama_times["llama"].items()},
    )
    times["fused_decode"]["serving_wquant_launches"] = wquant_k6
    for kernel in ("paged_decode", "fused_decode"):
        times[kernel]["serving_fp16_launches"] = fp16_launches[kernel]
        times[kernel]["serving_phi2_launches"] = phi2_launches[kernel]
        times[kernel]["serving_phi2_fp32_launches"] = phi2_fp32_launches[kernel]
    # the whole-group kernel's launches are serving-mqa's: n_layer x decode steps;
    # the wide and narrow kernels' the decode phase's (no model path runs head
    # dims above 256 or below 64)
    launches.update(mqa_launches, **decode_phase_launches)
    measured = phase_measure(args.seed, smi)
    phase_memory(smi)
    tiles, tile_err, autotune_k1, tiles_sdpa = phase_autotune(args.seed, smi, data)
    errors["flash_fwd"] = max(errors["flash_fwd"], tile_err)
    # K1's tile sweep: {shape: {block_q: device ms}}, its launches on the
    # autotuned engine and trainer paths, and utils.measure's readings
    times["flash_fwd"].update(tiles=tiles, tiles_library_ms=tiles_sdpa, autotune_launches=autotune_k1,
                              measure=measured)
    cache_dir.cleanup()
    ring_err, ring_times = phase_ring(args.seed, smi)
    errors["flash_fwd"] = max(errors["flash_fwd"], ring_err)
    parallel_launches = phase_parallel(args.seed, smi, data)
    # the ring's call shapes (K1 non-causal with lse over a shard, K1 with
    # Lq < Lk, K2/K3 on a shard with the merged lse) and the launches of
    # the context-parallel training run
    for key, rows in ring_times.items():
        times[key].update(rows)
    for key, n in parallel_launches.items():
        times[key]["parallel_launches"] = n
    # K5/K6: the int8 cache's times at the 8-slot L2-hot shape (no library
    # call), with the bf16 cache's beside them (bf16_ms, bf16_plain_ms,
    # bf16_bound_ms, and SDPA with a length mask as bf16_library_ms) and
    # the int8 cache's over GPT-2's 12 layers, L2-cold (l2_cold_ms,
    # l2_cold_bound_ms), which is what the serving-quant path reads; at
    # NEW_DECODE_SHAPES (santacoder_*, ...: int8, and the other stores with
    # SDPA as *_library_ms on 16-bit caches) and their launches on the
    # serving-mqa, serving-fp16 and serving-phi2 paths
    say(json.dumps({"kernels": [
        {"name": key, "route": "cuda", "source": src, "replaces": rep, "launches": launches[key],
         "max_abs_err": errors[key], "floor_ms": times[key]["bound_ms"], **times[key]}
        for key, (src, rep) in KERNELS.items()
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
