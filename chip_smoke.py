"""Drive the PyTorch port (``src/repro_torch``) once on one CUDA card and
check every phase.  Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build of the four CUDA sources (flash attention, SSD scan, the
   batch-invariant linear layer's two kernels, the RG-LRU scan) and of
   the CUDA graph IF-node helper (``core/cuda_graphs.cu``) from the
   checkout's sources, in parallel, and the kernels' SASS: tensor-core
   instructions (``mma.sync`` HMMA, ``wgmma`` HGMMA), FFMA, registers and
   local memory per flash-attention template instance, per SSD pass, per
   linear kernel and of the RG-LRU scan (``cuobjdump``);
3. the flash-attention kernel against its plain PyTorch version over the
   kernel test sweep (each case with its arithmetic and load path) and at
   the DiT-XL/2 shape, where two launches must agree bitwise, with device
   times (``repro_torch.kernels.timing``) in f32 and bf16 beside SDPA's;
4. the SSD-scan kernel against its plain PyTorch version over the kernel
   test sweep (f32 and bf16), at the Mamba-2-1.3B prefill shape (where two
   launches must agree bitwise), at a ragged length and on strided views
   of one projection as the model hands them over, with times; then the
   linear kernels (``gemm``: the token rows' 3xTF32 ``wgmma`` kernel, the
   request rows' FFMA kernel) against their plain version (cuBLAS f32,
   TF32 off) at every DiT-XL/2 product shape for buckets 1–8 under CFG
   (≤ 5e-5 of the output's scale), each row bitwise against products of
   fewer and of permuted rows in both variants, a captured launch against
   an eager one in both, a capture without a prepared weight raising, and
   the device times of one B = 8 forward's products beside their bound
   and cuBLAS's;
5. a full-width DiT-XL/2 denoiser forward on the card (kernel attention)
   against the same forward on the CPU (plain attention), then a
   ``torch.profiler`` trace of one forward at B = 8: device time by
   kernel, the attention and linear kernels' shares (every product of the
   forward through the linear kernels: 201 calls, 31 of them request
   rows, no library GEMM), the device's idle share;
6. the DiT slice: full-width DiT-XL/2, DDIM 50, cfg_scale 1.5 — calibrate
   on 10 samples, save the artifact, load it strictly into a fresh pipeline
   and answer 4 requests with no cache, the artifact's SmoothCache schedule
   and ``static:n=2``; every latent finite, kernel launches = 28 × attention
   steps computed, linear launches = 5 + 28 × (1 + 4 per computed
   attention + 2 per computed MLP) per step — the segment graphs'
   replays (each graph's captured calls × its replays, ``ops.REPLAYED``),
   the wrapper calls being the new graphs' warm-ups —, segmented ≡ eager
   bitwise; the q/k/v that the model's
   attention makes take 3xTF32 with ``cp.async`` loads;
6b. the segmented path's step graphs (``segment_graphs``, budget
   ``SEGMENT_GRAPHS_BUDGET_S``): the slice's weights and artifact on
   pipelines of their own with graphs on and off; per policy the first
   graphed ``generate`` ≡ the eager ``sample`` bitwise with phase 6's
   launch counts from the captures, the walls graphs on / off in the
   order A B B A (every run bitwise), a whole run segment by segment
   under ``torch.cuda.set_sync_debug_mode("error")`` with its copy-in /
   copy-out ms per boundary; graphs = the plans' unique (signature,
   batch) pairs = the ``seg`` variants; warm-up and capture s, captured
   calls, buffer and pool bytes per graph; the idle share of traced
   graphed runs and of a traced run with graphs off;
7. a Mamba-2-1.3B prefill (full width, ``MAMBA2_BLOCKS`` = 24 of its 48
   blocks) of one 200-token prompt on the card (kernel scan) against the
   same prefill on the CPU (plain scan): logits and final states;
8. the LM slice: ``launch.serve.generate`` on 4 prompts × 1024 tokens, 32
   new tokens, greedy — 24 SSD launches in the prefill and none in the
   decode loop, whose steps replay one captured CUDA graph (every LM
   phase's ``generate`` decodes so: ``launch/decode_graph.py``, one graph
   per decode shape, built by a phase's first generate, its launches
   counted as the calls captured × the replays); then a card forward over
   prompt + the first 31 new tokens whose logits must match the recurrent
   decode step's;
9. a ``torch.profiler`` trace of one prefill and of 4 decode steps: device
   time by kernel, the SSD passes' time, and the device's idle share of the
   wall time;
10. the serving stack (``repro_torch.serve``), after the DiT slice on its
   weights: a ``ServeEngine`` over four store entries (``no_cache``, the
   slice's SmoothCache artifact, ``static:n=2`` and an adaptive artifact
   calibrated on 10 samples and loaded through JSON) drains 16 requests, 4
   per entry, arriving at once (``max_batch`` 4, 2 in flight,
   ``interleave``).  One line per entry (batches, wall, queue wait and
   service p50/p95, images/s, realized compute fraction, attention
   launches = 28 × computed attention steps — for a static entry its
   segment graphs' replays —, host syncs) and a summary
   (model variants and step graphs within the program budget, the static
   entries' warm-up and captured attention calls 28 per new graph that
   computes attention; the idle share of a second,
   traced drain, whose attention launches — the wrappers' calls and the
   segment and fused graphs' replays, counted from their captures — must
   be 28 × its computed attention steps, and its trace must hold no more:
   traced again, up to ``TRACE_TRIES`` times, until a trace holds them
   all, its times null if none does).  One served batch per
   entry replayed through
   ``DiffusionPipeline.generate`` must match bitwise, and the adaptive
   batch replayed at τ = 0 on its own realized decisions gives the per-step
   cost of the host loop's decision sync.  The adaptive entry rides the
   fused path: its graph replays launch the attention kernel without a
   Python call, so its check counts each new graph's warm-up and captured
   calls (28 per attention-computing branch); it makes no decision
   sync;
11. the fused adaptive path (``fused``, ~20 s): the serve phase's adaptive
   artifact, 4 requests (B = 8 in the kernel) — capture seconds, graph
   count and device memory around the capture (warm-up and captured
   attention calls counted from 0), the run state's copy into the
   graph's buffers and out (CUDA events); fused ≡ host loop
   (decisions and latents, bitwise) with the replays under
   ``torch.cuda.set_sync_debug_mode("error")`` and ``host_sync_count`` 0;
   τ = 0 fused ≡ ``sample_compiled``; chunks of 4 ≡ one call; a graph
   first captured for a run split at its last step (finite, and a repeat
   on the built graph bitwise); the fused batch's and the host loop's
   walls in the order A B B A; the idle share of one traced fused batch,
   whose attention kernels, counted in the trace, must be 28 × its
   computed attention steps;
12. continuous batching (``continuous``, ~25 s): the SmoothCache artifact,
   ``static:n=2`` and the adaptive artifact, ``max_batch`` 4, 2 in flight,
   ``adaptive_chunk`` 4, a wall clock, 2 requests per entry at t = 0 and 2
   more at t ≈ 0.3 s; with and without ``continuous=True``: joins, merges,
   regroups, coalesces, variants against the budget, images/s, queue wait
   and service p50/p95 (joins ≥ 1, merges ≥ 1, variants within the budget
   are checked); every served request against its own solo ``generate``
   (B = 1): the max abs difference per row, which must be 0 (bitwise),
   beside the row stability across batch shapes of the products (the
   linear kernel: 0; cuBLAS for the record) and of the served path's row
   reductions (the proxy's ``row_sums``, layernorm, gelu: 0; the plain
   ``sum`` the proxy replaced, for the record);
13. the SLO layer (``slo``, ~40 s): a τ ladder [0, 0.05, 0.3] of the
   adaptive artifact behind ``ElasticPolicy`` and ``AdmissionController``,
   26 requests of an ``overload_trace`` on a wall clock (1 / s, 4 / s,
   1 / s; strict and bulk classes): controller changes, sheds by reason,
   deferrals, attainment, goodput, p95 wait, realized τ; checked: ≥ 1
   rung change, one graph per served (bucket, τ > 0) pair, a hand-made
   move between the τ > 0 rungs capturing nothing, variants within the
   budget, every request served or shed with a reason, every served batch
   bitwise its ``generate`` at its rung's τ;
14. fault recovery (``resilience``, ~25 s; phases 14–16 run the first
   ``SERVE_CUT_BLOCKS`` = 7 of DiT-XL/2's 28 blocks at its full width,
   on views of the same weights): the SmoothCache and adaptive
   artifacts under ``ResiliencePolicy(watchdog_factor=4.0,
   watchdog_floor_s=0.5)``, the chaos harness writing real NaNs that only
   the executor's sentinels see — clean drains with resilience off and on
   (A B B A) bitwise equal; a fixed plan (NaN rows in a fused adaptive
   and a static batch, an injected fault, a stall past the watchdog's
   deadline) served in full, its static survivors bitwise their clean
   rows, every unsplit record bitwise its ``generate``; a seeded ramp at
   rate 0.3 with every request resolved;
15. step telemetry (``telemetry``, ~4 s): a fused batch with the proxy
   trace on and off bitwise under the sync guard, its reports realizing
   the host loop's decisions; a traced telemetry drain bitwise the plain
   one, a report per request, a valid trace;
16. durable serving (``durable``, ~30 s): the SmoothCache and adaptive
   artifacts, ``max_batch`` 2, 2 in flight, ``adaptive_chunk`` 4, the
   fused advances under the sync guard, snapshots in a temporary
   directory with at least 4 GB free — 8 requests with durability off,
   on, on, off at ``checkpoint_every=1`` and on / off at 4 (walls,
   overhead, bytes per snapshot and seconds of its device→host copy,
   sha256 and write per run kind, journal fsyncs); a kill with a static
   and a fused batch in flight restored by a fresh engine on a fresh
   executor bitwise the uninterrupted rows; a torn and a drifted snapshot
   quarantined with reasons and replayed bitwise; a seeded kill ramp
   (``KillPlan(seed=0, kill_rate=0.3, max_kills=4)``) losing nothing,
   every row bitwise, device memory at each restart not growing;
17. the video slice (``video``, ~110 s, on weights of its own after
   the DiT and LM weights are freed): OpenSora-v1.2 at full width (56
   blocks, 16 × 256 tokens, a 300-token text memory stub, rectified flow
   30, CFG 7.0).  The attention kernel at the spatial, temporal and cross
   shapes (and temporal at 8 requests, 65536 blocks) against its plain
   version, bitwise twice, with its time beside its bound and SDPA's;
   every product shape against cuBLAS with times; a card forward against
   a CPU forward at 2 block pairs (≤ 1e-4); calibration on 2 samples
   (k_max 3), the artifact saved and loaded strictly, 1 request under
   ``no_cache``, ``smoothcache:alpha=0.1`` and ``static:n=2`` — finite,
   attention launches = 28 per computed ``s_attn`` / ``t_attn`` /
   ``s_xattn`` / ``t_xattn`` per step, linear launches = 5 + Σ over the
   56 blocks of (1 + 4 per computed attention or cross branch + 2 per
   computed MLP) per step, segmented ≡ eager bitwise; one fused adaptive
   batch ≡ the host loop bitwise with no decision sync; a traced B = 2
   forward (``video_profile``);
18. the audio slice (``audio``, 49–71 s on an H100 80GB HBM3 at 700 W,
   last, on weights of its own after the video weights are freed): Stable-Audio-Open at full width (``AUDIO_BLOCKS`` = 12 of its
   24 blocks, d 1536, 216 latent rows,
   a 128-token text memory stub 768 wide), the paper's Table 3 protocol
   — DPM-Solver++(3M) SDE 100, CFG 7.0.  The attention kernel, self over 216 keys and cross over 128, at
   1 and 4 requests against its plain version, bitwise twice, timed
   beside its bound and SDPA's; every product for 1–4 requests against
   cuBLAS, each row bitwise against fewer and permuted rows, one
   forward's products timed; a card forward against a CPU forward and an
   8-step DPM++ sample on the card against the CPU from one seed, at 2
   blocks (≤ 1e-4); calibration on 8 samples (B = 16), the artifact
   saved and loaded strictly, 1 request under ``no_cache``,
   ``smoothcache:alpha=0.15`` / ``0.30`` and ``static:n=2`` — finite,
   attention launches = 12 per computed ``attn`` and ``xattn`` per step,
   linear launches = 5 + Σ over the 12 blocks of (1 + 4 per computed
   attn + 4 per computed xattn + 3 per computed ffn) per step (149 when
   all compute), segmented ≡ eager bitwise; one adaptive ``generate`` on
   the host loop (99 decision syncs); the fused path and ``split_run``
   refusing; 4 requests with prompts drained over two entries, each
   served batch ≡ its ``generate``, no join; a static and a host-loop
   run exported after 3 steps, restored on a fresh executor ≡
   uninterrupted; a traced B = 2 forward (``audio_profile``); peak
   memory of calibration and of the slice;
19. the attention-LM slice (``qwen3``, budget ~120 s, after the Mamba
   phases and before the video phase, on weights of its own drawn on the
   card from a seeded CUDA generator): Qwen3-14B at its published widths
   (d 5120, 40 query heads × 128 over 8 KV heads, qk-norm, RoPE θ 1e6,
   gated SiLU MLP d_ff 17408, vocab 151936), 8 of its 40 blocks.  The
   attention kernel at the prefill's causal GQA shape (4, 1024, 40 over
   8, 128) against its plain version, bitwise twice, timed beside its
   bound, the same shape non-causal and SDPA (``enable_gqa``); every
   product at 4096 and 4 rows against cuBLAS and an f64 product, rows
   bitwise, timed; a 2-block prefill of a 200-token prompt on the card
   against the CPU (logits and every k / v cache ≤ 1e-4); ``generate``
   on 4 prompts × 1024 tokens, 32 new, greedy, cache_len 1056 —
   attention 8 launches in the prefill and none in the decode, linear 56
   in the prefill and 56 a decode step; the 31 generated tokens decoded
   teacher-forced against one forward over prompt + tokens (≤ 1e-4); a
   traced prefill and 4 decode steps (``qwen3_profile``).  The decode
   graph against the same step launched from the host
   (``qwen3_decode_graph``, also in the ``recurrentgemma`` and
   ``musicgen`` phases, budget ``DECODE_AB_BUDGET_S``): ``generate``'s
   prefill and decode, the decode graphed and with ``graphs=False`` in
   the order A B B A, tokens and
   logits bitwise, decode ms a step; the replays under the sync guard; a
   traced graphed decode with its idle share (the uncaptured decode's is
   the ``_profile`` line's); warm-up, capture, buffer and pool bytes,
   peak; in ``qwen3`` a fault inside a capture raising from ``generate``.
20. the Gemma-2 slice (``gemma2``, budget ~150 s, after ``qwen3`` and
   before the video phase, on weights of its own drawn on the card):
   Gemma-2-9B at its published widths (d 3584, 16 query heads × 256 over
   8 KV heads, attention softcap 50, final softcap 30, pre- and
   post-norms, gated GELU-tanh MLP d_ff 14336, tied embeddings of 256000
   scaled by √d), 12 of its 42 blocks: 6 pairs of a local (window 4096)
   and a global block.  The attention kernel's D 256 instance at the
   prefill's shape (2, 4352, 16 over 8, 256), causal, softcap 50, with
   and without the window, against its plain version, bitwise twice,
   timed beside its bound, its plain version, ``flex_attention`` (the
   softcap as ``score_mod``, the band as ``block_mask``; compiled) and
   SDPA without the softcap; every product at 8704 and 2 rows against
   cuBLAS and f64, rows bitwise, timed; a 2-block prefill card against
   CPU; ``generate`` on 2 prompts × 4352 tokens (past the window: the
   ring drops positions 0–255), 32 new, greedy, cache_len 4384 —
   attention 12 launches in the prefill and none in the decode, linear
   84 in the prefill and 84 a decode step;
   teacher-forced decode vs one forward over 4383 tokens (≤ 1e-4); a
   traced prefill and 4 decode steps (``gemma2_profile``).
21. the MLA slice (``minicpm3``, budget ~120 s, after ``gemma2`` and
   before the video phase, on weights of its own drawn on the card):
   MiniCPM3-4B at its published widths, ``MINICPM3_BLOCKS`` = 16 of its
   62 blocks (d 2560, 40 heads, q-LoRA 768, a kv latent of 256 and a
   shared RoPE key of 32, nope 64, v 64, gated SiLU MLP d_ff 6400, tied
   embeddings of 73448).
   The attention kernel's (96, 64) instance — q and k 96 wide, v 64 — at
   the prefill's shape (4, 1024, 40), causal, against its plain version,
   bitwise twice, timed beside its bound, its plain version and SDPA (a
   value head dim of its own; the kernel it ran, from a trace); a sweep
   of (D, Dv) pairs, f32 and bf16, causal and not; every product at 4096
   and 4 rows (kv_b in the prefill only) against cuBLAS and f64, rows
   bitwise, timed; a 2-block prefill card against CPU (logits and every
   ckv / krope cache ≤ 1e-4); ``generate`` on 4 prompts × 1024 tokens, 32
   new, greedy, cache_len 1056 — attention 16 launches in the prefill and
   none in the decode (absorbed einsums over the latent cache), linear 128
   in the prefill and 112 a decode step; the latent cache's bytes;
   teacher-forced decode vs one forward (≤ 1e-4); a traced prefill and 4
   decode steps (``minicpm3_profile``).
22. the MoE slice (``deepseek3``, budget ~120 s, after ``minicpm3`` and
   before the video phase, on weights of its own drawn on the card):
   DeepSeek-V3 at its published widths (d 7168, 128 MLA heads at (192,
   128): q-LoRA 1536, kv latent 512 + RoPE 64, nope 128, v 128; dense
   MLP d_ff 18432; MoE blocks with a sigmoid router, a selection bias,
   top-8, ``norm_topk``, scale 2.5, routed and shared experts d_ff 2048;
   untied head of 129280), cut to 32 of 256 routed experts and 1 dense +
   2 MoE blocks, no MTP head.  The attention kernel's (192, 128) instance
   at the prefill's shape against its plain version, bitwise twice, timed
   beside its bound, its plain version, SDPA (the backend named) and the
   same inputs on V padded to 192; a wide (D, Dv) sweep, f32 and bf16,
   causal and not; every MLA, dense-MLP and router product at 4096 and 4
   rows against cuBLAS and f64; one MoE block's expert products at 8 and
   4096 rows an expert, the linear kernel against cuBLAS's ``bmm``, and
   one MoE FFN under ``dense`` and ``gshard``; a 2-block (dense + MoE)
   prefill card against CPU (logits, ckv / krope, the selected experts;
   a differing selection reported with its margin, ≤ 1e-5 to pass);
   ``generate`` on 4 prompts × 1024 tokens, 32 new, greedy, cache_len 1056
   (``dense`` prefill, ``gshard`` decode) — attention 3 / 0, linear 218
   in the prefill and 215 a decode step; teacher-forced decode vs one
   forward with the same rule for selections; a traced prefill and 4
   decode steps (``deepseek3_profile``).
23. the hybrid slice (``recurrentgemma``, budget ~120 s, after
   ``deepseek3`` and before the video phase, on weights of its own drawn
   on the card): RecurrentGemma-2B at its published widths and all 26
   blocks, (rec, rec, local MQA) × 8 + (rec, rec) (d 2560, the RG-LRU
   2560 wide with 10 gate heads of 256 and a conv of 4, attention 10 ×
   256 over 1 KV head with a window of 2048, gated GELU-tanh MLP d_ff
   7680, tied embeddings of 256000 scaled by √d).  The RG-LRU scan kernel
   against its plain version at the prefill's (2, 3072, 2560) and the
   decode's (2, 1, 2560) shapes, L 1, 7 and 300, W 200, on the model's
   strided gate views and contiguous (≤ 5e-5 of max |y| and |hT|),
   bitwise twice and row by row, timed beside its bytes bound and plain
   version (``recurrentgemma_scan``); the attention kernel's D 256
   instance as MQA at (2, 3072, 10 over 1, 256), window 2048, against its
   plain version, bitwise twice, timed beside its bound, SDPA (k and v
   expanded to the 10 heads) and compiled ``flex_attention``; every
   product at 6144 and 2 rows, the gate heads' (256, 256) among them,
   against cuBLAS and f64; a one-unit (rec, rec, attn) prefill card
   against CPU (logits, k / v, conv / h ≤ 1e-4); ``generate`` on 2
   prompts × 3072 tokens (past the window), 32 new, greedy, cache_len
   3104 — attention 8 launches in the prefill and none in the decode,
   the RG-LRU scan 18 and 18 a step, linear 524 and 524 a step;
   teacher-forced decode vs one forward over 3103 tokens (≤ 1e-4); a
   traced prefill and 4 decode steps with the scan's and, timed apart,
   the conv's share (``recurrentgemma_profile``).
24. the codebook LM (``musicgen``, budget ``MUSICGEN_BUDGET_S``, after
   ``recurrentgemma``, on weights of its own drawn on the card):
   MusicGen-medium at its published widths and all 48 blocks (d 1536, 24
   × 64 MHA, cross-attention to a text memory 1536 wide, gelu MLP d_ff
   6144, layernorm, sinusoidal positions, 4 codebooks of 2048).  The
   attention kernel at the prefill's causal shape (4, 1024, 24, 64) and
   as cross-attention over a 64-token memory at the prefill's 1024 query
   rows and a decode step's one, each against its plain version, bitwise
   twice, timed beside its bound, its plain version and SDPA (its
   products' shapes are Stable-Audio-Open's, checked and timed there); a
   2-block prefill with a memory card against CPU; ``generate(memory=)`` on 4 prompts × 1024 frames × 4
   codebooks, 32 new, greedy, cache_len 1056 — attention 96 launches in
   the prefill and 48 a decode step (the cross branches), linear 480 and
   480 a step; decode vs one forward (≤ 1e-4); a traced prefill and 4
   decode steps (``musicgen_profile``).
25. the prefix LM (``internvl2``, budget ``INTERNVL2_BUDGET_S``):
   InternVL2-1B at its published widths and all 24 blocks through
   ``launch.programs``, 256 patch embeddings before 768 tokens: the
   attention kernel at (4, 1024, 14 over 2, 64); a 2-block prefill card
   against CPU over 8 patches and 192 tokens; the prefill step (cache_len
   1056) and 31 serve steps at positions 1024 + i — attention 24 / 0,
   linear 168 / 168 a step; decode vs forward.
26. the MoE prefix LM (``llama4``, budget ``LLAMA4_BUDGET_S``):
   Llama-4 Maverick at its published widths, one unit of its 12 (local
   RoPE dense, local RoPE MoE, local RoPE dense, global NoPE MoE) and 8
   of its 128 routed experts (top-1, sigmoid, no renormalization, the
   shared expert), through ``launch.programs``, 256 patch embeddings
   before 1024 tokens: the attention kernel at (4, 1280, 40 over 8, 128)
   with the window and without; one MoE block's expert products at 8 and
   5120 rows an expert against ``torch.bmm``; the whole unit's prefill card against
   CPU over 8 patches and 192 tokens, with the selected experts (a
   differing selection passes only at a margin ≤ 1e-5); the prefill step
   (``dense``, cache_len 1312) and 31 ``gshard`` serve steps — attention
   4 / 0, linear 78 / 78 a step; decode vs a dense forward with the same
   rule; a traced prefill and 4 decode steps (``llama4_profile``).
27. DiT-XL/2 training (``train_dit``, budget ``TRAIN_DIT_BUDGET_S``, right
   after ``durable``, on the serving phases' weights, trained in place):
   each kernel op's gradient on the card — its forward the kernel, its
   backward the plain version's gradient — against the plain op's
   autograd (``train_op_grads``: linear and attention at the training
   shapes, the SSD and RG-LRU scans small; ≤ 1e-4); the attention kernel
   at (16, 256, 16, 72) and the token products at 4096 rows timed; a
   2-block card-vs-CPU loss and gradient; 12 steps of the ε loss on
   ``BlobLatents`` (B 16), AdamW lr 1e-4, no weight decay — every leaf's
   gradient present, finite and nonzero each step, forward / backward /
   optimizer ms, launches a step (201 linear, 28 attention), step 2
   traced, the peak and the prepared halves flat; a checkpoint after
   step 6 restored into fresh tensors ≡ the run's step 7 (≤ 1e-6);
   ``generate`` after training ≡ the same on freshly prepared halves,
   bitwise.
28. the quickstart (``quickstart``, budget ``QUICKSTART_BUDGET_S``, after
   the DiT weights are freed): ``launch.quickstart.run`` on the card —
   the smoke DiT trained 150 steps, a 10-sample calibration, the policy
   sweep against ``no_cache`` (ms a batch, speedup, Fréchet distance,
   compute fraction): the port's quality numbers on trained weights.
29. InternVL2-1B training (``train_lm``, budget ``TRAIN_LM_BUDGET_S``,
   after ``internvl2``, on weights of its own): ``make_train_step`` at B
   4 × (256 patch embeddings + 512 tokens), 5 steps — every leaf's
   gradient finite and nonzero, a 2-block card-vs-CPU loss and gradient,
   the peak flat, ms a step, tokens / s, step 2 traced.
30. the share of the card's peak (``roofline``, budget
   ``ROOFLINE_BUDGET_S``, last): the FLOPs and bytes of DiT-XL/2's three
   50-step samplers (``build_sampler_fn`` of the slice's ``no_cache``,
   α 0.18 and ``static:n=2``) and of the Qwen3 prefill, counted on the
   meta device (``launch/op_analysis.py``) by a spawned process that runs
   beside the video and audio phases, read against the H100's roofline
   and this run's walls: counted / analytic FLOPs in [0.8, 1.25], cached
   / uncached FLOPs within 0.15 of the compute fraction, each phase's
   measured weight and prepared-halves bytes equal to the dry run's
   prediction (``launch/dryrun.py``), no kernel launched.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
The weights are random (seeded); depth and widths are DiT-XL/2's and
OpenSora-v1.2's (the fault, telemetry and durability phases at 7 of
DiT-XL/2's 28 blocks); Stable-Audio-Open's widths at 12 of its 24
blocks, Mamba-2-1.3B's at 24 of its 48, Qwen3-14B's at 8 of 40,
Gemma-2-9B's at 12 of 42, MiniCPM3-4B's at 16 of 62 and DeepSeek-V3's at
3 of 61 with 32 of its 256 experts (the cuts of depth pay for the
``deepseek3`` phase and for the codebook and prefix LM phases);
RecurrentGemma-2B's at all 26 of its blocks, MusicGen-medium's at all
48, InternVL2-1B's at all 24, and Llama-4 Maverick's at 4 of 48 with 8
of its 128 experts.
"""
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
REQUEST_LABELS = [207, 360, 387, 974]
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 32
# Mamba-2-1.3B's depth on the card, of 48: all 48 until the deepseek3
# phase came, which this cut pays for
MAMBA2_BLOCKS = 24
# the linear kernels' error against an f64 product, of the output's scale:
# about 1e-6 at every K with the token kernel's promoted accumulation, and
# 1.2e-4 at K 17408 without it
F64_LIMIT = 1e-5
# batches a product's time is the median of in the product sweeps of the
# LMs, the video and the audio path: 3 (5 before the training phases
# came), and calls a batch at an LM prefill's rows (each call milliseconds
# long): 5 (10 before) — part of what pays for the training phases
SWEEP_REPS, SWEEP_PREFILL_ITERS = 3, 5
# what the roofline phase reads of the phases before it, measured in the
# same run: the DiT slice's three generates (wall, schedule, compute
# fraction), the qwen3 phase's prefill seconds, and the weight and
# prepared-halves bytes each phase measured of its own weights
MEASURED = {"dit_generate": {}, "qwen3_prefill_s": None, "params": {},
            "decode_graphs": {}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card():
    """The card's name and power limit as ``nvidia-smi`` gives them, and
    its published peaks (``repro_torch.launch.mesh``)."""
    from repro_torch.launch import mesh
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, power = (s.strip() for s in line.split(",", 1))
    emit({"card": name, "power_limit": power})
    return mesh.peaks(name)


def kernel_phase(fa, ref, peaks):
    """Kernel vs plain over the sweep and at the DiT-XL/2 shape, where two
    launches must agree bitwise; device times (``kernels.timing``) at the
    DiT-XL/2 shape, in f32 and in bf16, beside SDPA's."""
    import torch.nn.functional as F
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    gen = torch.Generator().manual_seed(SEED)

    def qkv(b, l, h, kv, d, dtype, offset=0):
        """Seeded q, k, v; ``offset`` > 0 views each from ``offset``
        elements into a wider row, so no row is 16 B-aligned."""
        return [torch.randn(shape[:-1] + (d + offset,), generator=gen)
                .to("cuda", dtype)[..., offset:]
                for shape in ((b, l, h, d), (b, l, kv, d), (b, l, kv, d))]

    sweep = []
    # (shape, causal, window, softcap, row offset)
    cases = ([((2, 64, 4, 4, 32), True, None, None, 0),
              ((2, 64, 4, 1, 32), True, None, None, 0),
              ((1, 96, 8, 2, 64), True, None, None, 0),
              ((1, 128, 16, 8, 64), True, None, None, 0),
              ((2, 40, 4, 2, 16), True, None, None, 0)]
             + [((2, 64, 4, 2, 32),) + m + (0,) for m in (
                 (True, 16, None), (True, None, 50.0), (False, None, None),
                 (True, 8, 30.0))]
             + [((2, 256, 4, 4, 72), False, None, None, 0),
                ((1, 128, 4, 2, 128), True, None, None, 0),
                ((2, 64, 4, 2, 20), True, None, None, 0),
                ((2, 64, 4, 2, 32), True, None, None, 1)]
             # the wide instance (D 129..256): GQA, a ragged length, a
             # window with a softcap, a head dim padded to 256, scalar loads
             + [((2, 130, 8, 2, 256), True, None, None, 0),
                ((1, 200, 4, 2, 256), True, None, None, 0),
                ((2, 64, 4, 2, 256), True, 16, 30.0, 0),
                ((2, 72, 4, 4, 200), False, None, None, 0),
                ((2, 64, 4, 2, 256), True, None, None, 1)])
    for shape, causal, window, softcap, offset in cases:
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 5e-2)):
            q, k, v = qkv(*shape, dtype, offset)
            kw = dict(causal=causal, window=window, softcap=softcap)
            out = fa.flash_attention_cuda(q, k, v, **kw).float()
            want = ref.flash_attention_ref(q, k, v, **kw).float()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            ok = bool(torch.allclose(out, want, atol=tol, rtol=tol))
            sweep.append({"shape": shape, "causal": causal, "window": window,
                          "softcap": softcap, "dtype": str(dtype)[6:],
                          "offset": offset, **fa.plan(q, k, v),
                          "max_abs_err": err, "ok": ok})
            check(ok, f"kernel vs plain {sweep[-1]}")
            if offset:
                check(sweep[-1]["load"] == "scalar",
                      f"unaligned rows took {sweep[-1]['load']}")
    emit({"sweep": sweep})

    b, l, h, d = 8, 256, 16, 72          # DiT-XL/2: 2 x 4 requests under CFG
    q, k, v = qkv(b, l, h, h, d, torch.float32)
    out = fa.flash_attention_cuda(q, k, v, causal=False)
    again = fa.flash_attention_cuda(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
          f"kernel vs plain at the DiT-XL/2 shape: max abs err {err}")
    check(bool(torch.equal(out, again)),
          "two launches at the DiT-XL/2 shape differ")
    ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=False))
    plain_ms = device_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=False))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    _, lib_kernels = _traced(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    work = fa.work(b, l, l, h, h, d)
    flops, nbytes, _ = work
    bound, bound_by = kernel_bound(peaks, work)

    # the same shape in bf16, against SDPA in bf16
    qb, kb, vb = (a.bfloat16() for a in (q, k, v))
    out = fa.flash_attention_cuda(qb, kb, vb, causal=False)
    want = ref.flash_attention_ref(qb, kb, vb, causal=False)
    bf16_err = float((out.float() - want.float()).abs().max())
    check(bool(torch.allclose(out.float(), want.float(), atol=5e-2,
                              rtol=5e-2)),
          f"bf16 kernel vs plain at the DiT-XL/2 shape: max abs err "
          f"{bf16_err}")
    bf16_ms = device_ms(lambda: fa.flash_attention_cuda(qb, kb, vb,
                                                        causal=False))
    bf16_plain_ms = device_ms(lambda: ref.flash_attention_ref(qb, kb, vb,
                                                              causal=False))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (qb, kb, vb))
    bf16_library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bf16_bound = kernel_bound(peaks, fa.work(b, l, l, h, h, d,
                                             dtype=torch.bfloat16))[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "shape": [b, l, h, h, d], "dtype": "float32", "causal": False,
            **fa.plan(q, k, v),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_simt_ms": flops / peaks["fp32"] * 1e3,
            "library_ms": library_ms,
            "library_kernel": max(lib_kernels, key=lambda k:
                                  lib_kernels[k][0])[:90],
            "flops": flops, "bytes": nbytes,
            "bf16": {**fa.plan(qb, kb, vb), "max_abs_err": bf16_err,
                     "ms": bf16_ms, "plain_ms": bf16_plain_ms,
                     "library_ms": bf16_library_ms, "bound_ms": bf16_bound}}


# name fragments of the kernels in each library's SASS; every one of them
# runs a product on the tensor cores but the request-row linear kernel and
# the RG-LRU scan's three passes, which are bound by bytes and run f32 FMAs
SASS_KERNELS = {"flash_attention": ("attn_fwd",),
                "ssd": ("ssd_cb", "ssd_state", "ssd_out"),
                "gemm": ("gemm_tokens_wgmma", "gemm_requests_ffma"),
                "rglru": ("rglru_summary", "rglru_carry", "rglru_output")}
FFMA_KERNELS = ("gemm_requests_ffma",) + SASS_KERNELS["rglru"]
# the port's linear kernels, as a profiler trace names them
LINEAR_KERNELS = {"tokens": "gemm_tokens_wgmma",
                  "requests": "gemm_requests_ffma"}


def sass_phase(libs):
    """What the compiler made of each CUDA library: per kernel (template
    instance or SSD pass), tensor-core instructions — ``mma.sync`` (HMMA)
    and ``wgmma`` (HGMMA) — and f32 FMAs (FFMA) in the SASS, and
    registers, stack and local memory from the resource usage.  Every
    kernel needs tensor-core instructions but those of ``FFMA_KERNELS``,
    which need FFMA; the token linear kernel needs HGMMA."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    tool = str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    out = {}
    for lib, names in SASS_KERNELS.items():
        path = libs[lib]
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        res = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True, check=True).stdout
        rows = {}
        for part in sass.split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if any(k in name for k in names):
                rows[name] = {"hmma": part.count("HMMA"),
                              "hgmma": part.count("HGMMA"),
                              "ffma": len(re.findall(r"\bFFMA\b", part))}
        for name, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)",
                                      res):
            if name in rows:
                rows[name].update({k.lower(): int(v) for k, v in re.findall(
                    r"(REG|STACK|SHARED|LOCAL):(\d+)", usage)})
        emit({"phase": "sass", "kernel": lib, "instances": rows})
        check(all(any(k in name for name in rows) for k in names),
              f"{lib}: a kernel of {names} missing from the SASS")
        for name, r in rows.items():
            if any(k in name for k in FFMA_KERNELS):
                check(r["ffma"] > 0, f"{lib}: {name} without FFMA")
            else:
                check(r["hmma"] + r["hgmma"] > 0,
                      f"{lib}: {name} without tensor-core instructions")
            if LINEAR_KERNELS["tokens"] in name:
                check(r["hgmma"] > 0, f"{lib}: {name} without HGMMA")
        out[lib] = rows
    return out


def linear_calls(cfg, computed):
    """``ops.linear`` calls of one forward whose branches of the types in
    ``computed`` run: 5 outside the blocks, per block its modulation, 4
    per computed self- or cross-attention branch, 2 per computed MLP (3
    when it is gated)."""
    return 5 + sum(1 + sum(4 if t.endswith("attn") else
                           3 if b.ffn.gated else 2
                           for t in b.branch_types() if t in computed)
                   for _, _, _, b in cfg.blocks())


def attn_calls(cfg, computed):
    """Attention kernel calls of one forward: one per block and computed
    self- or cross-attention branch."""
    return sum(t.endswith("attn") for _, _, _, b in cfg.blocks()
               for t in b.branch_types() if t in computed)


def product_times(gemm, ref, peaks, x, w, b, rows, iters=50, reps=5):
    """One product x (M, K) @ w (K, N) (+ b) through its linear kernel
    variant: device ms (batched and one call alone; ``iters`` calls a
    batch, the median of ``reps`` batches), the plain version's and
    cuBLAS's (``addmm`` / ``mm``) ms, and
    its bound — 3xTF32 on the tensor cores for token rows, f32 FMAs
    outside them for request rows, against its bytes.  Without a bias the
    plain version, ``x @ w``, is cuBLAS's ``mm`` itself: it is timed once,
    as ``library_ms``, and the row says so (``plain_same_as``); its
    ``plain_ms`` repeats that one reading so that the sums by phase add
    every row."""
    from repro_torch.kernels.timing import device_ms, per_call_ms
    from repro_torch.launch.roofline import kernel_bound
    (m, k), n = x.shape, w.shape[1]
    bias = b is not None
    lib = ((lambda: torch.addmm(b, x, w)) if bias
           else (lambda: torch.mm(x, w)))
    work = gemm.work(m, k, n, bias, rows)
    flops, nbytes, _ = work
    bound, bound_by = kernel_bound(peaks, work)
    row = {"m": m, "k": k, "n": n, "bias": bias, "rows": rows,
           "plan": gemm.launch_plan(m, k, n, rows),
           "ms": device_ms(lambda: gemm.linear_cuda(x, w, b, rows=rows),
                           iters=iters, reps=reps),
           "per_call_ms": per_call_ms(
               lambda: gemm.linear_cuda(x, w, b, rows=rows), iters=iters),
           "library_ms": device_ms(lib, iters=iters, reps=reps),
           "bound_ms": bound, "bound_by": bound_by,
           "flops": flops, "bytes": nbytes}
    if bias:
        row["plain_ms"] = device_ms(lambda: ref.linear_ref(x, w, b),
                                    iters=iters, reps=reps)
    else:
        row.update(plain_ms=row["library_ms"], plain_same_as="library_ms")
    row["tflops"] = flops / row["ms"] / 1e9
    return row


def gemm_kernel_phase(gemm, ref, peaks, cfg):
    """The linear kernels against their plain version (cuBLAS f32, TF32
    off) at every DiT-XL/2 product shape for buckets 1–8 under CFG (M = 2B
    request rows, 2B·256 token rows), each through its call site's variant,
    ≤ 5e-5 of the output's scale; each row bitwise against the product of
    fewer rows and of permuted rows, in both variants; a captured launch
    against an eager one in both, and a capture that finds no prepared
    weight raising; device times of one B = 8 forward's products beside
    their bound and cuBLAS's ``addmm`` / ``mm``, summed per variant."""
    from repro_torch.kernels.products import gemms
    gen = torch.Generator().manual_seed(SEED + 11)

    def inputs(m, k, n):
        x = torch.randn(m, k, generator=gen).cuda()
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).cuda()
        return x, w, torch.randn(n, generator=gen).cuda()

    shapes = sorted({(k, n, rows)
                     for _, k, n, _, _, rows in gemms(cfg, 2)})
    sweep, worst, worst_abs = [], 0.0, 0.0
    for k, n, rows in shapes:
        for bucket in (1, 2, 4, 8):
            m = 2 * bucket * (1 if rows == "requests" else 256)
            x, w, b = inputs(m, k, n)
            out = gemm.linear_cuda(x, w, b, rows=rows)
            want = ref.linear_ref(x, w, b)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            rel = err / float(want.abs().max())
            worst, worst_abs = max(worst, rel), max(worst_abs, err)
            sweep.append({"m": m, "k": k, "n": n, "rows": rows,
                          "max_abs_err": err, "rel_max_err": rel})
            check(rel <= 5e-5, f"linear vs plain at {sweep[-1]}")
        gemm.release()
    emit({"phase": "gemm_sweep", "limit": 5e-5, "cases": sweep})

    out_rows = {}
    for k, n, rows in shapes:
        ms = (1, 2, 4, 8, 16) if rows == "requests" else (512, 1024, 2048,
                                                          4096)
        x, w, _ = inputs(ms[-1], k, n)
        full = gemm.linear_cuda(x, w, rows=rows)
        d = {str(m): float((gemm.linear_cuda(x[:m].contiguous(), w,
                                             rows=rows)
                            - full[:m]).abs().max()) for m in ms[:-1]}
        perm = torch.randperm(x.shape[0], generator=gen).cuda()
        d["permuted"] = float((gemm.linear_cuda(x[perm].contiguous(), w,
                                                rows=rows)
                               - full[perm]).abs().max())
        out_rows[f"{k}x{n}:{rows}"] = d
        gemm.release()
    emit({"phase": "gemm_rows", "max_abs_vs_full": out_rows})
    check(all(v == 0.0 for d in out_rows.values() for v in d.values()),
          f"a row's bits change with the batch: {out_rows}")

    captured_ok = {}
    for rows, m in (("tokens", 512), ("requests", 8)):
        x, w, b = inputs(m, cfg.d_model, cfg.d_model)
        eager = gemm.linear_cuda(x, w, b, rows=rows)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            gemm.linear_cuda(x, w, b, rows=rows)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = gemm.linear_cuda(x, w, b, rows=rows)
        graph.replay()
        torch.cuda.synchronize()
        captured_ok[rows] = bool(torch.equal(captured, eager))
        del graph
    # a weight with no prepared copy: the capture raises, it allocates none
    x, w, _ = inputs(512, cfg.d_model, cfg.d_model)
    graph, raised = torch.cuda.CUDAGraph(), False
    try:
        with torch.cuda.graph(graph):
            gemm.linear_cuda(x, w)
    except RuntimeError as e:
        raised = "prepared copy" in str(e)
    torch.cuda.synchronize()
    del graph
    gemm.release()
    emit({"phase": "gemm_capture", "captured_equals_eager": captured_ok,
          "unprepared_capture_raises": raised})
    check(all(captured_ok.values()), f"captured linear != eager: "
          f"{captured_ok}")
    check(raised, "a capture without a prepared weight did not raise")

    # one B = 8 forward's products (4 requests under CFG), each shape timed
    # alone and summed by its calls, in all and per variant
    keys = ("ms", "per_call_ms", "plain_ms", "library_ms", "bound_ms")
    timed, total = [], {**{key: 0.0 for key in keys}, "flops": 0,
                        "bytes": 0}
    variants = {rows: {**{key: 0.0 for key in keys}, "calls": 0}
                for rows in gemm.ROWS}
    for m, k, n, bias, calls, rows in gemms(cfg, 8):
        x, w, b = inputs(m, k, n)
        row = {**product_times(gemm, ref, peaks, x, w, b if bias else None,
                               rows), "calls": calls}
        timed.append(row)
        for key in keys:
            total[key] += calls * row[key]
            variants[rows][key] += calls * row[key]
        variants[rows]["calls"] += calls
        total["flops"] += calls * row["flops"]
        total["bytes"] += calls * row["bytes"]
        gemm.release()
    emit({"phase": "gemm_times", "batch": 8, "shapes": timed,
          "forward": total, "variants": variants})
    return {"name": "linear", "route": "cuda",
            "source": "src/repro_torch/kernels/gemm.cu",
            "replaces": "no TPU kernel: x @ w, XLA's dot on the TPU "
                        "(src/repro/models/mlp.py:22), cuBLAS f32 in "
                        "PyTorch; added for the row contract",
            "work": "one B = 8 DiT-XL/2 forward's products "
                    f"({sum(r['calls'] for r in timed)} calls)",
            "max_abs_err": worst_abs, "max_rel_err": worst,
            "ms": total["ms"], "per_call_ms": total["per_call_ms"],
            "plain_ms": total["plain_ms"], "library_ms": total["library_ms"],
            # each product's own bound, summed: the token products by
            # operations, the request-row products by bytes
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if variants["tokens"]["bound_ms"]
            >= variants["requests"]["bound_ms"] else "bytes",
            "flops": total["flops"], "bytes": total["bytes"],
            "variants": variants, "tile": gemm.TILE}


def full_width_params(cfg):
    """Seeded full-width parameters on the CPU (``serve_diffusion``'s
    recipe: each zero-initialized adaLN-zero leaf gets N(0,1)/√fan_in, so
    all 28 blocks contribute and activations stay finite)."""
    from repro_torch.launch.serve_diffusion import random_params
    return random_params(torch.Generator().manual_seed(SEED), cfg,
                         device="cpu")


def cross_check_phase(cfg, diffusion, params_cpu, params_gpu):
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((2,) + cfg.latent_shape, generator=gen)
    t = torch.tensor([999.0, 500.0])
    label = torch.tensor([207, cfg.num_classes])
    t0 = time.perf_counter()
    pred_gpu, _ = diffusion.apply(cfg, params_gpu, x.cuda(), t.cuda(),
                                  label=label.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred_cpu, _ = diffusion.apply(cfg, params_cpu, x, t, label=label)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(pred_cpu).all()), "CPU prediction not finite")
    scale = float(pred_cpu.abs().max())
    rel = float((pred_gpu.cpu() - pred_cpu).abs().max()) / scale
    emit({"phase": "cross_check", "batch": 2, "max_abs_pred": scale,
          "rel_max_err": rel, "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(rel <= 1e-4, f"card vs CPU forward: relative error {rel}")


def attention_path(cfg, diffusion, fa, params):
    """How the kernel computes the q/k/v that the first DiT block makes
    (``models.attention``'s own projection) at B = 8 under CFG: every
    block's q/k/v are fresh (B, L, H, D) views of one matmul output, so
    they all take this path."""
    from repro_torch.models import attention
    from repro_torch.models.transformer import tree_map
    spec = cfg.stages[0].unit[0].mixer
    mixer = tree_map(lambda a: a[0],
                     params["backbone"]["stages"][0][0]["mixer"])
    x = torch.randn(8, diffusion.token_shape(cfg)[0], cfg.d_model,
                    device="cuda")
    return fa.plan(*attention._gqa_qkv(spec, mixer, x))


def graph_counts(ops, executor, before=None):
    """The kernel counts around a run on ``executor``'s segmented path.
    Without ``before``: a mark of ``ops.LAUNCHES``, ``ops.REPLAYED`` and
    the executor's segment graphs.  With the mark taken before the run:
    the launches its graph replays made (``replayed``: each graph's
    captured calls × its replays), the wrapper calls it made
    (``calls``), the calls the warm-ups of the graphs it built made
    (``warmup``; a run that built its graphs and called nothing else has
    ``calls == warmup``) and those graphs (``new_graphs``)."""
    keys = ("flash_attention", "linear")
    if before is None:
        return {"launches": dict(ops.LAUNCHES),
                "replayed": dict(ops.REPLAYED),
                "graphs": executor.graph_count("seg")}
    new = executor.segment_graphs()[before["graphs"]:]
    return {"replayed": {k: ops.REPLAYED[k] - before["replayed"][k]
                         for k in keys},
            "calls": {k: ops.LAUNCHES[k] - before["launches"][k]
                      for k in keys},
            "warmup": {k: sum(g["warmup_launches"][k] for g in new)
                       for k in keys},
            "new_graphs": len(new)}


def slice_phase(cfg, params, ops):
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    n_attn = attn_calls(cfg, ("attn",))
    calib_labels = torch.tensor([(97 * i) % cfg.num_classes
                                 for i in range(10)], device="cuda")
    pipe = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                             cfg_scale=1.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = pipe.calibrate(params, torch.Generator().manual_seed(SEED + 2), 10,
                         cond_args={"label": calib_labels})
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    emit({"phase": "calibrate", "samples": 10, "steps": 50, "seconds": calib_s,
          "compute_fraction": pipe.compute_fraction(),
          "lag1_err_mid": {t: float(c[25, 1]) for t, c in art.curves.items()}})

    with tempfile.TemporaryDirectory() as tmp:
        path = pipe.save_artifact(str(Path(tmp) / "dit_xl_ddim50.cache.json"))
        serve = DiffusionPipeline(cfg, solvers.ddim(50),
                                  "smoothcache:alpha=0.18", cfg_scale=1.5)
        serve.load_artifact(path, strict=True)
    check(serve.schedule.to_json() == art.schedule.to_json(),
          "loaded schedule differs from the calibrated one")

    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    runs, latents = [], {}
    for name, override in (("no_cache", None),
                           ("smoothcache:alpha=0.18", "artifact"),
                           ("static:n=2", "static:n=2")):
        sch = (serve.schedule if override == "artifact"
               else serve.schedule_for(override) if override else None)
        kw = {} if override == "artifact" else {"schedule": sch}
        attn_steps = 50 if sch is None else int((~sch.skip["attn"]).sum())
        gemm_calls = sum(linear_calls(cfg, [
            t for t in cfg.layer_types()
            if sch is None or not sch.skip[t][s]]) for s in range(50))
        counts = graph_counts(ops, serve.executor)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = serve.generate(params, torch.Generator().manual_seed(SEED + 3),
                           len(REQUEST_LABELS), label=labels, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = graph_counts(ops, serve.executor, counts)
        launches = counts["replayed"]["flash_attention"]
        linear = counts["replayed"]["linear"]
        latents[name] = x
        frac = (1.0 if sch is None else float(sum(
            sch.compute_fraction(t) for t in sch.skip) / len(sch.skip)))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(launches == n_attn * attn_steps,
              f"{name}: {launches} kernel launches, expected "
              f"{n_attn} x {attn_steps}")
        check(linear == gemm_calls,
              f"{name}: {linear} linear launches, expected {gemm_calls}")
        check(counts["calls"] == counts["warmup"],
              f"{name}: kernel calls {counts['calls']} outside the graphs' "
              f"warm-ups {counts['warmup']}")
        base = latents["no_cache"]
        runs.append({"run": name, "requests": len(REQUEST_LABELS),
                     "wall_s": wall, "compute_fraction": frac,
                     "attn_steps": attn_steps, "launches": launches,
                     "linear_launches": linear,
                     "new_graphs": counts["new_graphs"],
                     "warmup_calls": counts["warmup"],
                     "rel_l1_to_no_cache": float((x - base).abs().sum()
                                                 / base.abs().sum())})
        emit({"phase": "generate", **runs[-1]})
        MEASURED["dit_generate"][name] = {"wall_s": wall, "schedule": sch,
                                          "compute_fraction": frac}
    eager = serve.generate(params, torch.Generator().manual_seed(SEED + 3),
                           len(REQUEST_LABELS), label=labels, compiled=False)
    same = bool(torch.equal(eager, latents["smoothcache:alpha=0.18"]))
    emit({"phase": "segmented_vs_eager", "run": "smoothcache:alpha=0.18",
          "bitwise_equal": same})
    check(same, "segmented and eager latents differ")
    return runs, art


# the segment_graphs phase's budget: ~1.5x the longest run measured (53 s
# on an H100 80GB HBM3 at 700 W)
SEGMENT_GRAPHS_BUDGET_S = 80


def _median(xs):
    return statistics.median(xs) if xs else None


def segment_graphs_phase(cfg, params, ops, art):
    """The segmented path's step graphs at full width (see the module
    docstring, phase 6b; budget ``SEGMENT_GRAPHS_BUDGET_S``): DiT-XL/2 at
    28 of 28 blocks, DDIM 50, CFG 1.5, 4 requests (B = 8 in the kernels),
    on the DiT slice's weights and calibrated artifact, on pipelines of
    their own with graphs on and off (``graphs=False``: the same step
    uncaptured, launched from the host each step).  Per policy (``no_cache``, the artifact's
    α 0.18 schedule, ``static:n=2``): the first graphed ``generate``
    (capturing what it lacks) ≡ the eager ``sample`` bitwise, its
    replayed launches equal to the DiT slice's formula and its wrapper
    calls the new graphs' warm-ups; the walls graphs on (A) and off (B)
    in the order A B B A, every run bitwise the first; a whole run by
    ``advance_run`` under ``set_sync_debug_mode("error")`` (no host sync
    in any segment or boundary) with its copy-in / copy-out ms per
    boundary.  Then: graphs = the plans' unique (signature, batch) pairs
    = the ``seg`` variants, none built after the first runs; per graph
    the warm-up and capture seconds, the kernel calls captured, buffer
    and pool bytes; a traced graphed run of ``no_cache`` and of
    ``static:n=2`` and a traced ``no_cache`` run with graphs off, each
    traced again (up to ``TRACE_TRIES`` times) until the trace holds every
    attention and linear launch (the replays' count comes from the
    captures): idle share, device and attention ms, null where no trace
    was complete.  The graphed and eager walls go to the roofline
    phase."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import schedule as S, segment_graph, solvers
    t_phase = time.perf_counter()
    n_attn = attn_calls(cfg, ("attn",))
    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    n = len(REQUEST_LABELS)

    def pipe(graphs):
        p = DiffusionPipeline(cfg, solvers.ddim(50), "smoothcache:alpha=0.18",
                              cfg_scale=1.5, graphs=graphs)
        p.load_artifact(art, strict=True)
        return p

    def gen():
        return torch.Generator().manual_seed(SEED + 3)

    graphed, loop = pipe(True), pipe(False)
    ex = graphed.executor
    schedules = {"no_cache": None,
                 "smoothcache:alpha=0.18": graphed.schedule,
                 "static:n=2": graphed.schedule_for("static:n=2")}
    pairs, rows, outs = set(), {}, {}
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    for name, sch in schedules.items():
        full = sch if sch is not None else S.no_cache(cfg.layer_types(), 50)
        plan = ex.plan_for(full)
        pairs |= {(sig, n) for sig in plan.signatures}
        attn_steps = int((~full.skip["attn"]).sum())
        gemm_calls = sum(linear_calls(cfg, [
            t for t in cfg.layer_types() if not full.skip[t][s]])
            for s in range(50))

        def run(p):
            return _timed(lambda: p.generate(params, gen(), n, label=labels,
                                             schedule=sch))

        counts = graph_counts(ops, ex)
        (x, first_s) = run(graphed)
        counts = graph_counts(ops, ex, counts)
        eager, eager_s = _timed(lambda: ex.sample(params, gen(), n,
                                                  schedule=sch, label=labels))
        same = bool(torch.equal(x, eager))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(same, f"{name}: graphed and eager latents differ")
        check(counts["replayed"]["flash_attention"] == n_attn * attn_steps,
              f"{name}: {counts['replayed']['flash_attention']} replayed "
              f"attention launches, expected {n_attn} x {attn_steps}")
        check(counts["replayed"]["linear"] == gemm_calls,
              f"{name}: {counts['replayed']['linear']} replayed linear "
              f"launches, expected {gemm_calls}")
        check(counts["calls"] == counts["warmup"],
              f"{name}: calls {counts['calls']} besides the warm-ups "
              f"{counts['warmup']}")
        n_graphs = ex.graph_count()
        walls = {"graphs": [], "loop": []}
        for p in (graphed, loop, loop, graphed):
            xr, wall = run(p)
            walls["graphs" if p is graphed else "loop"].append(wall)
            check(bool(torch.equal(xr, x)),
                  f"{name}: a {'graphed' if p is graphed else 'loop'} run "
                  "differs from the first")
        check(ex.graph_count() == n_graphs,
              f"{name}: a second run built a graph")
        # a whole run segment by segment under the sync guard, with its
        # copies' device ms per boundary
        marks = [len(g["copy_in_ms"]) for g in ex.segment_graphs()]
        rs = ex.start_run(params, gen(), n, plan=plan, schedule=full,
                          label=labels)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with segment_graph.timing_copies():
                while not rs.done:
                    rs = ex.advance_run(params, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(bool(torch.equal(rs.x, x)),
              f"{name}: the guarded run differs from generate")
        copy_in, copy_out = [], []
        for g, m in zip(ex.segment_graphs(), marks):
            copy_in += g["copy_in_ms"][m:]
            copy_out += g["copy_out_ms"][m:]
        check(len(copy_in) == len(plan.runs),
              f"{name}: {len(copy_in)} boundaries timed, "
              f"{len(plan.runs)} segments")
        rows[name] = {
            "segments": len(plan.runs),
            "signatures": plan.num_unique_signatures,
            "attn_steps": attn_steps,
            "replayed_launches": counts["replayed"],
            "warmup_calls": counts["warmup"],
            "new_graphs": counts["new_graphs"],
            "first_graphed_s": first_s, "eager_sample_s": eager_s,
            "walls_abba_s": {"graphs": walls["graphs"],
                             "loop": walls["loop"]},
            "bitwise_equal_eager": same,
            "copy_in_ms": {"sum": sum(copy_in), "median": _median(copy_in),
                           "max": max(copy_in, default=None)},
            "copy_out_ms": {"sum": sum(copy_out),
                            "median": _median(copy_out),
                            "max": max(copy_out, default=None)}}
        outs[name] = x
        MEASURED["dit_generate"].setdefault(name, {})["walls"] = walls
    peak = torch.cuda.max_memory_allocated()
    graphs = ex.segment_graphs()
    check(ex.graph_count("seg") == len(pairs)
          == ex.compiled_variant_count("seg") == ex.graph_count(),
          f"{ex.graph_count('seg')} graphs, {len(pairs)} unique (signature,"
          f" batch) pairs, {ex.compiled_variant_count('seg')} seg variants")

    # traced runs: graphed no_cache and static:n=2, and no_cache off.  A
    # trace drops kernel records, so each run is traced again (up to
    # ``TRACE_TRIES`` times) until it holds a record of every attention
    # and linear launch the captures' replays and the wrapper calls made;
    # if none does, its device ms, idle share and attention ms are null
    families = {"flash_attention": ("attn_fwd",),
                "linear": tuple(LINEAR_KERNELS.values())}
    traced = {}
    for tag, p, name in (("graphs", graphed, "no_cache"),
                         ("graphs", graphed, "static:n=2"),
                         ("loop", loop, "no_cache")):
        sch = schedules[name]
        full = sch if sch is not None else S.no_cache(cfg.layer_types(), 50)
        expect = n_attn * int((~full.skip["attn"]).sum())
        for tries in range(1, TRACE_TRIES + 1):
            before = (dict(ops.LAUNCHES), dict(ops.REPLAYED))
            wall_us, prof = _profiled(lambda: p.generate(
                params, gen(), n, label=labels, schedule=sch))
            busy, in_trace = _device_us_by(prof, families)
            replayed = {k: ops.REPLAYED[k] - before[1][k] for k in families}
            issued = {k: ops.LAUNCHES[k] - before[0][k] + replayed[k]
                      for k in families}
            complete = all(in_trace[k][1] == issued[k] for k in families)
            if complete:
                break
        traced[f"{tag}:{name}"] = {
            "wall_ms": wall_us / 1e3, "trace_complete": complete,
            "traces": tries,
            "device_ms": busy / 1e3 if complete else None,
            "idle_share": 1 - busy / wall_us if complete else None,
            "attn_ms": in_trace["flash_attention"][0] / 1e3 if complete
            else None,
            "kernels_in_trace": {k: v[1] for k, v in in_trace.items()},
            "launches": issued,
            "attn_replayed": replayed["flash_attention"]
            if tag == "graphs" else None,
            "expected_attn": expect}
        check(busy > 0, f"the profiler saw no device time ({tag}:{name})")
        check(issued["flash_attention"] == expect
              and in_trace["flash_attention"][1] <= expect,
              f"{tag}:{name}: {issued['flash_attention']} attention "
              f"launches ({in_trace['flash_attention'][1]} in the trace), "
              f"expected {expect}")
        if tag == "graphs":
            check(replayed["flash_attention"] == expect,
                  f"{tag}:{name}: {replayed['flash_attention']} replayed "
                  f"attention launches, expected {expect}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "segment_graphs", "requests": n, "steps": 50,
          "policies": rows,
          "graphs": [{k: g[k] for k in (
              "batch", "skip", "collect", "warmup_s", "capture_s",
              "captured", "buffer_bytes_added", "reserved_bytes",
              "replays")} for g in graphs],
          "graph_count": ex.graph_count(),
          "unique_signature_batch_pairs": len(pairs),
          "seg_variants": ex.compiled_variant_count("seg"),
          "buffer_bytes": sum(g["buffer_bytes_added"] for g in graphs),
          "device_bytes_before": mem0, "peak_device_bytes": peak,
          "traced": traced, "seconds": seconds,
          "budget_s": SEGMENT_GRAPHS_BUDGET_S})
    check(seconds <= SEGMENT_GRAPHS_BUDGET_S,
          f"the segment_graphs phase took {seconds:.1f} s, over its budget")
    return rows


def ssd_kernel_phase(ssd, ref, peaks):
    """SSD kernel vs plain over the sweep, at the prefill shape (where two
    launches must agree bitwise), at a ragged length and on strided views
    of one projection; device times at the prefill shape."""
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    gen = torch.Generator().manual_seed(SEED)

    def inputs(b, l, h, p, g, n, dtype, split=False):
        """Seeded inputs; ``split``: x, b and c are views of one (B, L,
        H·P + 2·G·N) tensor, as ``models/ssm.py`` splits its projection."""
        f = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
        x, dt = f(b, l, h, p), torch.nn.functional.softplus(f(b, l, h) - 1.0)
        a = torch.exp(torch.rand(h, generator=gen))
        bb, cc = f(b, l, g, n), f(b, l, g, n)
        if split:
            xbc = torch.cat([x.reshape(b, l, h * p), bb.reshape(b, l, g * n),
                             cc.reshape(b, l, g * n)], -1).to("cuda", dtype)
            x, bb, cc = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
            return [x.reshape(b, l, h, p), dt.cuda(), a.cuda(),
                    bb.reshape(b, l, g, n), cc.reshape(b, l, g, n)]
        return [x.to("cuda", dtype), dt.cuda(), a.cuda(),
                bb.to("cuda", dtype), cc.to("cuda", dtype)]

    # tests/test_kernels.py's tolerances against its sequential oracle
    tols = {torch.float32: ((2e-4, 2e-3), (1e-4, 1e-2)),
            torch.bfloat16: ((1e-1, 1e-1), (1e-2, 1e-2))}

    def compare(shape, chunk, dtype, elementwise=True, split=False):
        """Element-wise at the sweep's tolerances; at full width, where y
        reaches ~400 and near-zero outputs carry the rounding of large
        sums, max |err| / max |plain| <= 1e-4 for y and the state."""
        t = inputs(*shape, dtype, split)
        y, hT = ssd.ssd_cuda(*t, chunk=chunk)
        yr, hr = ref.ssd_ref(*t, chunk=chunk)
        torch.cuda.synchronize()
        (ya, yr_), (ha, hr_) = tols[dtype]
        row = {"shape": shape, "chunk": chunk, "dtype": str(dtype)[6:],
               **ssd.plan(t[0], t[3], t[4]), "split_views": split,
               "max_abs_err": float((y.float() - yr.float()).abs().max()),
               "max_abs_y": float(yr.float().abs().max()),
               "rel_max_err": rel_err(y, yr),
               "state_rel_max_err": rel_err(hT, hr)}
        if elementwise:
            row["ok"] = bool(
                torch.allclose(y.float(), yr.float(), atol=ya, rtol=yr_)
                and torch.allclose(hT, hr, atol=ha, rtol=hr_))
        else:
            row["ok"] = max(row["rel_max_err"],
                            row["state_rel_max_err"]) <= 1e-4
        check(row["ok"], f"ssd kernel vs plain {row}")
        return row, t, (y, hT)

    sweep = [compare(shape, chunk, dtype)[0]
             for *shape, chunk in ((2, 64, 4, 16, 1, 16, 16),
                                   (1, 96, 8, 32, 2, 32, 32),
                                   (2, 33, 2, 16, 1, 8, 16),
                                   (1, 16, 2, 8, 2, 8, 8),
                                   (1, 50, 2, 6, 1, 5, 13),
                                   (1, 100, 1, 72, 1, 20, 128))
             for dtype in (torch.float32, torch.bfloat16)]
    emit({"ssd_sweep": sweep})
    b, l, h, p, g, n, q = LM_BATCH, LM_PROMPT, 64, 64, 1, 128, 128
    ragged, _, _ = compare((b, 1000, h, p, g, n), q, torch.float32, False)
    split, _, _ = compare((b, l, h, p, g, n), q, torch.float32, False, True)
    check(split["load"] == "cp.async", f"split views took {split['load']}")
    full, t, (y, hT) = compare((b, l, h, p, g, n), q, torch.float32, False)
    y2, hT2 = ssd.ssd_cuda(*t, chunk=q)
    bitwise = bool(torch.equal(y, y2) and torch.equal(hT, hT2))
    emit({"ssd_prefill_shape": full, "ssd_ragged": ragged,
          "ssd_split_views": split, "bitwise_equal": bitwise})
    check(bitwise, "two SSD launches at the prefill shape differ")
    ms = device_ms(lambda: ssd.ssd_cuda(*t, chunk=q))
    plain_ms = device_ms(lambda: ref.ssd_ref(*t, chunk=q), iters=10,
                         reps=3)
    _, passes = _traced(lambda: [ssd.ssd_cuda(*t, chunk=q)
                                 for _ in range(10)])
    work = ssd.work(b, l, h, p, g, n, q)
    flops, nbytes, _ = work
    bound, bound_by = kernel_bound(peaks, work)
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:76",
            "shape": [b, l, h, p, g, n, q], "dtype": "float32",
            **ssd.plan(t[0], t[3], t[4]),
            "max_abs_err": full["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_simt_ms": flops / peaks["fp32"] * 1e3,
            "library_ms": None,
            "pass_ms": {k: us / 1e3 / calls
                        for k, (us, calls) in ssd_passes(passes).items()},
            "flops": flops, "bytes": nbytes}


def ssd_passes(kern):
    """{pass: [device µs, calls]} of the SSD kernels in ``_kernel_times``'s
    result, summed by pass name."""
    out = {}
    for k, (us, calls) in kern.items():
        for name in SASS_KERNELS["ssd"]:
            if name + "<" in k or k.endswith(name):
                row = out.setdefault(name, [0.0, 0])
                row[0] += us
                row[1] += calls
    return out


def rel_err(got, want):
    """max |got - want| / max |want|, on the CPU."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / float(want.abs().max())


def free_lm_weights(gemm):
    """Drop the decode graphs (each holds the prepared halves it
    captured), then every prepared half, and give the memory
    back to the card: what an LM phase does before the next one draws its
    weights."""
    from repro_torch.launch import decode_graph
    decode_graph.release()
    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()


def decode_graph_row(cfg, params, batch, cache_len, memory=None):
    """The record of the decode graph that ``generate`` used for this
    shape (``launch/decode_graph.py``): its key's shape, warm-up and
    capture seconds, the kernel calls captured a step (and the RG-LRU
    library's launches by pass), buffer and pool bytes, replays.  Fails
    unless the graph exists and was captured."""
    from repro_torch.launch import decode_graph
    g = decode_graph.lookup(decode_graph.decode_key(cfg, params, batch,
                                                    cache_len, memory))
    check(g is not None and g.graph is not None,
          f"no captured decode graph for {cfg.name} at batch {batch}, "
          f"cache_len {cache_len}")
    keep = ("batch", "cache_len", "memory_shape", "warmup_s", "capture_s",
            "warmup_launches", "captured", "captured_passes", "buffer_bytes",
            "reserved_bytes")
    return {**{k: g.stats[k] for k in keep}, "replays": g.replays}


def lm_cross_check_phase(cfg, T, params_cpu, params_gpu):
    """Prefill of one 200-token prompt (a ragged last chunk): card against
    CPU, logits and every block's final states."""
    toks = torch.randint(0, cfg.vocab_size, (1, 200),
                         generator=torch.Generator().manual_seed(SEED + 4))
    t0 = time.perf_counter()
    lg_gpu, c_gpu = T.prefill(cfg, params_gpu, toks.cuda())
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg_cpu, c_cpu = T.prefill(cfg, params_cpu, toks)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lg_cpu).all()), "CPU logits not finite")
    errs = {"logits": rel_err(lg_gpu, lg_cpu),
            "conv_state": rel_err(c_gpu[0][0]["conv"], c_cpu[0][0]["conv"]),
            "ssm_state": rel_err(c_gpu[0][0]["ssm"], c_cpu[0][0]["ssm"])}
    emit({"phase": "lm_cross_check", "prompt": 200, "rel_max_err": errs,
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    for name, err in errs.items():
        check(err <= 1e-4, f"card vs CPU prefill {name}: relative error {err}")


def lm_slice_phase(cfg, T, serve, params, ops):
    """The LM main path: prefill + recurrent decode through ``generate``."""
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 5))
    prompts = prompts.cuda()
    marks = {}

    def mark(phase):
        torch.cuda.synchronize()
        marks[phase] = (time.perf_counter(), dict(ops.LAUNCHES))

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    mark("start")
    toks = serve.generate(cfg, params, prompts, LM_GEN, on_phase=mark)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    graph = decode_graph_row(cfg, params, LM_BATCH, LM_PROMPT + LM_GEN)
    (t0, _), (t1, at_prefill), (t2, at_end) = (
        marks["start"], marks["prefill"], marks["decode"])
    steps = LM_GEN - 1
    row = {"phase": "lm_generate", "arch": cfg.name, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "new_tokens": LM_GEN, "prefill_s": t1 - t0,
           "decode_ms_per_step": 1e3 * (t2 - t1) / steps,
           "decode_tokens_per_s": LM_BATCH * steps / (t2 - t1),
           "tokens_per_s": LM_BATCH * LM_GEN / (t2 - t0),
           "ssd_launches_prefill": at_prefill["ssd"],
           "ssd_launches_decode": at_end["ssd"] - at_prefill["ssd"],
           "launches": launches, "peak_device_bytes": peak,
           "decode_graph": graph}
    emit(row)
    check(at_prefill["ssd"] == cfg.num_layers,
          f"{at_prefill['ssd']} SSD launches in the prefill, expected "
          f"{cfg.num_layers}")
    check(at_end["ssd"] == at_prefill["ssd"], "SSD launches in the decode")
    check(launches["flash_attention"] == 0, "attention launched in the LM")
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN), f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of range")
    return prompts, toks, launches


def lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="lm_decode_consistency", memory=None,
                                prefix=None):
    """Teacher-forced decode of the generated tokens against one card
    forward over prompt + all but the last of them: the kernel's final
    state and the conv tail (Mamba-2), or the KV caches — a window's ring
    among them — and the RoPE or sinusoidal positions (an attention LM),
    must hand over to the decode step.  ``memory`` feeds the cross
    branches of the prefill, every step and the forward; ``prefix`` goes
    in front of the prompts, and the steps' positions count it."""
    steps = toks.shape[1] - 1
    plen = prompts.shape[1] + (0 if prefix is None else prefix.shape[1])
    logits, caches = T.prefill(cfg, params, prompts,
                               cache_len=plen + toks.shape[1],
                               prefix_embeds=prefix, memory=memory)
    last = logits[:, -1].clone()
    del logits
    check(all(bool(torch.isfinite(c[k].float()).all())
              for st in caches for c in st for k in c),
          "prefill states not finite")
    dec = []
    for i in range(steps):
        lg, caches = T.decode_step(cfg, params, toks[:, i:i + 1], caches,
                                   pos=plen + i, memory=memory)
        dec.append(lg)
    check(all(bool(torch.isfinite(c[k].float()).all())
              for st in caches for c in st for k in c),
          "decode states not finite")
    del caches
    dec = torch.cat(dec, dim=1)
    full, _ = T.forward(cfg, params, torch.cat([prompts, toks[:, :steps]], 1),
                        prefix_embeds=prefix, memory=memory)
    err = rel_err(dec, full[:, plen:])
    first = rel_err(last, full[:, plen - 1])
    agree = float((dec.argmax(-1) == toks[:, 1:]).float().mean())
    emit({"phase": name, "length": plen + steps,
          "rel_max_err": err, "prefill_last_rel_err": first,
          "limit": 1e-4, "greedy_agreement": agree})
    check(err <= 1e-4 and first <= 1e-4,
          f"decode vs forward logits: relative error {err}, {first}")


def _kernel_times(prof):
    """{kernel name: [self device µs, calls]} from a profile, CUDA kernels
    only."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        row = out.setdefault(evt.key, [0.0, 0])
        row[0] += float(us)
        row[1] += evt.count
    return out


def _traced(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall µs, kernel times)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return wall_us, _kernel_times(prof)


def _profiled(fn):
    """Run ``fn`` once under ``torch.profiler`` recording device activity
    only: (wall µs, the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return wall_us, prof


def _device_us_by(prof, families):
    """(device µs of every CUDA activity, {family: [device µs, count]} of
    those whose name holds one of the family's name fragments) from the
    profiler's raw events, which skips the per-event parsing behind
    ``key_averages`` (slow over a long window).  Kernels replayed from a
    CUDA graph are traced one by one, those of an IF body only when its
    predicate held."""
    busy = 0
    part = {f: [0, 0] for f in families}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            busy += evt.duration_ns()
            for f, frags in families.items():
                if any(fr in evt.name() for fr in frags):
                    part[f][0] += evt.duration_ns()
                    part[f][1] += 1
    return busy / 1e3, {f: [ns / 1e3, n] for f, (ns, n) in part.items()}


def _device_us(prof, fragment):
    """(device µs of every CUDA activity, device µs of those whose name
    holds ``fragment``, their count): ``_device_us_by`` for one family."""
    busy, part = _device_us_by(prof, {fragment: (fragment,)})
    return (busy, *part[fragment])


def _top_kernel(fn, calls=10):
    """The kernel that takes most of the device time of ``calls`` calls of
    ``fn`` in one trace (None if the trace holds none: a trace late in a
    process has come back empty)."""
    _, kern = _traced(lambda: [fn() for _ in range(calls)])
    return max(kern, key=lambda k: kern[k][0])[:90] if kern else None


# traces a profile phase takes at most until its kernel records match the
# wrappers' launch counts (a torch.profiler trace has dropped records)
TRACE_TRIES = 3


def dit_profile_phase(cfg, diffusion, params, ops):
    """Where a DiT-XL/2 step's time goes: one full-width denoiser forward at
    B = 8 (4 requests under CFG) after one untraced warm-up forward —
    device time by kernel, the attention kernel's and the GEMMs' shares of
    it, and the device's idle share of the wall time.  The forward is
    traced again (up to ``TRACE_TRIES`` times) until the trace holds a
    record of every attention and linear launch the wrappers counted; if
    none does, ``trace_complete`` says which family fell short, and that
    family's times and shares, and the device's, are null."""
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn((8,) + cfg.latent_shape, generator=gen).cuda()
    t = torch.full((8,), 500.0, device="cuda")
    label = torch.tensor(REQUEST_LABELS + [cfg.num_classes] * 4,
                         device="cuda")
    diffusion.apply(cfg, params, x, t, label=label)
    for tries in range(1, TRACE_TRIES + 1):
        before = {k: ops.LAUNCHES[k] for k in ("flash_attention", "linear",
                                               "linear_tokens",
                                               "linear_requests")}
        wall_us, kern = _traced(
            lambda: diffusion.apply(cfg, params, x, t, label=label))
        launched = {k: ops.LAUNCHES[k] - v for k, v in before.items()}
        attn = [v for k, v in kern.items() if "attn_fwd" in k]
        linear = {rows: [v for k, v in kern.items() if name in k]
                  for rows, name in LINEAR_KERNELS.items()}
        in_trace = {"flash_attention": sum(n for _, n in attn),
                    "linear": sum(n for v in linear.values() for _, n in v)}
        complete = {k: n == launched[k] for k, n in in_trace.items()}
        if all(complete.values()):
            break
    busy = sum(us for us, _ in kern.values())
    # any other product kernel (cuBLAS, CUTLASS) would break the row
    # contract: every DiT product must go through the port's linear kernels
    library = [k for k in kern
               if not any(n in k for n in LINEAR_KERNELS.values()) and any(
                   f in k.lower() for f in ("gemm", "cutlass", "xmma",
                                            "cublas"))]

    def timed(us, family):
        return us / 1e3 if complete[family] else None

    def share(us):       # of the device time, which needs every record
        return us / busy if all(complete.values()) else None

    by_variant = {rows: {"ms": timed(sum(us for us, _ in v), "linear"),
                         "kernels_in_profile": sum(n for _, n in v),
                         "calls": launched["linear_" + rows]}
                  for rows, v in linear.items()}
    gemm = sum(us for v in linear.values() for us, _ in v)
    attn_us = sum(us for us, _ in attn)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    row = {"phase": "dit_profile", "batch": 8, "wall_ms": wall_us / 1e3,
           "trace_complete": complete, "traces": tries,
           "device_ms": busy / 1e3 if all(complete.values()) else None,
           "idle_share": 1 - busy / wall_us if all(complete.values())
           else None,
           "attn_ms": timed(attn_us, "flash_attention"),
           "attn_calls": launched["flash_attention"],
           "attn_kernels_in_profile": in_trace["flash_attention"],
           "attn_share": share(attn_us),
           "gemm_ms": timed(gemm, "linear"),
           "gemm_share": share(gemm),
           "gemm_calls": launched["linear"],
           "gemm_kernels_in_profile": in_trace["linear"],
           "gemm_variants": by_variant,
           "library_gemm_kernels": library, "kernels": len(kern),
           "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    emit(row)
    check(busy > 0, "the profiler saw no device time")
    # the calls counted by the wrapper, which drops none; the trace's count
    # is a second reading (a trace of this forward has dropped 2 of its 28
    # attention and 18 of its 201 linear kernel records)
    check(row["attn_calls"] == attn_calls(cfg, cfg.layer_types())
          and row["attn_kernels_in_profile"] <= row["attn_calls"]
          and row["gemm_kernels_in_profile"] <= row["gemm_calls"],
          f"{row['attn_calls']} attention calls in one forward "
          f"({row['attn_kernels_in_profile']} kernels in the trace), "
          f"expected {attn_calls(cfg, cfg.layer_types())}")
    want = linear_calls(cfg, cfg.layer_types())
    check(row["gemm_calls"] == want and all(linear.values())
          and not library,
          f"{row['gemm_calls']} linear launches in one forward (expected "
          f"{want}), other product kernels {library}")
    # the four request-row sites: the adaLN modulation of every block, the
    # time MLP's two products, the final modulation
    want = {"requests": cfg.num_layers + 3,
            "tokens": want - cfg.num_layers - 3}
    check(all(by_variant[r]["calls"] == n for r, n in want.items()),
          f"linear calls by variant {by_variant}, expected {want}")


def lm_profile_phase(cfg, T, params, prompts, toks):
    """Where the LM slice's time goes: device time by kernel, and the
    device's idle share of the wall time, for one prefill and for 4 decode
    steps (after one untraced warm-up step)."""
    rows = {}
    _, caches = T.prefill(cfg, params, prompts)
    _, caches = T.decode_step(cfg, params, toks[:, :1], caches)
    runs = {"prefill": lambda: T.prefill(cfg, params, prompts)}

    def decode4():
        c = caches
        for i in range(1, 5):
            _, c = T.decode_step(cfg, params, toks[:, i:i + 1], c)
    runs["decode_4_steps"] = decode4
    for name, fn in runs.items():
        wall_us, kern = _traced(fn)
        busy = sum(us for us, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
        rows[name] = {
            "wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else None,
            "idle_share": 1 - busy / wall_us if busy else None,
            "ssd_ms": sum(us for us, _ in ssd_passes(kern).values()) / 1e3,
            "ssd_pass_ms": {k: us / 1e3
                            for k, (us, _) in ssd_passes(kern).items()},
            "kernels": len(kern),
            "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                    for k, (us, n) in top]}
    emit({"phase": "lm_profile", **rows})
    check(rows["prefill"]["ssd_ms"] > 0, "the prefill trace shows no SSD pass")
    check(set(rows["prefill"]["ssd_pass_ms"]) == set(SASS_KERNELS["ssd"]),
          f"SSD passes in the prefill trace: {rows['prefill']['ssd_pass_ms']}")
    check(rows["decode_4_steps"]["ssd_ms"] == 0, "an SSD pass in the decode")


QWEN3_BLOCKS = 8          # of 40: weights and prepared halves take ~38 GB
QWEN3_CHECK_BLOCKS = 2    # the card-vs-CPU prefill's depth
QWEN3_BUDGET_S = 120


def flex_library(qt, kt, vt, window, softcap):
    """``flex_attention``: the one PyTorch call that computes the kernel's
    function with a softcap (``score_mod``; none when ``softcap`` is None)
    under a causal or banded ``block_mask``, on (B, H, L, D) inputs with
    ``enable_gqa``.  Tried
    compiled (the library's fused Triton kernel), then compiled with 32-row
    blocks (f32 at D 256 may overflow the default's shared memory), then
    eager (the scores materialized).  Inductor and Triton cache under
    ``build/`` and compile in this process, each call from a reset
    compiler with static shapes, so that what an earlier call compiled at
    other shapes does not shape it (without the reset, RecurrentGemma-2B's
    call after Gemma-2-9B's two timed a kernel several times slower than
    in a process of its own).  Returns (route, the call, the failed
    routes' errors)."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    inductor_config.compile_threads = 1

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi
        return keep if window is None else keep & (ki > qi - window)

    if softcap is None:
        score_mod = None
    l = qt.shape[2]
    mask = create_block_mask(mask_mod, None, None, l, l, device=qt.device)
    torch._dynamo.reset()
    routes = (("compiled", torch.compile(flex_attention, dynamic=False), {}),
              ("compiled_block_32", torch.compile(flex_attention,
                                                  dynamic=False),
               {"kernel_options": {"BLOCK_M": 32, "BLOCK_N": 32}}),
              ("eager", flex_attention, {}))
    errors = {}
    for route, fn, kw in routes:
        def call(fn=fn, kw=kw):
            return fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=True, **kw)
        try:
            call()
            torch.cuda.synchronize()
            return route, call, errors
        except Exception as e:   # the next route is timed instead
            errors[route] = f"{type(e).__name__}: {str(e)[:300]}"
    raise RuntimeError(f"flex_attention failed on every route: {errors}")


def attn_lm_attention_phase(fa, ref, peaks, cfg, rand, shape, sass,
                            sass_key, noncausal=False, expand_kv=False,
                            flex=False):
    """The attention kernel at an attention LM's prefill, ``shape`` =
    (prompts, length): q (B, L, H, D), k (B, L, KV, D), v (B, L, KV, Dv)
    from ``rand(*shape)`` — GQA: D = Dv = the head dim; MLA: KV = H, D =
    nope + rope, Dv the value head dim, as ``_mla_full`` expands the
    latent — f32, causal, once for each distinct mixer of the unit
    (``local`` with a window, ``global`` without): against its plain
    version (≤ 5e-5), two launches bitwise, device ms beside its bound
    (the band's work as 3xTF32), the plain version's ms and SDPA's
    (``enable_gqa``; the backend its dispatcher picks, and the kernel a
    trace shows, which a trace late in the process can miss) — the
    library call where there is no softcap, else :func:`flex_attention
    <flex_library>`, with SDPA beside it as ``library_no_softcap_ms``
    (another function: no softcap).
    ``noncausal`` adds the same shape non-causal: how far the
    early-finishing query tiles leave the grid unbalanced.  ``expand_kv``:
    SDPA takes k and v expanded to the query heads (MQA: the backends that
    take no ``enable_gqa``); ``flex``: compiled ``flex_attention`` is
    timed beside SDPA where there is no softcap.  The unit's blocks
    without attention (RG-LRU) are passed over.  Returns ({case: row},
    the instance's SASS rows: names with ``sass_key``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from repro_torch.kernels.timing import device_ms
    from repro_torch.config import AttentionSpec
    from repro_torch.launch.roofline import kernel_bound
    specs = {}
    for blk in cfg.stages[0].unit:
        if isinstance(blk.mixer, AttentionSpec):
            specs.setdefault("global" if blk.mixer.window is None
                             else "local", blk.mixer)
    first = next(iter(specs.values()))
    (b, l), h = shape, first.num_heads
    if first.kind == "mla":
        kv, d = h, first.nope_head_dim + first.rope_head_dim
        dv = first.v_head_dim
    else:
        kv, d = first.num_kv_heads, first.head_dim
        dv = d
    q, k, v = rand(b, l, h, d), rand(b, l, kv, d), rand(b, l, kv, dv)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kte, vte = ((a.repeat_interleave(h // kv, dim=1) for a in (kt, vt))
                if expand_kv else (kt, vt))
    gqa = {} if expand_kv else {"enable_gqa": True}
    i = torch.arange(l, device=q.device)
    cases = {}
    for name, spec in specs.items():
        # the default scale, 1/√D, is MLA's 1/√(nope + rope) too
        kw = dict(causal=True, window=spec.window,
                  softcap=spec.logit_softcap)
        out = fa.flash_attention_cuda(q, k, v, **kw)
        again = fa.flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(tuple(out.shape) == (b, l, h, dv), f"out {tuple(out.shape)}")
        err = float((out - want).abs().max())
        check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
              f"{cfg.name} {name} attention vs plain: max abs err {err}")
        check(bool(torch.equal(out, again)),
              f"two launches of the {cfg.name} {name} attention differ")
        del again, want
        work = fa.work(b, l, l, h, kv, d, dv, causal=True,
                       window=spec.window)
        flops, nbytes, _ = work
        bound, bound_by = kernel_bound(peaks, work)
        if spec.window is None:
            sdpa_kw = dict(is_causal=True, **gqa)
        else:
            sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None]) & (
                i[None, :] > i[:, None] - spec.window), **gqa)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kte, vte, **sdpa_kw)
        sdpa_ms = device_ms(sdpa, iters=10)
        row = {"shape": [b, l, h, kv, d], "dv": dv, "causal": True,
               "window": spec.window, "softcap": spec.logit_softcap,
               **fa.plan(q, k, v), "max_abs_err": err,
               "ms": device_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                               iters=10),
               "plain_ms": device_ms(lambda: ref.flash_attention_ref(
                   q, k, v, **kw), iters=3, reps=3),
               "sdpa_backend": SDPBackend(torch._fused_sdp_choice(
                   qt, kte, vte, **sdpa_kw)).name.lower(),
               "sdpa_kv_expanded": expand_kv,
               "sdpa_kernel": _top_kernel(sdpa)}
        if noncausal:
            row["noncausal_ms"] = device_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=False), iters=10)
        if spec.logit_softcap is None:
            row.update(library="scaled_dot_product_attention",
                       library_ms=sdpa_ms)
            if flex:
                route, fn, errors = flex_library(qt, kt, vt, spec.window,
                                                 None)
                got = fn()
                row.update(flex_route=route, flex_errors=errors,
                           flex_max_abs_diff=float(
                               (got.transpose(1, 2) - out).abs().max()),
                           flex_ms=device_ms(fn, iters=5, reps=3))
                del got, fn
        else:
            route, flex, errors = flex_library(qt, kt, vt, spec.window,
                                               spec.logit_softcap)
            got = flex()
            row.update(
                library=f"flex_attention ({route})", library_errors=errors,
                library_max_abs_diff=float(
                    (got.transpose(1, 2) - out).abs().max()),
                library_ms=device_ms(flex, iters=5, reps=3),
                library_no_softcap_ms=sdpa_ms)
            del got, flex
        row.update(bound_ms=bound, bound_by=bound_by,
                   flops=flops, bytes=nbytes,
                   # grid (B·H, query tiles): tile i walks the key tiles
                   # of its band
                   grid=[b * h, -(-l // fa.query_tile(d))])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if noncausal:
            # a causal call does about half the non-causal work, and its
            # time falls short of half by what the early-finishing query
            # tiles leave idle
            row["noncausal_over_causal"] = row["noncausal_ms"] / row["ms"]
        cases[name] = row
        del out
    del q, k, v, qt, kt, vt, kte, vte
    return cases, {name: r for name, r in sass["flash_attention"].items()
                   if sass_key in name}


def qwen3_kernel_phase(fa, ref, gemm, peaks, cfg, sass):
    """The attention kernel at the prefill's shape — q (4, 1024, 40, 128),
    k = v (4, 1024, 8, 128), f32, causal, 5 query heads per KV head — and
    non-causal, with SDPA as the library call
    (:func:`attn_lm_attention_phase`); then every product
    (:func:`lm_product_phase`)."""
    gen = torch.Generator().manual_seed(SEED + 81)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (LM_BATCH, LM_PROMPT), sass,
        "attn_fwdIfLi128", noncausal=True)
    attn = {**cases["global"], "sass": rows}
    emit({"phase": "qwen3_attention", "limit": 5e-5, **attn})
    return attn, lm_product_phase(gemm, ref, peaks, cfg, rand, LM_BATCH,
                                  LM_PROMPT, "qwen3")


def lm_product_phase(gemm, ref, peaks, cfg, rand, batch, prompt, tag,
                     exclude=()):
    """Every product of an attention LM's blocks (``products.lm_products``)
    but those named in ``exclude``, at the prefill's ``batch · prompt``
    rows and a decode step's ``batch`` against cuBLAS f32 (≤ 5e-5 of the
    output's scale) and an f64 product (≤ ``F64_LIMIT``), each row bitwise
    against fewer rows, timed beside its bound and cuBLAS's; inputs from
    ``rand(*shape)``.  Emits ``<tag>_products``."""
    from repro_torch.kernels.products import lm_products
    t_phase = time.perf_counter()
    sweep, rows_ok, times = [], {}, {}
    for phase, m in (("prefill", batch * prompt), ("decode", batch)):
        for name, _, kk, n, calls in lm_products(
                cfg, m, decode=phase == "decode"):
            if name in exclude:
                continue
            x, w = rand(m, kk), rand(kk, n) / kk ** 0.5
            y = gemm.linear_cuda(x, w)
            want = ref.linear_ref(x, w, None)
            exact = ref.linear_ref(x.double(), w.double(), None)
            fewer = gemm.linear_cuda(x[:m // 2].contiguous(), w)
            torch.cuda.synchronize()
            scale = float(exact.abs().max())
            row = {"phase": phase, "shape": name, "m": m, "k": kk, "n": n,
                   "plan": gemm.plan(kk, n)["tile"],
                   "rel_max_err": float((y - want).abs().max()
                                        / want.abs().max()),
                   "kernel_vs_f64": float((y - exact).abs().max()) / scale,
                   "plain_vs_f64": float((want - exact).abs().max()) / scale,
                   "rows_max_abs_vs_fewer": float(
                       (fewer - y[:m // 2]).abs().max())}
            sweep.append(row)
            check(row["rel_max_err"] <= 5e-5, f"{tag} product {row}")
            check(row["kernel_vs_f64"] <= F64_LIMIT,
                  f"{tag} product against f64 {row}")
            rows_ok[f"{phase}:{name}"] = row["rows_max_abs_vs_fewer"] == 0.0
            del want, exact, fewer, y
            times[f"{phase}:{name}"] = {
                **product_times(gemm, ref, peaks, x, w, None, "tokens",
                                iters=(SWEEP_PREFILL_ITERS
                                       if phase == "prefill" else 50),
                                reps=SWEEP_REPS),
                "calls": calls}
            gemm.release()
    check(all(rows_ok.values()), f"a {tag} product's row changes with the "
          f"rows beside it: {rows_ok}")
    summary = {}
    for phase in ("prefill", "decode"):
        rows = [r for key, r in times.items() if key.startswith(phase)]
        summary[phase] = {key: sum(r[key] * r["calls"] for r in rows)
                          for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms")}
    emit({"phase": f"{tag}_products", "limit": 5e-5,
          "f64_limit": F64_LIMIT, "cases": sweep,
          "times": times, "forward": summary,
          "seconds": time.perf_counter() - t_phase})
    return {"shapes": times, "forward": summary,
            "max_rel_err": max(r["rel_max_err"] for r in sweep),
            "max_kernel_vs_f64": max(r["kernel_vs_f64"] for r in sweep)}


def attn_lm_cross_check_phase(cfg, T, params, blocks, seed, tag,
                              memory=None, prefix=None, moe=None):
    """A prefill of 200 positions (a ragged last query tile) at ``blocks``
    blocks (a count: whole units of the first stage; a tuple: a count per
    stage, as ``lm_cut``), card against CPU on the card's own weights
    copied over: logits and each block's k / v (MLA: ckv / krope; RG-LRU:
    conv / h) caches.  One prompt of 200 tokens (K codebooks each for a
    codebook LM), over ``memory`` (1, Lm, cond_dim) where given; with
    ``prefix`` (1, P, d), P patch embeddings and 200 − P tokens.  With
    ``moe`` (``models.moe``) the experts each MoE call selects are
    compared too: a token whose selection differs passes only at a margin
    ≤ 1e-5 (the k-th minus the (k+1)-th selection score), and the logits
    and k / v caches are compared before the first such position (causal
    attention carries a different expert's output only forward).
    Emits ``<tag>_cross_check``."""
    from repro_torch.kernels.products import lm_cut
    from repro_torch.models.transformer import tree_map
    cut = lm_cut(cfg if isinstance(blocks, tuple)
                 else cfg.replace(stages=cfg.stages[:1]), blocks)
    gpu = {**params, "stages": [
        tuple(tree_map(lambda a, r=st.repeat: a[:r], u) for u in sp)
        for st, sp in zip(cut.stages, params["stages"])]}
    cpu = tree_map(lambda a: a.cpu(), gpu)
    n_pre = 0 if prefix is None else prefix.shape[1]
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab_size, (1, 200 - n_pre) + cb,
                         generator=torch.Generator().manual_seed(seed))
    kw = {"cache_len": 200, "moe_strategy": "dense"}

    def inputs(dev):
        return {"prefix_embeds": None if prefix is None else prefix.to(dev),
                "memory": None if memory is None else memory.to(dev)}

    def run(p, t, dev):
        fn = lambda: T.prefill(cut, p, t, **kw, **inputs(dev))  # noqa: E731
        return _recorded_routes(moe, fn) if moe else (fn(), [])
    ((lg_gpu, c_gpu), r_gpu), gpu_s = _timed(
        lambda: run(gpu, toks.cuda(), "cuda"))
    t0 = time.perf_counter()
    (lg_cpu, c_cpu), r_cpu = run(cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    del cpu
    check(bool(torch.isfinite(lg_cpu).all()), "CPU logits not finite")
    check(len(r_gpu) == len(r_cpu), f"{len(r_gpu)}, {len(r_cpu)} routes")
    keep, margins, differing = 200, [], 0
    for a, b in zip(r_gpu, r_cpu):
        top_k = a[0].shape[-1]
        diff, mg = _selection_diff(a, b, top_k)
        margins += mg
        differing += int(diff.sum())
        if diff.any():
            keep = min(keep, int(diff[0].nonzero()[0]))
    errs = {"logits": rel_err(lg_gpu[:, :keep], lg_cpu[:, :keep])}
    block = 0
    for si, st in enumerate(cut.stages):
        for r in range(st.repeat):
            for i in range(len(st.unit)):
                cg, cc = c_gpu[si][i], c_cpu[si][i]
                for name in sorted(set(cg) - {"slots"}):
                    a, b = cg[name][r], cc[name][r]
                    if keep < 200 and name in ("k", "v"):
                        # the slots (k (B, KV, dh, S), v (B, KV, S, dh))
                        # of the positions before ``keep``
                        slots = cc["slots"][r]
                        held = ((slots >= 0)
                                & (slots < keep)).nonzero()[:, 0]
                        if not len(held):   # a ring past ``keep``
                            continue
                        axis = 3 if name == "k" else 2
                        a = a.index_select(axis, held.to(a.device))
                        b = b.index_select(axis, held)
                    errs[f"{name}{block}"] = rel_err(a, b)
                block += 1
    emit({"phase": f"{tag}_cross_check", "blocks": cut.num_layers,
          "prompt": 200, "prefix": n_pre,
          "memory": 0 if memory is None else memory.shape[1],
          "rel_max_err": errs, "limit": 1e-4,
          **({"selections": sum(int(a[0][..., 0].numel()) for a in r_gpu),
              "selections_differing": differing,
              "positions_compared": keep, "differing_margins": margins,
              "margin_limit": 1e-5} if moe else {}),
          "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(all(mg <= 1e-5 for mg in margins),
          f"card and CPU select other experts at margins {margins}")
    for name, err in errs.items():
        check(err <= 1e-4, f"{tag} card vs CPU prefill {name}: relative "
              f"error {err}")


def mixer_blocks(cfg):
    """(attention blocks, RG-LRU blocks) of an LM config."""
    from repro_torch.config import AttentionSpec, RGLRUSpec
    kinds = [type(b.mixer) for _, _, _, b in cfg.blocks()]
    return kinds.count(AttentionSpec), kinds.count(RGLRUSpec)


def lm_linear_calls(cfg):
    """The linear kernel's calls in an attention LM's prefill and in one
    decode step: its products' calls per forward (``lm_products``; 7 a
    block for GQA, MLA's 8 in a prefill and 7 in a decode step, a cross
    branch's 4 in both)."""
    from repro_torch.kernels.products import lm_products
    return tuple(sum(r[-1] for r in lm_products(cfg, 1, decode=decode,
                                                memory_rows=1))
                 for decode in (False, True))


def attn_calls_lm(cfg):
    """The attention kernel's calls in an attention LM's prefill and in
    one decode step: each attention block's self-attention in the prefill
    (a decode step attends in plain PyTorch over the KV cache), and each
    cross branch in both (its one query row over the memory)."""
    n_attn, _ = mixer_blocks(cfg)
    n_cross = sum(b.cross is not None for _, _, _, b in cfg.blocks())
    return n_attn + n_cross, n_cross


def programs_generate(cfg, params, prompts, prefix, gen_len, cache_len,
                      on_phase):
    """Greedy generation through ``launch.programs``, the entry points that
    take a prefix: the prefill step over ``prefix`` + ``prompts`` (a MoE
    FFN ``dense``, as ``generate`` prefills) with ``cache_len`` slots, then
    the decode graph of that shape from position P + L, one replay a step
    (``launch/decode_graph.py``).  ``on_phase`` as ``generate``'s.
    Returns (B, gen_len) new tokens."""
    from repro_torch.launch import decode_graph, programs
    logits, caches = programs.make_prefill_step(
        cfg, cache_len, moe_strategy="dense")(params, prompts, prefix)
    tok = torch.argmax(logits, dim=-1)
    del logits
    on_phase("prefill")
    out, _ = decode_graph.decode(cfg, params, tok, caches,
                                 prefix.shape[1] + prompts.shape[1],
                                 gen_len - 1, cache_len=cache_len)
    on_phase("decode")
    return out


def attn_lm_generate_phase(cfg, serve, params, ops, shape, seed, tag,
                           passes=None, memory=None, prefix=None, **row):
    """The attention-LM main path: ``generate`` on ``shape`` = (prompts,
    prompt length, new tokens), greedy, cache_len prompt + new, after a
    cold run of 2 tokens, which builds and captures the decode graph of
    that shape (``launch/decode_graph.py``) — the attention kernel once an
    attention block in the prefill and never in the decode, and once a
    cross branch in both (:func:`attn_calls_lm`), the RG-LRU scan once an
    RG-LRU block in the prefill and in every decode step, the linear
    kernel once per product (:func:`lm_linear_calls`) in the prefill and
    in every decode step.  The timed run's decode replays the cold run's
    graph: its launches are the graph's captured calls × the replays
    (``ops.REPLAYED``), and it makes no kernel call from the host.  A codebook LM's prompts and tokens carry K codebooks;
    ``memory`` goes to ``generate``; with ``prefix`` (B, P, d) the run is
    :func:`programs_generate` instead, its caches P + prompt + new.
    ``passes``, where given, reads a kernel library's launch counts by
    pass ({pass: launches}, its host launches and the graphs' replays);
    the timed run's prefill and decode counts go into the row as
    ``passes_prefill`` and ``passes_decode``.  Emits ``<tag>_generate``
    with ``row`` and the decode graph's record added."""
    batch, plen, gen_len = shape
    n_pre = 0 if prefix is None else prefix.shape[1]
    cache_len = n_pre + plen + gen_len
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen) + cb,
                            generator=torch.Generator().manual_seed(seed))
    prompts = prompts.cuda()
    marks = {}

    def mark(phase):
        torch.cuda.synchronize()
        marks[phase] = (time.perf_counter(), _launched(ops),
                        passes() if passes else {}, dict(ops.LAUNCHES))

    def run(n):
        if prefix is not None:
            return programs_generate(cfg, params, prompts, prefix, n,
                                     cache_len, mark)
        return serve.generate(cfg, params, prompts, n, memory=memory,
                              cache_len=cache_len, on_phase=mark)

    # a first, cold generate of 2 tokens at the same shapes: what the
    # first call of each kernel and library routine costs stays out of the
    # timed run
    mark("start")
    run(2)
    cold = {"prefill_s": marks["prefill"][0] - marks["start"][0],
            "decode_step_s": marks["decode"][0] - marks["prefill"][0]}
    _reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    mark("start")
    toks = run(gen_len)
    launches = _launched(ops)
    (t0, _, p0, _), (t1, pre, p1, c1), (t2, end, p2, c2) = (
        marks["start"], marks["prefill"], marks["decode"])
    steps = gen_len - 1
    dec = {k: end[k] - pre[k] for k in end}
    dec_calls = {k: c2[k] - c1[k] for k in c2}
    graph = decode_graph_row(cfg, params, batch, cache_len, memory)
    lin_pre, lin_step = lm_linear_calls(cfg)
    row = {"phase": f"{tag}_generate", "arch": cfg.name,
           "blocks": cfg.num_layers, "batch": batch, "prompt": plen,
           **({"prefix": n_pre} if prefix is not None else {}),
           **({"memory": memory.shape[1]} if memory is not None else {}),
           **({"codebooks": cb[0]} if cb else {}),
           "new_tokens": gen_len, "cache_len": cache_len,
           "prefill_s": t1 - t0, "decode_ms_per_step": 1e3 * (t2 - t1) / steps,
           "decode_tokens_per_s": batch * steps / (t2 - t1),
           "tokens_per_s": batch * gen_len / (t2 - t0),
           "launches_prefill": pre, "launches_decode": dec,
           **({"passes_prefill": {k: p1[k] - p0[k] for k in p1},
               "passes_decode": {k: p2[k] - p1[k] for k in p2}}
              if passes else {}),
           "cold": cold, "decode_graph": graph,
           "peak_device_bytes": torch.cuda.max_memory_allocated(), **row}
    emit(row)
    MEASURED["decode_graphs"][tag] = {"captured": graph["captured"],
                                      "replays": steps}
    n_attn, n_rec = mixer_blocks(cfg)
    attn_pre, attn_step = attn_calls_lm(cfg)
    want = {"flash_attention": (attn_pre, attn_step * steps),
            "rglru_scan": (n_rec, n_rec * steps),
            "linear": (lin_pre, lin_step * steps),
            "linear_tokens": (lin_pre, lin_step * steps),
            "linear_requests": (0, 0), "ssd": (0, 0)}
    for name, (n_pre, n_dec) in want.items():
        check(pre[name] == n_pre and dec[name] == n_dec,
              f"{name}: {pre[name]} launches in the prefill, {dec[name]} in "
              f"the decode; expected {n_pre}, {n_dec}")
    check(not any(dec_calls.values()),
          f"the timed decode called kernels from the host: {dec_calls}")
    check(tuple(toks.shape) == (batch, gen_len) + cb, f"tokens {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of range")
    return prompts, toks, launches, row


# seconds each LM phase's decode-graph A/B may take: 1.5× the most it
# took on the card (7.1, 13.0 and 17.8 s)
DECODE_AB_BUDGET_S = {"qwen3": 11, "recurrentgemma": 20, "musicgen": 27}


class CaptureBroken(RuntimeError):
    """The fault :func:`failed_capture_raises` injects into a capture."""


def failed_capture_raises(cfg, serve, T, params, prompts):
    """A decode step that fails while its graph captures (the fault raised
    inside the capture, before any CUDA call it would break): ``generate``
    raises it, with no fallback to the uncaptured step.  A new shape (one
    prompt) makes a new graph; every decode graph is dropped after."""
    from repro_torch.launch import decode_graph
    real = T.decode_step

    def step(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise CaptureBroken("a fault inside the decode graph's capture")
        return real(*a, **kw)

    T.decode_step, raised = step, False
    try:
        serve.generate(cfg, params, prompts[:1], 3)
    except CaptureBroken:
        raised = True
    finally:
        T.decode_step = real
    torch.cuda.synchronize()
    broken = decode_graph.lookup(decode_graph.decode_key(
        cfg, params, 1, prompts.shape[1] + 3))
    decode_graph.release()
    check(raised and broken is not None and broken.graph is None,
          "a fault in the decode graph's capture did not raise from "
          "generate")
    return raised


def decode_graph_ab_phase(cfg, serve, T, params, ops, prompts, gen_len, tag,
                          memory=None, break_capture=False):
    """The decode graph against the same step launched from the host, on
    the phase's weights and prompts: ``generate``'s two halves, its
    prefill and its greedy decode (``decode_graph.decode``), the decode
    graphed and with ``graphs=False`` in the order A B B A, the tokens and
    the last step's logits bitwise equal across all four, prefill s and
    decode ms a step; then, from one prefill, the graph's steps replayed
    under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read) and the
    graphed decode traced (again, up to ``TRACE_TRIES`` times, until the
    trace holds every linear, attention and RG-LRU launch; its device ms
    and idle share null if none does, and no more records than launches:
    the uncaptured decode's are the ``<tag>_profile`` line's);
    the graph's warm-up, capture, buffer and pool bytes; the peak; with
    ``break_capture``, :func:`failed_capture_raises`.  Emits
    ``<tag>_decode_graph``, held to ``DECODE_AB_BUDGET_S[tag]``."""
    from repro_torch.launch import decode_graph
    t_phase = time.perf_counter()
    batch, plen = prompts.shape[:2]
    cache_len, steps = plen + gen_len, gen_len - 1
    key = decode_graph.decode_key(cfg, params, batch, cache_len, memory)

    def prefill():
        # generate's prefill and greedy first token
        logits, caches = T.prefill(cfg, params, prompts, cache_len=cache_len,
                                   memory=memory, moe_strategy="dense")
        return torch.argmax(logits[:, -1:], dim=-1), caches

    torch.cuda.reset_peak_memory_stats()
    runs = []
    for graphs in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, logits = decode_graph.decode(cfg, params, tok, caches, plen,
                                           steps, cache_len=cache_len,
                                           memory=memory, graphs=graphs)
        torch.cuda.synchronize()
        runs.append({"tokens": toks, "logits": logits, "prefill_s": t1 - t0,
                     "decode_ms": 1e3 * (time.perf_counter() - t1) / steps})
    bitwise = all(torch.equal(r["tokens"], runs[0]["tokens"])
                  and torch.equal(r["logits"], runs[0]["logits"])
                  for r in runs[1:])
    g = decode_graph.lookup(key)
    # the decode alone, from one prefill
    tok, caches = prefill()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded, _ = g.run(params, caches, tok, plen, steps, memory=memory)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    families = {"linear": tuple(LINEAR_KERNELS.values()),
                "flash_attention": ("attn_fwd",),
                "rglru_scan": tuple(SASS_KERNELS["rglru"])}
    for tries in range(1, TRACE_TRIES + 1):
        before = _launched(ops)
        wall_us, prof = _profiled(lambda: g.run(params, caches, tok, plen,
                                                steps, memory=memory))
        busy, in_trace = _device_us_by(prof, families)
        issued = {k: _launched(ops)[k] - before[k] for k in families}
        complete = all(in_trace[k][1] == issued[k] for k in families)
        if complete:
            break
    traced = {"wall_ms": wall_us / 1e3, "ms_per_step": wall_us / 1e3 / steps,
              "trace_complete": complete, "traces": tries,
              "device_ms": busy / 1e3 if complete else None,
              "idle_share": 1 - busy / wall_us if complete else None,
              "launches": issued,
              "kernels_in_trace": {k: v[1] for k, v in in_trace.items()}}
    check(busy > 0, f"{tag}: the profiler saw no device time")
    del caches
    raised = (failed_capture_raises(cfg, serve, T, params, prompts)
              if break_capture else None)
    st = g.stats
    seconds = time.perf_counter() - t_phase
    row = {"phase": f"{tag}_decode_graph", "arch": cfg.name,
           "blocks": cfg.num_layers, "batch": batch, "prompt": plen,
           "steps": steps, "order": ["graphs", "off", "off", "graphs"],
           "decode_ms_per_step": [r["decode_ms"] for r in runs],
           "prefill_s": [r["prefill_s"] for r in runs],
           "bitwise_tokens_and_logits": bitwise,
           "sync_guarded_replays": steps, "traced_graphed_decode": traced,
           "failed_capture_raises": raised,
           "warmup_s": st["warmup_s"], "capture_s": st["capture_s"],
           "captured": st["captured"],
           "captured_passes": st["captured_passes"],
           "buffer_bytes": st["buffer_bytes"],
           "pool_bytes": st["reserved_bytes"],
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seconds": seconds, "budget_s": DECODE_AB_BUDGET_S[tag]}
    emit(row)
    check(bitwise, f"{tag}: graphed and uncaptured decodes differ")
    check(torch.equal(guarded, runs[0]["tokens"]),
          f"{tag}: the sync-guarded replays gave other tokens")
    check(all(in_trace[k][1] <= issued[k] for k in families),
          f"{tag}: the traced graphed decode's trace holds "
          f"{traced['kernels_in_trace']} kernels of {issued} launched")
    check(seconds <= DECODE_AB_BUDGET_S[tag],
          f"the {tag} decode-graph A/B took {seconds} s of its "
          f"{DECODE_AB_BUDGET_S[tag]}")
    return row


def attn_lm_profile_phase(cfg, T, params, prompts, toks, ops, tag,
                          prefill_kw=None, memory=None, prefix=None):
    """Where the attention LM's time goes: one prefill and 4 decode steps
    (after one untraced step), each traced — device ms by kernel, the
    shares of the linear kernel, the attention kernel, the RG-LRU scan,
    cuBLAS (the LM head ``x @ lm_head`` or ``x @ embed.T``, and in the
    decode the attention einsums) and the rest (elementwise), and the
    device's idle share of the wall time.  The calls each run made are
    counted by ``ops.LAUNCHES``; the trace's own kernel counts are reported
    beside them (a trace has dropped a few kernel records).  ``prefill_kw``
    goes to ``T.prefill`` (a MoE model prefills as ``generate`` does,
    ``dense``), with ``prefix`` (its P positions counted) and ``memory``
    (also every decode step's).  Emits ``<tag>_profile``."""
    plen = prompts.shape[1] + (0 if prefix is None else prefix.shape[1])
    cache_len = plen + toks.shape[1]
    prefill_kw = {**(prefill_kw or {}), "prefix_embeds": prefix,
                  "memory": memory}
    _, caches = T.prefill(cfg, params, prompts, cache_len=cache_len,
                          **prefill_kw)
    _, caches = T.decode_step(cfg, params, toks[:, :1], caches, pos=plen,
                              memory=memory)

    def decode4():
        c = caches
        for i in range(1, 5):
            _, c = T.decode_step(cfg, params, toks[:, i:i + 1], c,
                                 pos=plen + i, memory=memory)

    rows = {}
    for name, fn in (("prefill", lambda: T.prefill(cfg, params, prompts,
                                                   cache_len=cache_len,
                                                   **prefill_kw)),
                     ("decode_4_steps", decode4)):
        before = dict(ops.LAUNCHES)
        wall_us, kern = _traced(fn)
        launched = {k: ops.LAUNCHES[k] - before[k]
                    for k in ("flash_attention", "linear", "rglru_scan")}
        busy = sum(us for us, _ in kern.values())
        parts = {"linear": [LINEAR_KERNELS["tokens"]],
                 "attention": ["attn_fwd"],
                 "rglru_scan": list(SASS_KERNELS["rglru"]),
                 "cublas": ["gemm", "gemv", "cutlass", "xmma", "cublas"]}
        share = {}
        for part, frags in parts.items():
            keys = [k for k in kern if any(f in k.lower() for f in frags)
                    and not any(k in s for s in share.values())]
            share[part] = keys
        ms = {part: sum(kern[k][0] for k in keys) / 1e3
              for part, keys in share.items()}
        ms["elementwise"] = busy / 1e3 - sum(ms.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        rows[name] = {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
                      "idle_share": 1 - busy / wall_us, "ms": ms,
                      "share": {k: v / (busy / 1e3) for k, v in ms.items()},
                      "launched": launched,
                      "kernels_in_trace": {
                          part: sum(kern[k][1] for k in keys)
                          for part, keys in share.items()},
                      "kernels": len(kern),
                      "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                              for k, (us, n) in top]}
    emit({"phase": f"{tag}_profile", **rows})
    pre, dec = rows["prefill"], rows["decode_4_steps"]
    lin_pre, lin_step = lm_linear_calls(cfg)
    _, n_rec = mixer_blocks(cfg)
    attn_pre, attn_step = attn_calls_lm(cfg)
    check(pre["launched"] == {"flash_attention": attn_pre,
                              "linear": lin_pre, "rglru_scan": n_rec}
          and dec["launched"] == {"flash_attention": 4 * attn_step,
                                  "linear": 4 * lin_step,
                                  "rglru_scan": 4 * n_rec},
          f"traced runs launched {pre['launched']}, {dec['launched']}")
    check(pre["ms"]["linear"] > 0 and pre["ms"]["attention"] > 0,
          f"the prefill trace lacks a kernel of the path: {pre['ms']}")
    # a trace may drop records: an attention kernel in a decode without
    # cross branches is a fault, a cross branch's count is only read
    check(attn_step or dec["kernels_in_trace"]["attention"] == 0,
          "an attention kernel in the decode trace")
    return rows


def lm_params_phase(cfg, serve, T, seed):
    """An attention LM's weights drawn on the card from a seeded CUDA
    generator (a CPU draw of billions of values takes minutes) and the
    token kernel's prepared halves of every block product.  Returns
    (params, weight bytes, prepared bytes)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    params = serve.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    weight_bytes = sum(a.numel() * a.element_size()
                       for a in tree_leaves(params))
    prepared = T.prepare_linear(params)
    torch.cuda.synchronize()
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "drawn_on": "cuda",
          "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params)),
          "weight_bytes": weight_bytes, "linear_prepared_bytes": prepared,
          "device_bytes": torch.cuda.memory_allocated()})
    check(prepared == dryrun.halves_bytes(T.token_weights(params)),
          f"{prepared} prepared bytes")
    MEASURED["params"][cfg.name] = (cfg, weight_bytes, prepared)
    return params, weight_bytes, prepared


def qwen3_phase(peaks, kernels, sass):
    """The attention-LM serving path at Qwen3-14B's published widths (d
    5120, 40 × 128 heads over 8 KV heads, qk-norm, RoPE θ 1e6, d_ff 17408,
    vocab 151936), 8 of its 40 blocks, after the Mamba phases and before
    the Gemma-2 phase.  Budget ``QWEN3_BUDGET_S``: the weights (4.2 B
    values) are drawn on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = lm_cut(configs.get("qwen3-14b"), QWEN3_BLOCKS)
    attn, products = qwen3_kernel_phase(fa, ref, gemm, peaks, cfg, sass)
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 80)
    attn_lm_cross_check_phase(cfg, T, params, QWEN3_CHECK_BLOCKS, SEED + 82,
                              "qwen3")
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, LM_PROMPT, LM_GEN), SEED + 83,
        "qwen3", weight_bytes=weight_bytes, prepared_bytes=prepared)
    MEASURED["qwen3_prefill_s"] = row["prefill_s"]
    ab = decode_graph_ab_phase(cfg, serve, T, params, ops, prompts, LM_GEN,
                               "qwen3", break_capture=True)
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="qwen3_decode_consistency")
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "qwen3")
    kernels["flash_attention"]["qwen3"] = attn
    kernels["flash_attention"]["qwen3_launches"] = launches["flash_attention"]
    kernels["linear"]["qwen3"] = {
        **products, "profile_prefill_linear_ms":
        profile["prefill"]["ms"]["linear"]}
    kernels["linear"]["qwen3_launches"] = launches["linear"]
    del params, prompts, toks
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "qwen3", "seconds": seconds, "budget_s": QWEN3_BUDGET_S,
          "launches": launches, "decode_graph_ab_s": ab["seconds"]})


GEMMA2_BLOCKS = 12        # of 42: weights and prepared halves take ~32 GB
GEMMA2_CHECK_BLOCKS = 2   # one local/global pair, the card-vs-CPU depth
GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_GEN = 2, 4352, 32   # prompts > window
GEMMA2_BUDGET_S = 150


def gemma2_kernel_phase(fa, ref, gemm, peaks, cfg, sass):
    """The D 256 attention instance at the prefill's shapes — q (2, 4352,
    16, 256), k = v (2, 4352, 8, 256), f32, causal, softcap 50 — with the
    local layers' window 4096 (it binds on query rows 4096…4351) and
    without (the global layers), with ``flex_attention`` as the library
    call and SDPA without the softcap beside it
    (:func:`attn_lm_attention_phase`).  Then every product at 8704 and 2
    rows (:func:`lm_product_phase`)."""
    gen = torch.Generator().manual_seed(SEED + 91)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (GEMMA2_BATCH, GEMMA2_PROMPT), sass,
        "attn_fwd_wideIfLi256E")
    attn = {"cases": cases, "sass": rows}
    emit({"phase": "gemma2_attention", "limit": 5e-5, **attn})
    check(len(attn["sass"]) == 1, f"the f32 D 256 instance in the SASS: "
          f"{list(attn['sass'])}")
    return attn, lm_product_phase(gemm, ref, peaks, cfg, rand, GEMMA2_BATCH,
                                  GEMMA2_PROMPT, "gemma2")


def gemma2_phase(peaks, kernels, sass):
    """The Gemma-2 serving path at Gemma-2-9B's published widths (d 3584,
    16 × 256 heads over 8 KV heads, attention softcap 50, final softcap 30,
    pre- and post-norms, gated GELU-tanh MLP d_ff 14336, tied embeddings
    of 256000 scaled by √d, alternating local (window 4096) and global
    blocks), 12 of its 42 blocks, after the qwen3 phase and before the
    video phase.  The prompts (4352 tokens) pass the window: the local
    layers' mask binds in the prefill's kernel, the ring cache drops
    positions 0–255 and every decode step overwrites a slot.  Budget
    ``GEMMA2_BUDGET_S``; the weights (3.30 B values) are drawn on the
    card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = lm_cut(configs.get("gemma2-9b"), GEMMA2_BLOCKS)
    attn, products = gemma2_kernel_phase(fa, ref, gemm, peaks, cfg, sass)
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 90)
    attn_lm_cross_check_phase(cfg, T, params, GEMMA2_CHECK_BLOCKS,
                              SEED + 92, "gemma2")
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_GEN),
        SEED + 93, "gemma2", weight_bytes=weight_bytes,
        prepared_bytes=prepared)
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="gemma2_decode_consistency")
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "gemma2")
    kernels["flash_attention"]["gemma2"] = attn
    kernels["flash_attention"]["gemma2_launches"] = launches[
        "flash_attention"]
    kernels["linear"]["gemma2"] = {
        **products, "profile_prefill_linear_ms":
        profile["prefill"]["ms"]["linear"]}
    kernels["linear"]["gemma2_launches"] = launches["linear"]
    del params, prompts, toks
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "gemma2", "seconds": seconds,
          "budget_s": GEMMA2_BUDGET_S, "launches": launches,
          "peak_device_bytes": row["peak_device_bytes"]})
    check(seconds <= GEMMA2_BUDGET_S,
          f"the gemma2 phase took {seconds} s of its {GEMMA2_BUDGET_S}")


# of 62: all 62 until the deepseek3 phase came, which this cut pays for
MINICPM3_BLOCKS = 16
MINICPM3_CHECK_BLOCKS = 2
MINICPM3_BUDGET_S = 120
# (D, Dv) pairs of the value-head-dim sweep: MLA's own (the (96, 64)
# instance), a smaller pair and one on the (128, 128) instance (both with
# V's extra columns zero), and Dv = D on the instance MLA's D would take
# without its own
MLA_PAIRS = ((96, 64), (48, 32), (128, 64), (72, 72))


def dv_sweep(fa, ref, rand, pairs):
    """The attention kernel with a value head dim of its own against its
    plain version at each (D, Dv) of ``pairs``: q (2, 100, 4, D) over k
    (2, 100, 2, D) and v (2, 100, 2, Dv), f32 (≤ 5e-5) and bf16 (≤ 5e-2),
    causal and not."""
    sweep = []
    for d, dv in pairs:
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 5e-2)):
            q, k = rand(2, 100, 4, d).to(dtype), rand(2, 100, 2, d).to(dtype)
            v = rand(2, 100, 2, dv).to(dtype)
            for causal in (True, False):
                out = fa.flash_attention_cuda(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                sweep.append({"d": d, "dv": dv, "dtype": str(dtype)[6:],
                              "causal": causal, **fa.plan(q, k, v),
                              "max_abs_err": err})
                check(tuple(out.shape) == (2, 100, 4, dv) and bool(
                    torch.allclose(out.float(), want.float(), atol=tol,
                                   rtol=tol)), f"(D, Dv) sweep {sweep[-1]}")
    return sweep


def minicpm3_kernel_phase(fa, ref, gemm, peaks, cfg, sass):
    """The attention kernel's (96, 64) instance at the prefill's shape —
    q and k (4, 1024, 40, 96), v (4, 1024, 40, 64), f32, causal, as
    ``_mla_full`` expands the latent — with SDPA (a value head dim of its
    own) as the library call (:func:`attn_lm_attention_phase`); a sweep of
    (D, Dv) pairs, f32 and bf16, causal and not, against the plain
    version; then every product (:func:`lm_product_phase`: q_a, q_b, kv_a,
    kv_b in the prefill only, o, the MLP)."""
    gen = torch.Generator().manual_seed(SEED + 101)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    sweep = dv_sweep(fa, ref, rand, MLA_PAIRS)
    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (LM_BATCH, LM_PROMPT), sass,
        "attn_fwdIfLi96ELi")
    attn = {**cases["global"], "sass": rows, "dv_sweep": sweep}
    emit({"phase": "minicpm3_attention", "limit": 5e-5, **attn})
    check(len(rows) == 1, f"the f32 (96, 64) instance in the SASS: "
          f"{list(rows)}")
    return attn, lm_product_phase(gemm, ref, peaks, cfg, rand, LM_BATCH,
                                  LM_PROMPT, "minicpm3")


def minicpm3_phase(peaks, kernels, sass):
    """The MLA serving path at MiniCPM3-4B's published widths, 16 of its
    62 blocks (d 2560, 40 heads, q_lora 768, kv_lora 256, nope 64, rope
    32, v 64, gated SiLU MLP d_ff 6400, tied embeddings of 73448), after
    the gemma2 phase and before the video phase: the prefill's attention
    through the kernel's (96, 64) instance, the decode's absorbed einsums
    over the (ckv, krope) latent cache.  Budget ``MINICPM3_BUDGET_S``; the
    weights are drawn on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = lm_cut(configs.get("minicpm3-4b"), MINICPM3_BLOCKS)
    attn, products = minicpm3_kernel_phase(fa, ref, gemm, peaks, cfg, sass)
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 100)
    attn_lm_cross_check_phase(cfg, T, params, MINICPM3_CHECK_BLOCKS,
                              SEED + 102, "minicpm3")
    m = cfg.stages[0].unit[0].mixer
    cache_len = LM_PROMPT + LM_GEN
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, LM_PROMPT, LM_GEN), SEED + 103,
        "minicpm3", weight_bytes=weight_bytes, prepared_bytes=prepared,
        mla_cache_bytes=4 * cfg.num_layers * LM_BATCH * cache_len * (
            m.kv_lora_rank + m.rope_head_dim))
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="minicpm3_decode_consistency")
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "minicpm3")
    kernels["flash_attention"]["minicpm3"] = attn
    kernels["flash_attention"]["minicpm3_launches"] = launches[
        "flash_attention"]
    kernels["linear"]["minicpm3"] = {
        **products, "profile_prefill_linear_ms":
        profile["prefill"]["ms"]["linear"]}
    kernels["linear"]["minicpm3_launches"] = launches["linear"]
    del params, prompts, toks
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "minicpm3", "seconds": seconds,
          "budget_s": MINICPM3_BUDGET_S, "launches": launches,
          "peak_device_bytes": row["peak_device_bytes"]})
    check(seconds <= MINICPM3_BUDGET_S,
          f"the minicpm3 phase took {seconds} s of its {MINICPM3_BUDGET_S}")


DEEPSEEK3_BLOCKS = (1, 2)   # of (3, 58): the first dense block, 2 MoE blocks
DEEPSEEK3_EXPERTS = 32      # of 256 routed experts: 19.7 GB a MoE block
DEEPSEEK3_CHECK_BLOCKS = (1, 1)
DEEPSEEK3_BUDGET_S = 120
# (D, Dv) pairs of the wide value-head-dim sweep: DeepSeek-V3's MLA and a
# narrower pair (f32: the instance with 16 output n-tiles; bf16: the D 256
# instance with V's columns past Dv zero)
WIDE_PAIRS = ((192, 128), (160, 96))


def moe_cut(cfg, blocks, experts):
    """A MoE LM at every published width, cut to ``blocks`` blocks
    (``lm_cut``) and ``experts`` routed experts (top-k, the router, its
    bias, ``norm_topk``, the scale and the shared expert kept), with no
    MTP head (serving never reads it)."""
    import dataclasses
    from repro_torch.config import MoESpec
    from repro_torch.kernels.products import lm_cut
    cut = lm_cut(cfg, blocks)
    stages = tuple(dataclasses.replace(st, unit=tuple(
        dataclasses.replace(b, ffn=dataclasses.replace(
            b.ffn, num_experts=experts))
        if isinstance(b.ffn, MoESpec) else b for b in st.unit))
        for st in cut.stages)
    return cut.replace(stages=stages, mtp_depth=0)


def moe_block(cfg):
    """(stage, index in the unit, MoESpec) of an LM's first MoE block."""
    from repro_torch.config import MoESpec
    return next((si, bi, b.ffn) for si, st in enumerate(cfg.stages)
                for bi, b in enumerate(st.unit)
                if isinstance(b.ffn, MoESpec))


def deepseek3_kernel_phase(fa, ref, gemm, peaks, cfg, sass):
    """The attention kernel's (192, 128) instance at the prefill's shape —
    q and k (4, 1024, 128, 192), v (4, 1024, 128, 128), f32, causal, as
    ``_mla_full`` expands the latent — with SDPA as the library call
    (:func:`attn_lm_attention_phase`), and the same inputs on V zero-padded
    to 192 (the D 256 instance's 32 output n-tiles: the design without a
    value head dim of its own); the wide (D, Dv) sweep; then every MLA,
    dense-MLP and router product (:func:`lm_product_phase`; the experts'
    are :func:`deepseek3_experts_phase`'s).  The inputs are drawn on the
    card (a CPU draw of DeepSeek-V3's widths takes seconds)."""
    import torch.nn.functional as F
    from repro_torch.kernels.timing import device_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 111)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    sweep = dv_sweep(fa, ref, rand, WIDE_PAIRS)
    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (LM_BATCH, LM_PROMPT), sass,
        "attn_fwd_wideIfLi128E")
    attn = {**cases["global"], "sass": rows, "dv_sweep": sweep}
    m = cfg.stages[0].unit[0].mixer
    d, dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    q, k = (rand(LM_BATCH, LM_PROMPT, m.num_heads, d) for _ in range(2))
    v = rand(LM_BATCH, LM_PROMPT, m.num_heads, dv)
    vp = F.pad(v, (0, d - dv))
    out = fa.flash_attention_cuda(q, k, v)
    padded = fa.flash_attention_cuda(q, k, vp)[..., :dv]
    attn.update(
        padded_v_ms=device_ms(lambda: fa.flash_attention_cuda(q, k, vp),
                              iters=10),
        padded_v_max_abs_diff=float((padded - out).abs().max()))
    attn["padded_v_over_own"] = attn["padded_v_ms"] / attn["ms"]
    del q, k, v, vp, out, padded
    emit({"phase": "deepseek3_attention", "limit": 5e-5, **attn})
    check(len(rows) == 1, f"the f32 (192, 128) instance in the SASS: "
          f"{list(rows)}")
    check(attn["padded_v_max_abs_diff"] <= 5e-5,
          f"(192, 128) against V padded to 192: "
          f"{attn['padded_v_max_abs_diff']}")
    return attn, lm_product_phase(
        gemm, ref, peaks, cfg, rand, LM_BATCH, LM_PROMPT, "deepseek3",
        exclude=("expert_up_gate", "expert_down", "shared_up_gate",
                 "shared_down"))


def moe_experts_phase(gemm, ref, moe, peaks, cfg, params, tag, tokens,
                      group, seed):
    """One MoE block's expert products — the routed experts' up, gate and
    down and the shared expert's, on the first MoE block's own weights and
    their prepared halves — at the decode's capacity rows (8 an expert)
    and at the dense prefill's (``tokens`` an expert), both ways on the
    same inputs: the linear kernel product by product (3 E + 3 launches,
    as ``moe._expert`` makes them), its plain version (``x @ w`` per
    product), and cuBLAS's batched f32 product (``torch.bmm`` over the
    stacked (E, rows, d) × (E, d, f), TF32 off, with ``torch.mm`` for the
    shared expert), beside the bound of the same work (3xTF32 on the
    tensor cores, or the bytes).  Then one MoE FFN (router, experts,
    combine, shared expert) at ``tokens`` under ``dense`` (every expert on
    every token, as ``generate`` prefills) and ``gshard`` (groups of
    ``group``).  Emits ``<tag>_experts``."""
    from repro_torch.kernels.timing import device_ms
    from repro_torch.models.transformer import tree_map
    from repro_torch.launch.roofline import kernel_bound
    t_phase = time.perf_counter()
    si, bi, spec = moe_block(cfg)
    ffn = tree_map(lambda a: a[0], params["stages"][si][bi]["ffn"])
    sh = ffn["shared"]
    e_n, d, f, fs = spec.num_experts, cfg.d_model, spec.d_ff, spec.d_ff_shared
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for case, rows in (("decode_capacity", 8), ("prefill_dense", tokens)):
        x = torch.randn(e_n + 1, rows, d, generator=gen, device="cuda")
        h = torch.randn(e_n, rows, f, generator=gen, device="cuda")
        hs = torch.randn(rows, fs, generator=gen, device="cuda")
        ws = ([(x[e], ffn[n][e]) for e in range(e_n)
               for n in ("w_up", "w_gate")]
              + [(h[e], ffn["w_down"][e]) for e in range(e_n)]
              + [(x[e_n], sh["w_up"]), (x[e_n], sh["w_gate"]),
                 (hs, sh["w_down"])])

        def loop():
            return [gemm.linear_cuda(a, w) for a, w in ws]

        def library():
            return [torch.bmm(x[:e_n], ffn["w_up"]),
                    torch.bmm(x[:e_n], ffn["w_gate"]),
                    torch.bmm(h, ffn["w_down"]),
                    torch.mm(x[e_n], sh["w_up"]),
                    torch.mm(x[e_n], sh["w_gate"]), torch.mm(hs, sh["w_down"])]

        got = loop()
        up, gate, down, *shared = library()
        want = ([t for e in range(e_n) for t in (up[e], gate[e])]
                + list(down) + shared)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        del got, want, up, gate, down, shared
        works = [gemm.work(a.shape[0], *w.shape) for a, w in ws]
        flops, nbytes = (sum(w[i] for w in works) for i in (0, 1))
        bound, bound_by = kernel_bound(peaks, (flops, nbytes, "3xtf32"))
        iters = 20 if rows <= 8 else 2
        row = {"rows_per_expert": rows, "experts": e_n, "shared": 1,
               "products": len(ws), "rel_max_err": err,
               "ms": device_ms(loop, iters=iters, reps=3, warmup=2),
               "plain_ms": device_ms(
                   lambda: [ref.linear_ref(a, w, None) for a, w in ws],
                   iters=iters, reps=3, warmup=2),
               "library": "torch.bmm (f32, TF32 off) + torch.mm",
               "library_ms": device_ms(library, iters=iters, reps=3,
                                       warmup=2),
               "bound_ms": bound, "bound_by": bound_by,
               "flops": flops, "bytes": nbytes,
               "plan": {"up_gate": gemm.launch_plan(rows, d, f),
                        "down": gemm.launch_plan(rows, f, d)}}
        row["kernel_over_library"] = row["ms"] / row["library_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        cases[case] = row
        check(err <= 5e-5, f"expert products against cuBLAS: {row}")
        del x, h, hs, ws
    x = torch.randn(LM_BATCH, tokens // LM_BATCH, d, generator=gen,
                    device="cuda")
    ffn_ms = {s: device_ms(lambda s=s: moe.apply(spec, ffn, x, strategy=s,
                                                 group_size=group),
                           iters=2, reps=2, warmup=1)
              for s in ("dense", "gshard")}
    row = {"phase": f"{tag}_experts", "limit": 5e-5, "cases": cases,
           "moe_ffn_tokens": tokens, "moe_ffn_ms": ffn_ms,
           "gshard_group": group,
           "gshard_capacity": moe.capacity(spec, group),
           "dense_over_gshard": ffn_ms["dense"] / ffn_ms["gshard"],
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    return row


def _recorded_routes(moe, fn):
    """Run ``fn`` with ``moe.route`` recording, per call, the selected
    experts and the selection scores (on the CPU).  Returns (fn's result,
    the records)."""
    records, real = [], moe.route

    def route(spec, params, x):
        w, idx, probs = real(spec, params, x)
        records.append((idx.cpu(), moe.selection_scores(
            spec, params, probs).cpu()))
        return w, idx, probs

    moe.route = route
    try:
        return fn(), records
    finally:
        moe.route = real


def _selection_diff(a, b, k):
    """Where two runs' top-k selections differ as sets of experts: ``a``,
    ``b`` = (idx (..., k), scores (..., E)).  Returns (a bool mask (...,)
    of the differing tokens, their margins: the k-th minus the (k+1)-th
    selection score, the larger of the two runs')."""
    diff = (torch.sort(a[0], dim=-1).values
            != torch.sort(b[0], dim=-1).values).any(-1)

    def margin(scores):
        top = torch.topk(scores[diff], k + 1, dim=-1).values
        return top[:, k - 1] - top[:, k]
    if not diff.any():
        return diff, []
    return diff, torch.maximum(margin(a[1]), margin(b[1])).tolist()


def moe_decode_consistency_phase(cfg, T, moe, params, prompts, toks, tag,
                                 prefix=None):
    """Teacher-forced decode (gshard, 8 capacity rows an expert) of the
    generated tokens against one ``dense`` card forward over prompt + all
    but the last of them (≤ 1e-4 relative), and each decode step's expert
    selections against the forward's at the same positions.  A differing
    selection passes only at a margin ≤ 1e-5 (as in the cross check), and
    the logits are compared at the steps before the first one (a MoE
    block's output reaches later positions through the next block's
    attention).  ``prefix`` goes in front of the prompts, and the steps'
    positions count it.  Greedy agreement is reported."""
    steps = toks.shape[1] - 1
    plen = prompts.shape[1] + (0 if prefix is None else prefix.shape[1])
    top_k = moe_block(cfg)[2].top_k
    logits, caches = T.prefill(cfg, params, prompts,
                               cache_len=plen + toks.shape[1],
                               prefix_embeds=prefix, moe_strategy="dense")
    last = logits[:, -1].clone()
    del logits

    def decode():
        c, out = caches, []
        for i in range(steps):
            lg, c = T.decode_step(cfg, params, toks[:, i:i + 1], c,
                                  pos=plen + i)
            out.append(lg)
        check(all(bool(torch.isfinite(c_[n].float()).all())
                  for st in c for c_ in st for n in c_),
              "decode states not finite")
        return torch.cat(out, dim=1)

    dec, r_dec = _recorded_routes(moe, decode)
    del caches
    (full, _), r_full = _recorded_routes(moe, lambda: T.forward(
        cfg, params, torch.cat([prompts, toks[:, :steps]], 1),
        prefix_embeds=prefix, moe_strategy="dense"))
    moe_blocks = len(r_full)
    check(len(r_dec) == moe_blocks * steps, f"{len(r_dec)} decode routes")
    first_diff, margins, differing = steps, [], 0
    for i in range(steps):
        for j in range(moe_blocks):
            # a decode step routes its B tokens as one gshard group
            idx_d, sc_d = (a.reshape(prompts.shape[0], -1)
                           for a in r_dec[i * moe_blocks + j])
            idx_f, sc_f = r_full[j]
            diff, mg = _selection_diff(
                (idx_d, sc_d), (idx_f[:, plen + i], sc_f[:, plen + i]),
                top_k)
            if diff.any():
                first_diff = min(first_diff, i)
                margins += mg
                differing += int(diff.sum())
    err = (rel_err(dec[:, :first_diff], full[:, plen:plen + first_diff])
           if first_diff else 0.0)
    first = rel_err(last, full[:, plen - 1])
    agree = float((dec.argmax(-1) == toks[:, 1:]).float().mean())
    emit({"phase": f"{tag}_decode_consistency", "length": plen + steps,
          "rel_max_err": err, "prefill_last_rel_err": first,
          "limit": 1e-4, "greedy_agreement": agree,
          "selections": prompts.shape[0] * steps * moe_blocks,
          "selections_differing": differing,
          "steps_compared": first_diff, "differing_margins": margins,
          "margin_limit": 1e-5})
    check(all(mg <= 1e-5 for mg in margins),
          f"decode and forward select other experts at margins {margins}")
    check(err <= 1e-4 and first <= 1e-4,
          f"decode vs forward logits: relative error {err}, {first}")


def deepseek3_phase(peaks, kernels, sass):
    """The MoE serving path at DeepSeek-V3's published widths (d 7168, 128
    MLA heads, q-LoRA 1536, a kv latent of 512 and a shared RoPE key of
    64, nope 128, v 128, dense MLP d_ff 18432, routed and shared experts
    d_ff 2048, an untied head of 129280, a sigmoid router with a selection
    bias, top-8, ``norm_topk``, scale 2.5, one shared expert), after the
    minicpm3 phase and before the video phase.  Cut for the card's memory
    (a MoE block's 256 routed experts are 45.1 GB of f32, and their
    prepared halves twice that): 32 of the 256 routed experts, 1 dense + 2
    MoE blocks of 3 + 58, no MTP head (serving never reads it) — 22.9 GB
    of weights and 30.9 GB of halves.  The prefill's attention runs the
    kernel's (192, 128) instance; the MoE FFN dispatches ``dense`` in the
    prefill and ``gshard`` in the decode, as the JAX package's
    ``generate``.  Budget ``DEEPSEEK3_BUDGET_S``; the weights (5.72 B
    values) are drawn on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer as T
    t_phase = time.perf_counter()
    cfg = moe_cut(configs.get("deepseek-v3-671b"), DEEPSEEK3_BLOCKS,
                  DEEPSEEK3_EXPERTS)
    attn, products = deepseek3_kernel_phase(fa, ref, gemm, peaks, cfg, sass)
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 110)
    experts = moe_experts_phase(gemm, ref, moe, peaks, cfg, params,
                                "deepseek3", LM_BATCH * LM_PROMPT, 2048,
                                SEED + 114)
    attn_lm_cross_check_phase(cfg, T, params, DEEPSEEK3_CHECK_BLOCKS,
                              SEED + 112, "deepseek3", moe=moe)
    m = cfg.stages[0].unit[0].mixer
    cache_len = LM_PROMPT + LM_GEN
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, LM_PROMPT, LM_GEN), SEED + 113,
        "deepseek3", weight_bytes=weight_bytes, prepared_bytes=prepared,
        mla_cache_bytes=4 * cfg.num_layers * LM_BATCH * cache_len * (
            m.kv_lora_rank + m.rope_head_dim),
        blocks_per_stage=list(DEEPSEEK3_BLOCKS),
        routed_experts=DEEPSEEK3_EXPERTS)
    moe_decode_consistency_phase(cfg, T, moe, params, prompts, toks,
                                 "deepseek3")
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "deepseek3",
                                    prefill_kw={"moe_strategy": "dense"})
    kernels["flash_attention"]["deepseek3"] = attn
    kernels["flash_attention"]["deepseek3_launches"] = launches[
        "flash_attention"]
    kernels["linear"]["deepseek3"] = {
        **products, "experts": experts["cases"],
        "moe_ffn_ms": experts["moe_ffn_ms"],
        "profile_prefill_linear_ms": profile["prefill"]["ms"]["linear"]}
    kernels["linear"]["deepseek3_launches"] = launches["linear"]
    del params, prompts, toks
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "deepseek3", "seconds": seconds,
          "budget_s": DEEPSEEK3_BUDGET_S, "launches": launches,
          "peak_device_bytes": row["peak_device_bytes"]})
    check(seconds <= DEEPSEEK3_BUDGET_S,
          f"the deepseek3 phase took {seconds} s of its {DEEPSEEK3_BUDGET_S}")


RECURRENTGEMMA_CHECK_BLOCKS = 3   # one (rec, rec, attn) unit
RECURRENTGEMMA_BATCH, RECURRENTGEMMA_PROMPT = 2, 3072   # prompts > window
RECURRENTGEMMA_GEN = 32
RECURRENTGEMMA_BUDGET_S = 120


def _scan_inputs(gen, b, l, w):
    """RG-LRU scan inputs drawn on the card: xr, gate and one (B, L, 2W)
    product whose halves are ga and gx (the views ``models/rglru.py``
    hands over), and Λ as the model's init draws it (a ∈ [0.9, 0.999] at
    r = 1)."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    xr, gate, g = rand(b, l, w), rand(b, l, w), rand(b, l, 2 * w)
    u = 0.81 + (0.998001 - 0.81) * torch.rand(w, generator=gen,
                                              device="cuda")
    a = torch.log(torch.expm1(-torch.log(u) / 16.0))
    return [xr, g[..., :w], g[..., w:], gate, a]


def recurrentgemma_scan_phase(rglru, ref, peaks, cfg, sass):
    """The RG-LRU scan kernel against its plain version on the card: the
    prefill's (2, 3072, 2560) from h0 = 0 and from a random h0, the
    decode's (2, 1, 2560) from a random h0, L 1, 7 and 300, either side of
    the chunk boundaries (L = T − 1, T, T + 1, 3T + 5 for the kernel's
    chunk T, from a random h0), W 200 (not a multiple of the block), each
    with ga and gx strided views of one product as the model hands them
    over, and the prefill's shape with every input contiguous (≤ 5e-5 of
    max |y| and of max |hT|); two launches and row b against row b alone
    bitwise; the passes each case's first call launched, read from the
    library's counts and held to ``rglru.plan``; device ms at the prefill
    and decode shapes beside the bytes bound and the plain version's, and
    the launches per call of every timed call, held the same way; per
    pass, the device ms of a launch from a trace of 10 calls (100 at L 1)
    with the launches the trace recorded, and the registers, stack and
    FFMA count of the ``sass`` line.  Returns the ``kernels`` entry
    (launches filled in by the generate)."""
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    m = next(b.mixer for _, _, _, b in cfg.blocks()
             if not hasattr(b.mixer, "num_kv_heads"))
    c, w = m.c_constant, m.expand * cfg.d_model
    bsz, l, q = RECURRENTGEMMA_BATCH, RECURRENTGEMMA_PROMPT, rglru.CHUNK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 121)
    cases, timed = [], {}
    for name, (b, steps, width, with_h0, contiguous) in {
            "prefill": (bsz, l, w, False, False),
            "prefill_contiguous": (bsz, l, w, False, True),
            "decode": (bsz, 1, w, True, False),
            "l1": (bsz, 1, w, False, False), "l7": (bsz, 7, w, True, False),
            "l300": (bsz, 300, w, True, False),
            "w200": (3, 50, 200, True, False),
            "chunk_minus_1": (bsz, q - 1, w, True, False),
            "chunk": (bsz, q, w, True, False),
            "chunk_plus_1": (bsz, q + 1, w, True, False),
            "3_chunks_plus_5": (bsz, 3 * q + 5, w, True, False),
            "prefill_h0": (bsz, l, w, True, False)}.items():
        t = _scan_inputs(gen, b, steps, width)
        if contiguous:
            t = [a.contiguous() for a in t]
        h0 = torch.randn(b, width, generator=gen, device="cuda") \
            if with_h0 else None
        before = rglru.launched()
        y, hT = rglru.rglru_scan_cuda(*t, c, h0)
        launched = {k: n - before[k] for k, n in rglru.launched().items()}
        y2, hT2 = rglru.rglru_scan_cuda(*t, c, h0)
        one = rglru.rglru_scan_cuda(*(a[-1:] for a in t[:4]), t[4], c,
                                    None if h0 is None else h0[-1:])
        yr, hr = ref.rglru_scan_ref(*t, c, h0)
        torch.cuda.synchronize()
        row = {"case": name, "shape": [b, steps, width], "h0": with_h0,
               "strided_gates": not t[1].is_contiguous(),
               "launched": launched,
               "max_abs_err": float((y - yr).abs().max()),
               "max_abs_y": float(yr.abs().max()),
               "state_max_abs_err": float((hT - hr).abs().max()),
               "max_abs_state": float(hr.abs().max()),
               "bitwise_repeat": bool(torch.equal(y, y2)
                                      and torch.equal(hT, hT2)),
               "bitwise_row_alone": bool(torch.equal(one[0], y[-1:])
                                         and torch.equal(one[1], hT[-1:]))}
        cases.append(row)
        check(row["max_abs_err"] <= 5e-5 * row["max_abs_y"]
              and row["state_max_abs_err"] <= 5e-5 * row["max_abs_state"],
              f"rglru scan vs plain {row}")
        check(row["bitwise_repeat"] and row["bitwise_row_alone"],
              f"rglru scan not bitwise {row}")
        check(launched == {k: int(k in rglru.plan(steps))
                           for k in rglru.PASSES},
              f"rglru scan at L {steps} launched {launched}, the plan "
              f"{rglru.plan(steps)}")
        if name in ("prefill", "decode"):
            work = rglru.work(b, steps, width, with_h0)
            ops_count, nbytes, _ = work
            bound, bound_by = kernel_bound(peaks, work)
            calls = [0]

            def call():
                calls[0] += 1
                return rglru.rglru_scan_cuda(*t, c, h0)

            before = rglru.launched()
            ms = device_ms(call, iters=20 if steps > 1 else 50)
            per_call = {k: (n - before[k]) / calls[0]
                        for k, n in rglru.launched().items()}
            traced_calls = 10 if steps > 1 else 100
            _, kern = _traced(lambda: [rglru.rglru_scan_cuda(*t, c, h0)
                                       for _ in range(traced_calls)])
            # a short trace late in a process drops records or comes back
            # empty: each pass's ms is the mean of the launches it recorded
            passes = {k: {"traced_launches": n_, "traced_calls": traced_calls,
                          "ms_per_launch": us / 1e3 / n_}
                      for k, (us, n_) in rglru.pass_totals(kern).items()}
            timed[name] = {
                "shape": [b, steps, width], "bytes": nbytes,
                "operations": ops_count,
                "max_abs_err": row["max_abs_err"], "ms": ms,
                "plain_ms": device_ms(lambda: ref.rglru_scan_ref(*t, c, h0),
                                      iters=3, reps=3),
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": None,
                "timed_calls": calls[0],
                "launches_per_call": per_call,
                "passes": passes}
            timed[name]["bound_share"] = (timed[name]["bound_ms"]
                                          / timed[name]["ms"])
            check(per_call == {k: float(k in rglru.plan(steps))
                               for k in rglru.PASSES}
                  and set(passes) <= set(rglru.plan(steps)),
                  f"rglru scan at L {steps}: launches per call {per_call}, "
                  f"traced {passes}; the plan {rglru.plan(steps)}")
        del t, y, y2, hT, hT2, one, yr, hr
    emit({"phase": "recurrentgemma_scan", "limit": 5e-5, "chunk": q,
          "cases": cases, "times": timed, "sass": sass,
          "library": "none: no single PyTorch call computes a gated "
                     "linear recurrence"})
    pre = timed["prefill"]
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/rglru.cu",
            "replaces": "no TPU kernel: jax.lax.associative_scan, which "
                        "XLA fuses into the layer on the TPU "
                        "(src/repro/models/rglru.py:98); added so the "
                        "recurrence runs on every SM as a chunked scan",
            "shape": pre["shape"], "dtype": "float32", "chunk": q,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": pre["ms"], "plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": None, "passes": pre["passes"],
            "decode": timed["decode"],
            "bytes": pre["bytes"], "operations": pre["operations"]}


def recurrentgemma_kernel_phase(fa, ref, gemm, peaks, cfg, sass):
    """The attention kernel's D 256 instance as MQA at the prefill's shape
    — q (2, 3072, 10, 256), k = v (2, 3072, 1, 256), f32, causal, window
    2048 (it binds on query rows 2048…3071) — against its plain version,
    with SDPA (the band as a boolean mask, k and v expanded to the 10
    heads) and compiled ``flex_attention`` (the band as a ``block_mask``)
    beside it
    (:func:`attn_lm_attention_phase`); then every product at 6144 and 2
    rows, the gate heads' (256, 256) among them (:func:`lm_product_phase`).
    The inputs are drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 122)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand,
        (RECURRENTGEMMA_BATCH, RECURRENTGEMMA_PROMPT), sass,
        "attn_fwd_wideIfLi256E", expand_kv=True, flex=True)
    attn = {**cases["local"], "sass": rows}
    emit({"phase": "recurrentgemma_attention", "limit": 5e-5, **attn})
    check(len(rows) == 1, f"the f32 D 256 instance in the SASS: "
          f"{list(rows)}")
    return attn, lm_product_phase(gemm, ref, peaks, cfg, rand,
                                  RECURRENTGEMMA_BATCH,
                                  RECURRENTGEMMA_PROMPT, "recurrentgemma")


def recurrentgemma_conv_ms(cfg, params):
    """Device ms of the RG-LRU blocks' causal conv (plain PyTorch
    elementwise kernels, which a trace does not tell from the others) in
    one prefill and in one decode step: one block's conv at the prefill's
    and the decode's shapes, on its own weights, times the RG-LRU
    blocks."""
    from repro_torch.kernels.timing import device_ms
    from repro_torch.models import rglru
    from repro_torch.models.transformer import tree_map
    unit = cfg.stages[0].unit
    i = next(j for j, b in enumerate(unit)
             if not hasattr(b.mixer, "num_kv_heads"))
    p = tree_map(lambda a: a[0], params["stages"][0][i]["mixer"])
    k, w = p["conv_w"].shape
    b, l = RECURRENTGEMMA_BATCH, RECURRENTGEMMA_PROMPT
    x = torch.randn(b, l, w, device="cuda")
    win = torch.randn(b, k, w, device="cuda")
    n = mixer_blocks(cfg)[1]
    return {"prefill": n * device_ms(lambda: rglru._causal_conv(p, x),
                                     iters=10),
            "decode_step": n * device_ms(lambda: rglru._conv(p, win, 1))}


def rglru_passes(rglru):
    """A reader of the RG-LRU library's launches by pass: its own (host
    launches, a capture's recorded ones among them) and the decode graphs'
    replays of captured ones (``rglru.REPLAYED``)."""
    return lambda: {k: v + rglru.REPLAYED[k]
                    for k, v in rglru.launched().items()}


def recurrentgemma_phase(peaks, kernels, sass):
    """The hybrid serving path at RecurrentGemma-2B's published widths and
    all 26 blocks — (rec, rec, local MQA) × 8 + (rec, rec): d 2560, the
    RG-LRU 2560 wide with 10 gate heads of 256 and a conv of 4, attention
    10 × 256 over 1 KV head with a window of 2048, gated GELU-tanh MLP
    d_ff 7680, tied embeddings of 256000 scaled by √d — after the deepseek3
    phase and before the video phase.  The prompts (3072 tokens) pass the
    window: the mask binds on query rows 2048…3071 in the prefill's
    kernel, the ring cache keeps 2048 slots and every decode step
    overwrites one.  Budget ``RECURRENTGEMMA_BUDGET_S``; the weights
    (2.68 B values) are drawn on the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.kernels import rglru
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = configs.get("recurrentgemma-2b")
    scan = recurrentgemma_scan_phase(rglru, ref, peaks, cfg,
                                     sass["rglru"])
    attn, products = recurrentgemma_kernel_phase(fa, ref, gemm, peaks, cfg,
                                                 sass)
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 120)
    attn_lm_cross_check_phase(cfg, T, params, RECURRENTGEMMA_CHECK_BLOCKS,
                              SEED + 123, "recurrentgemma")
    b, plen = RECURRENTGEMMA_BATCH, RECURRENTGEMMA_PROMPT
    n_attn, n_rec = mixer_blocks(cfg)
    m = next(blk.mixer for _, _, _, blk in cfg.blocks()
             if hasattr(blk.mixer, "num_kv_heads"))
    width = cfg.d_model
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (b, plen, RECURRENTGEMMA_GEN), SEED + 124,
        "recurrentgemma", passes=rglru_passes(rglru),
        weight_bytes=weight_bytes,
        prepared_bytes=prepared,
        # per RG-LRU block: the conv tail (3 steps) and h, f32; per
        # attention block: k and v over the window's 2048 slots
        state_cache_bytes=4 * n_rec * b * 4 * width,
        kv_cache_bytes=4 * n_attn * b * 2 * m.window * m.num_kv_heads
        * m.head_dim)
    # the scan's passes as the library counted them in the generate: the
    # plan of a prompt's length once an RG-LRU block in the prefill, a
    # step's in every decode step
    steps = RECURRENTGEMMA_GEN - 1
    per_call = {"prefill": {k: v / n_rec
                            for k, v in row["passes_prefill"].items()},
                "decode": {k: v / (n_rec * steps)
                           for k, v in row["passes_decode"].items()}}
    for part, l in (("prefill", plen), ("decode", 1)):
        check(per_call[part] == {k: float(k in rglru.plan(l))
                                 for k in rglru.PASSES},
              f"rglru scan in the generate's {part}: launches per call "
              f"{per_call[part]}, the plan {rglru.plan(l)}")
    ab = decode_graph_ab_phase(cfg, serve, T, params, ops, prompts,
                               RECURRENTGEMMA_GEN, "recurrentgemma")
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="recurrentgemma_decode_consistency")
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "recurrentgemma")
    conv = recurrentgemma_conv_ms(cfg, params)
    emit({"phase": "recurrentgemma_profile_conv", "conv_ms": conv,
          "prefill_elementwise_ms": profile["prefill"]["ms"]["elementwise"],
          "decode_4_steps_elementwise_ms":
          profile["decode_4_steps"]["ms"]["elementwise"],
          "note": "the conv timed apart on one block's weights, times the "
                  "RG-LRU blocks: a part of the trace's elementwise ms"})
    scan["launches"] = launches["rglru_scan"]
    scan["launches_per_call"] = {k: sum(v.values())
                                 for k, v in per_call.items()}
    scan["passes_launched"] = {"prefill": row["passes_prefill"],
                               "decode": row["passes_decode"]}
    # the profile's traced prefill and 4 decode steps, beside the calls
    # they made (a trace may drop records: read, not held)
    scan["traced_launches_per_call"] = {
        part: profile[k]["kernels_in_trace"]["rglru_scan"]
        / profile[k]["launched"]["rglru_scan"]
        for part, k in (("prefill", "prefill"), ("decode", "decode_4_steps"))}
    scan["profile_prefill_ms"] = profile["prefill"]["ms"]["rglru_scan"]
    kernels["rglru_scan"] = scan
    kernels["flash_attention"]["recurrentgemma"] = attn
    kernels["flash_attention"]["recurrentgemma_launches"] = launches[
        "flash_attention"]
    kernels["linear"]["recurrentgemma"] = {
        **products, "profile_prefill_linear_ms":
        profile["prefill"]["ms"]["linear"]}
    kernels["linear"]["recurrentgemma_launches"] = launches["linear"]
    del params, prompts, toks
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    # the phase's budget and its decode-graph A/B's
    budget = RECURRENTGEMMA_BUDGET_S + DECODE_AB_BUDGET_S["recurrentgemma"]
    emit({"phase": "recurrentgemma", "seconds": seconds, "budget_s": budget,
          "launches": launches,
          "peak_device_bytes": row["peak_device_bytes"],
          "decode_graph_ab_s": ab["seconds"]})
    check(seconds <= budget,
          f"the recurrentgemma phase took {seconds} s of its {budget}")


# MusicGen-medium, InternVL2-1B and Llama-4: the codebook and prefix LMs
MUSICGEN_MEM = 64          # text-memory tokens, as the JAX package's specs
MUSICGEN_CHECK_BLOCKS = 2
MUSICGEN_BUDGET_S = 40
INTERNVL2_PREFIX, INTERNVL2_PROMPT = 256, 768   # 1024 positions a prompt
INTERNVL2_CHECK_BLOCKS = 2
INTERNVL2_BUDGET_S = 12
LLAMA4_BLOCKS = 4          # of 48: one unit (local dense, local MoE, local
LLAMA4_EXPERTS = 8         # dense, global NoPE MoE); 8 of 128 routed experts
LLAMA4_PREFIX = 256
# the prefix LMs' card-vs-CPU prefill: 8 patches and 192 tokens
CHECK_PREFIX = 8
LLAMA4_BUDGET_S = 48


def cross_attention_phase(fa, ref, peaks, rand, cases):
    """The attention kernel as cross-attention (not causal) at ``cases`` =
    {name: (B, Lq, Lk, H, D)} from ``rand(*shape)``: against its plain
    version (≤ 5e-5), two launches bitwise, device ms beside its bound
    (``flash_attention.work``), the plain version's and SDPA's.  A decode
    step's case has Lq 1: one real row in the kernel's query tile."""
    import torch.nn.functional as F
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    rows = {}
    for name, (b, lq, lk, h, d) in cases.items():
        q, k, v = rand(b, lq, h, d), rand(b, lk, h, d), rand(b, lk, h, d)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

        def call():
            return fa.flash_attention_cuda(q, k, v, causal=False)
        out, again = call(), call()
        want = ref.flash_attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
              f"{name} cross attention vs plain: max abs err {err}")
        check(bool(torch.equal(out, again)),
              f"two launches of the {name} cross attention differ")
        flops, nbytes, unit = fa.work(b, lq, lk, h, h, d)
        bound, by = kernel_bound(peaks, (flops, nbytes, unit))
        row = {"shape": [b, lq, lk, h, d], "causal": False,
               **fa.plan(q, k, v), "max_abs_err": err, "ms": device_ms(call),
               "plain_ms": device_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=False), iters=10),
               "library": "scaled_dot_product_attention",
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "bytes": nbytes, "grid": [b * h, -(-lq // fa.query_tile(d))]}
        row["bound_share"] = bound / row["ms"]
        rows[name] = row
        del q, k, v, qt, kt, vt, out, again, want
    return rows


def _lm_phase_end(tag, kernels, launches, attn, products, profile, row,
                  budget, t_phase, gemm, **extra):
    """Book an LM phase's kernel rows and launches into ``kernels``, free
    its weights' prepared halves, and emit ``<tag>`` with its seconds,
    held to ``budget``."""
    kernels["flash_attention"][tag] = attn
    kernels["flash_attention"][tag + "_launches"] = launches[
        "flash_attention"]
    kernels["linear"][tag] = {
        **products, **({"profile_prefill_linear_ms":
                        profile["prefill"]["ms"]["linear"]}
                       if profile else {})}
    kernels["linear"][tag + "_launches"] = launches["linear"]
    free_lm_weights(gemm)
    seconds = time.perf_counter() - t_phase
    emit({"phase": tag, "seconds": seconds, "budget_s": budget,
          "launches": launches,
          "peak_device_bytes": row["peak_device_bytes"], **extra})
    check(seconds <= budget,
          f"the {tag} phase took {seconds} s of its {budget}")


def musicgen_phase(peaks, kernels, sass):
    """The codebook LM's serving path at MusicGen-medium's published widths
    and all 48 blocks (d 1536, 24 × 64 MHA, cross-attention to a text
    memory 1536 wide, gelu MLP d_ff 6144, layernorm, sinusoidal positions,
    4 codebooks of 2048, each with its embedding table and head), after
    the recurrentgemma phase.  The memory is a 64-token stub; every decode
    step's cross branches run the attention kernel on one query row and
    recompute the memory's k and v, as the JAX package does.  Budget
    ``MUSICGEN_BUDGET_S``; the weights (1.81 B values) are drawn on the
    card."""
    from repro_torch import configs
    from repro_torch.data.synthetic import text_memory
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = configs.get("musicgen-medium")
    x = cfg.stages[0].unit[0].cross
    gen = torch.Generator(device="cuda").manual_seed(SEED + 131)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (LM_BATCH, LM_PROMPT), sass,
        "attn_fwdIfLi64E")
    cross = cross_attention_phase(fa, ref, peaks, rand, {
        "cross_prefill": (LM_BATCH, LM_PROMPT, MUSICGEN_MEM, x.num_heads,
                          x.head_dim),
        "cross_decode": (LM_BATCH, 1, MUSICGEN_MEM, x.num_heads,
                         x.head_dim)})
    attn = {**cases["global"], **cross, "sass": rows}
    emit({"phase": "musicgen_attention", "limit": 5e-5, **attn})
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 130)
    memory = text_memory(torch.Generator().manual_seed(SEED + 132),
                         LM_BATCH, MUSICGEN_MEM, cfg.cond_dim, device="cuda")
    attn_lm_cross_check_phase(cfg, T, params, MUSICGEN_CHECK_BLOCKS,
                              SEED + 133, "musicgen", memory=memory[:1])
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, LM_PROMPT, LM_GEN), SEED + 134,
        "musicgen", memory=memory, weight_bytes=weight_bytes,
        prepared_bytes=prepared)
    ab = decode_graph_ab_phase(cfg, serve, T, params, ops, prompts, LM_GEN,
                               "musicgen", memory=memory)
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="musicgen_decode_consistency",
                                memory=memory)
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "musicgen", memory=memory)
    del params, prompts, toks, memory
    # the phase's budget and its decode-graph A/B's
    _lm_phase_end("musicgen", kernels, launches, attn, {}, profile, row,
                  MUSICGEN_BUDGET_S + DECODE_AB_BUDGET_S["musicgen"],
                  t_phase, gemm, decode_graph_ab_s=ab["seconds"])


def internvl2_phase(peaks, kernels, sass):
    """The prefix LM's serving path at InternVL2-1B's published widths and
    all 24 blocks (d 896, 14 × 64 heads over 2 KV heads, QKV bias, RoPE θ
    1e6, gated SiLU MLP d_ff 4864, tied embeddings of 151655), through
    ``launch.programs``: 256 patch embeddings (the ViT's stub) before 768
    tokens a prompt.  A light phase: the attention kernel at the prefill's
    GQA shape (7 query heads a KV head), a 2-block card-vs-CPU prefill,
    the generate and decode vs forward; no product sweep, no trace.
    Budget ``INTERNVL2_BUDGET_S``."""
    from repro_torch import configs
    from repro_torch.data.synthetic import vit_patch_embeds
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = configs.get("internvl2-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 141)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand,
        (LM_BATCH, INTERNVL2_PREFIX + INTERNVL2_PROMPT), sass,
        "attn_fwdIfLi64E")
    attn = {**cases["global"], "sass": rows}
    emit({"phase": "internvl2_attention", "limit": 5e-5, **attn})
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 140)
    prefix = vit_patch_embeds(torch.Generator().manual_seed(SEED + 142),
                              LM_BATCH, INTERNVL2_PREFIX, cfg.d_model,
                              device="cuda")
    attn_lm_cross_check_phase(cfg, T, params, INTERNVL2_CHECK_BLOCKS,
                              SEED + 143, "internvl2",
                              prefix=prefix[:1, :CHECK_PREFIX])
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, INTERNVL2_PROMPT, LM_GEN),
        SEED + 144, "internvl2", prefix=prefix, weight_bytes=weight_bytes,
        prepared_bytes=prepared)
    lm_decode_consistency_phase(cfg, T, params, prompts, toks,
                                name="internvl2_decode_consistency",
                                prefix=prefix)
    del params, prompts, toks, prefix
    _lm_phase_end("internvl2", kernels, launches, attn, {}, None, row,
                  INTERNVL2_BUDGET_S, t_phase, gemm)


def llama4_phase(peaks, kernels, sass):
    """The MoE prefix LM's serving path at Llama-4 Maverick's published
    widths (d 5120, 40 × 128 heads over 8 KV heads; a unit of 3 local
    blocks with RoPE θ 5e5 and a window of 8192 and one global block
    without positions (NoPE); dense MLPs d_ff 16384 on alternate blocks,
    MoE FFNs on the others: a sigmoid router at top-1 without
    renormalization, experts and one shared expert of d_ff 8192; an
    untied head of 202048), through ``launch.programs``: 256 patch
    embeddings before 1024 tokens a prompt.  Cut for the card's memory
    (one MoE block's 128 experts are 64.4 GB of f32): one unit of its 12,
    8 of the 128 routed experts — 20.4 GB of weights, 24.2 GB of
    prepared halves.  The prefill dispatches ``dense``, the decode
    ``gshard`` (capacity 8).  Budget ``LLAMA4_BUDGET_S``; the weights
    (5.09 B values) are drawn on the card."""
    from repro_torch import configs
    from repro_torch.data.synthetic import vit_patch_embeds
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer as T
    t_phase = time.perf_counter()
    cfg = moe_cut(configs.get("llama4-maverick-400b-a17b"), LLAMA4_BLOCKS,
                  LLAMA4_EXPERTS)
    length = LLAMA4_PREFIX + LM_PROMPT
    gen = torch.Generator(device="cuda").manual_seed(SEED + 151)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases, rows = attn_lm_attention_phase(
        fa, ref, peaks, cfg, rand, (LM_BATCH, length), sass,
        "attn_fwdIfLi128")
    attn = {"cases": cases, "sass": rows}
    emit({"phase": "llama4_attention", "limit": 5e-5, **attn})
    params, weight_bytes, prepared = lm_params_phase(cfg, serve, T,
                                                     SEED + 150)
    experts = moe_experts_phase(gemm, ref, moe, peaks, cfg, params,
                                "llama4", LM_BATCH * length, length,
                                SEED + 154)
    prefix = vit_patch_embeds(torch.Generator().manual_seed(SEED + 152),
                              LM_BATCH, LLAMA4_PREFIX, cfg.d_model,
                              device="cuda")
    attn_lm_cross_check_phase(cfg, T, params, LLAMA4_BLOCKS, SEED + 153,
                              "llama4",
                              prefix=prefix[:1, :CHECK_PREFIX],
                              moe=moe)
    prompts, toks, launches, row = attn_lm_generate_phase(
        cfg, serve, params, ops, (LM_BATCH, LM_PROMPT, LM_GEN), SEED + 155,
        "llama4", prefix=prefix, weight_bytes=weight_bytes,
        prepared_bytes=prepared, routed_experts=LLAMA4_EXPERTS)
    moe_decode_consistency_phase(cfg, T, moe, params, prompts, toks,
                                 "llama4", prefix=prefix)
    profile = attn_lm_profile_phase(cfg, T, params, prompts, toks, ops,
                                    "llama4",
                                    prefill_kw={"moe_strategy": "dense"},
                                    prefix=prefix)
    del params, prompts, toks, prefix
    _lm_phase_end("llama4", kernels, launches, attn,
                  {"experts": experts["cases"],
                   "moe_ffn_ms": experts["moe_ffn_ms"]}, profile, row,
                  LLAMA4_BUDGET_S, t_phase, gemm)


SERVE_ADAPTIVE = "adaptive:base=smoothcache(alpha=0.18),tau=0.3"
SERVE_ENTRIES = ("no_cache", "smoothcache:alpha=0.18", "static:n=2",
                 SERVE_ADAPTIVE)
# the fault, telemetry and durability phases' depth, of DiT-XL/2's 28
# blocks: what they check does not depend on it, and it cuts the cost of
# their model calls to a quarter (the serve, fused, continuous and SLO
# phases, whose joins and controller moves depend on the service time,
# keep all 28)
SERVE_CUT_BLOCKS = 7


def dit_cut(cfg, params, blocks):
    """``cfg`` cut to its first ``blocks`` blocks, and ``params``' views of
    those blocks: no copy, and each block's weights keep the prepared
    halves made for them."""
    from repro_torch.kernels.products import lm_cut
    from repro_torch.models.transformer import tree_map
    bb = params["backbone"]
    stages = [tuple(tree_map(lambda a: a[:blocks], u)
                    for u in bb["stages"][0])]
    return lm_cut(cfg, blocks), {**params,
                                 "backbone": {**bb, "stages": stages}}


def computed_attn_steps(record, entry):
    """Steps of one served batch that computed attention; each is one
    model call at B = 2 × bucket, 28 kernel launches (replayed from a
    captured graph on the fused path)."""
    if record.decisions is not None:
        return sum("attn" not in d for d in record.decisions)
    return int((~entry.schedule.skip["attn"]).sum())


def attn_branches(graph_stats):
    """Branches of a fused graph whose model call computes attention
    (their IF bodies hold the captured attention launches)."""
    types, n = graph_stats["types"], graph_stats["branches"]
    if "attn" not in types:                  # the pool never skips it
        return n
    bit = types.index("attn")
    return sum(1 for code in range(n) if not code >> bit & 1)


def serve_store(cfg, params, smooth_art):
    """The four-entry store (the adaptive artifact calibrated here on 10
    samples and loaded back from JSON) and one pipeline per entry to
    replay served batches."""
    from repro_torch import serve
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    labels = torch.tensor([(97 * i) % cfg.num_classes for i in range(10)],
                          device="cuda")
    calib = DiffusionPipeline(cfg, solvers.ddim(50), SERVE_ADAPTIVE,
                              cfg_scale=1.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calib.calibrate(params, torch.Generator().manual_seed(SEED + 7), 10,
                    cond_args={"label": labels})
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    store = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
    replay = {name: DiffusionPipeline(cfg, solvers.ddim(50), name,
                                      cfg_scale=1.5)
              for name in SERVE_ENTRIES}
    with tempfile.TemporaryDirectory() as tmp:
        for name, art in (("smoothcache:alpha=0.18", smooth_art),
                          (SERVE_ADAPTIVE, calib.artifact)):
            path = art.save(str(Path(tmp) / f"{len(store)}.cache.json"))
            store.add_artifact(name, path)
            replay[name].load_artifact(path, strict=True)
    store.add_policy("no_cache", "none")
    store.add_policy("static:n=2", "static:n=2")
    emit({"phase": "serve_store", "adaptive_calibrate_s": calib_s,
          "entries": {n: {"adaptive": store.get(n).adaptive,
                          "static_compute_fraction":
                              store.get(n).compute_fraction(),
                          "pool": store.get(n).pool_size()}
                      for n in SERVE_ENTRIES}})
    return store, replay


def serve_drain(cfg, params, store, ops, executor):
    """16 requests, 4 per entry, seeds and labels from ``SEED``, all
    arriving at once on a wall clock; ``max_batch`` 4, 2 in flight,
    ``interleave``.  Attention launches and decision syncs are attributed
    to the entry whose run advanced (two entries' runs interleave)."""
    import numpy as np
    from repro_torch import serve
    rng = np.random.RandomState(SEED)
    reqs = [serve.Request(rid=i, seed=int(rng.randint(1 << 31)),
                          label=int(rng.randint(cfg.num_classes)),
                          policy=SERVE_ENTRIES[i % 4]) for i in range(16)]
    per = {n: {"launches": 0, "captured": 0, "replayed": 0, "host_syncs": 0}
           for n in SERVE_ENTRIES}

    class CountingEngine(serve.ServeEngine):
        # reads the executor through self: a class made per call sits in a
        # reference cycle, and must not keep the executor (its graphs hold
        # the weights) alive until the collector runs
        def _advance(self, fl):
            before = (ops.LAUNCHES["flash_attention"],
                      ops.CAPTURED["flash_attention"],
                      ops.REPLAYED["flash_attention"],
                      self.executor.host_sync_count)
            super()._advance(fl)
            row = per[fl.mb.group]
            row["launches"] += ops.LAUNCHES["flash_attention"] - before[0]
            row["captured"] += ops.CAPTURED["flash_attention"] - before[1]
            row["replayed"] += ops.REPLAYED["flash_attention"] - before[2]
            row["host_syncs"] += self.executor.host_sync_count - before[3]

    eng = CountingEngine(executor, params, store, max_batch=4,
                         max_inflight=2, scheduler="interleave")
    eng.submit(*reqs)
    eng.run_until_drained()
    return eng, reqs, per


def serve_phase(cfg, params, ops, smooth_art):
    """The serving stack at full width (see the module docstring, phase
    10).  Returns the attention launches of the traced drain (counted
    from the wrappers and the graphs' captures), the attention wrapper
    calls of the untraced drain
    (the step graphs' warm-ups and captures) and the store."""
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import schedule as schedule_lib, solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    per_step = attn_calls(cfg, ("attn",))       # launches per attention step
    store, replay = serve_store(cfg, params, smooth_art)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    _reset_counts(ops)
    eng, reqs, per = serve_drain(cfg, params, store, ops, executor)
    launches, calls = _launched(ops), dict(ops.LAUNCHES)
    drain_syncs = executor.host_sync_count
    graphs = executor.fused_graphs()
    seg_graphs = executor.segment_graphs()
    static = [n for n in SERVE_ENTRIES if not store.get(n).adaptive]
    seg_attn = per_step * sum("attn" not in g["skip"] for g in seg_graphs)
    check(sum(per[n]["launches"] for n in static) == seg_attn
          and sum(per[n]["captured"] for n in static) == seg_attn,
          f"static entries: {[per[n] for n in static]} warm-up and captured"
          f" attention calls, expected {seg_attn} each")
    check(launches["ssd"] == 0, "SSD launched in the serve drain")
    check(sorted(eng.results) == list(range(16)),
          f"served {sorted(eng.results)} of 16 requests")
    check(all(bool(np.isfinite(x).all()) for x in eng.results.values()),
          "non-finite served latents")
    rep = eng.report()
    for name in SERVE_ENTRIES:
        entry = store.get(name)
        recs = [r for r in eng.records if r.group == name]
        mine = [r for r in reqs if r.policy == name]
        steps = sum(computed_attn_steps(r, entry) for r in recs)
        wall = (max(r.finished for r in mine)
                - min(r.started for r in mine))
        waits = [r.queue_wait for r in mine]
        service = [r.service_time for r in mine]
        row = {"phase": "serve_entry", "entry": name, "batches": len(recs),
               "buckets": [r.bucket for r in recs], "requests": len(mine),
               "wall_s": wall, "images_per_s": len(mine) / wall,
               "queue_wait_s": {"p50": percentile(waits, 50),
                                "p95": percentile(waits, 95)},
               "service_s": {"p50": percentile(service, 50),
                             "p95": percentile(service, 95)},
               "compute_fraction": float(np.mean(
                   [r.compute_fraction for r in recs])),
               "steps": sum(r.num_steps for r in recs),
               "attn_steps": steps, **per[name]}
        if entry.adaptive:
            # fused entries: the graph replays launch without a Python
            # call, so the replayed launches come from the decision trace;
            # the calls counted are each new graph's eager warm-up of every
            # branch and its capture, one per attention-computing branch
            mine_graphs = [g for g in graphs if g["runtime"]]
            expect = per_step * sum(attn_branches(g) for g in mine_graphs)
            row.update(replayed_launches=per_step * steps,
                       graphs=len(mine_graphs),
                       capture_s=[g["capture_s"] for g in mine_graphs])
            emit(row)
            check(row["launches"] == expect and row["captured"] == expect,
                  f"{name}: {row['launches']} warm-up and {row['captured']}"
                  f" captured attention calls, expected {expect} each")
            check(row["host_syncs"] == 0,
                  f"{name}: {row['host_syncs']} decision syncs on the "
                  "fused path")
        else:
            # static entries ride the segment graphs: their launches are
            # the graphs' replays (captured calls x replays); the calls
            # counted are the new graphs' warm-ups and captures, checked
            # for the drain as a whole below (entries share graphs)
            emit(row)
            check(row["replayed"] == per_step * steps,
                  f"{name}: {row['replayed']} attention launches, expected "
                  f"{per_step} x {steps}")
        if entry.adaptive:
            age = {t: 0 for t in cfg.layer_types()}
            for rec in recs:
                for step in rec.decisions:
                    for t in age:
                        age[t] = age[t] + 1 if t in step else 0
                        check(age[t] <= entry.k_max,
                              f"{name}: cache age {age[t]} > k_max")
        else:
            check(row["host_syncs"] == 0, f"{name}: host syncs")

    # one served batch per entry, replayed through generate: bitwise
    replays = {}
    for name in SERVE_ENTRIES:
        rec = next(r for r in eng.records if r.group == name)
        label = torch.tensor(rec.labels, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = replay[name].generate(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            label=label, **({"return_decisions": True}
                            if store.get(name).adaptive else {}))
        x, dec = out if isinstance(out, tuple) else (out, None)
        x = x.cpu()
        wall = time.perf_counter() - t0
        served = torch.from_numpy(np.stack([eng.results[i]
                                            for i in rec.rids]))
        same = bool(torch.equal(x, served)) and dec == rec.decisions
        replays[name] = {"bucket": rec.bucket, "wall_s": wall,
                         "ms_per_step": 1e3 * wall / rec.num_steps,
                         "bitwise_equal": same}
        check(same, f"{name}: served batch differs from its generate replay")
    # the host loop's decision sync, which the served (fused) batch no
    # longer pays: the batch on the host loop with its per-step reads (A)
    # against the same batch at τ = 0 on its own realized decisions (B:
    # the same model calls, no reads), in the order A B B A
    rec = next(r for r in eng.records if r.group == SERVE_ADAPTIVE)
    entry = store.get(SERVE_ADAPTIVE)
    realized = schedule_lib.Schedule(
        {t: np.array([t in d for d in rec.decisions])
         for t in entry.schedule.skip}, rec.num_steps)
    served = torch.from_numpy(np.stack([eng.results[i] for i in rec.rids]))
    label = torch.tensor(rec.labels, device="cuda")

    def run(tau, schedule):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = executor.sample_adaptive(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            schedule=schedule, tau=tau, proxy_map=entry.proxy_map,
            pool=entry.pool(), k_max=entry.k_max, label=label).cpu()
        check(bool(torch.equal(x, served)),
              f"the adaptive batch at tau={tau} differs from the served one")
        return time.perf_counter() - t0

    synced = [run(entry.tau, entry.schedule)]
    syncs = executor.host_sync_count
    unsynced = [run(0.0, realized), run(0.0, realized)]
    check(executor.host_sync_count == syncs, "decision syncs at tau=0")
    synced.append(run(entry.tau, entry.schedule))
    emit({"phase": "serve_replay", "replays": replays,
          "adaptive_sync_cost": {
              "steps": rec.num_steps, "synced_s": synced,
              "unsynced_s": unsynced,
              "ms_per_step": 1e3 * (sum(synced) - sum(unsynced)) / 2
              / (rec.num_steps - 1)}})

    # a second drain under the profiler (device activity only), on the
    # same executor so that no graph capture falls in the window: the
    # device's idle share.  The drain's attention launches come from what
    # drops no record: the wrappers' calls, the segment graphs' replays
    # (captured calls x replays) and the fused graphs' (each step runs the
    # branch of its record's decision, whose captured calls its graph
    # recorded).  The trace's count is a second reading: a trace drops
    # kernel records (62 and 18 of 4900 in two runs), never adds one, so
    # the drain is traced again (up to ``TRACE_TRIES`` times) until it
    # holds them all, and its times are null if none does
    n_graphs = executor.graph_count()
    fused_by_batch = {g["batch"]: g for g in executor.fused_graphs()}
    check(len(fused_by_batch) == len(executor.fused_graphs()),
          "two fused graphs of one batch in the serve drain")

    def fused_replayed(rec):
        g = fused_by_batch[rec.bucket]
        return sum(g["captured_by_branch"][sum(
            1 << i for i, t in enumerate(g["types"]) if t in d)]
            ["flash_attention"] for d in rec.decisions)

    for tries in range(1, TRACE_TRIES + 1):
        traced = {}
        before = (ops.LAUNCHES["flash_attention"],
                  ops.REPLAYED["flash_attention"])
        wall_us, prof = _profiled(lambda: traced.update(
            eng=serve_drain(cfg, params, store, ops, executor)[0]))
        busy, attn_us, attn_kernels = _device_us(prof, "attn_fwd")
        records = traced["eng"].records
        traced_steps = sum(computed_attn_steps(r, store.get(r.group))
                           for r in records)
        issued = (ops.LAUNCHES["flash_attention"] - before[0]
                  + ops.REPLAYED["flash_attention"] - before[1]
                  + sum(fused_replayed(r) for r in records
                        if store.get(r.group).adaptive))
        check(attn_kernels <= issued,
              f"the trace holds {attn_kernels} attention kernels, more "
              f"than the {issued} the drain launched")
        complete = attn_kernels == issued
        if complete:
            break
    check(executor.graph_count() == n_graphs,
          "a graph was captured in the traced drain")
    row = {"phase": "serve", "requests": rep["requests"],
           "batches": rep["batches"], "buckets": rep["buckets"],
           "drain_s": rep["makespan_s"],
           "images_per_s": rep["throughput_rps"],
           "queue_wait_s": rep["queue_wait_s"], "service_s": rep["service_s"],
           "compute_fraction": rep["compute_fraction"],
           "model_variants": rep["compiles"]["model_variants"],
           "variants": rep["compiles"],
           "graphs": rep["compiles"]["graphs"],
           "program_budget": rep["program_budget"],
           "host_sync_count": drain_syncs,
           "launches": launches,
           "traced_drain": {"wall_ms": wall_us / 1e3,
                            "trace_complete": complete, "traces": tries,
                            "device_ms": busy / 1e3 if complete else None,
                            "idle_share": 1 - busy / wall_us if complete
                            else None,
                            "attn_ms": attn_us / 1e3 if complete else None,
                            "attn_steps": traced_steps,
                            "attn_launches": issued,
                            "attn_kernels_in_trace": attn_kernels},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(rep["compiles"]["model_variants"] <= rep["program_budget"],
          f"{rep['compiles']['model_variants']} model variants over the "
          f"budget {rep['program_budget']}")
    check(rep["compiles"]["graphs"]["total"] <= rep["program_budget"]
          and rep["compiles"]["graphs"]["seg"]
          == executor.compiled_variant_count("seg"),
          f"graphs {rep['compiles']['graphs']}, budget "
          f"{rep['program_budget']}")
    check(busy > 0, "the profiler saw no device time in the serve drain")
    check(issued == per_step * traced_steps,
          f"{issued} attention kernels launched in the traced drain "
          f"({attn_kernels} in its trace), expected {per_step} x "
          f"{traced_steps} attention steps")
    return issued, calls["flash_attention"], store


def _reset_counts(ops):
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
        ops.CAPTURED[k] = 0
        ops.REPLAYED[k] = 0


def _launched(ops):
    """Every kernel launch counted so far: the wrappers' calls and the
    segment graphs' replays."""
    return {k: ops.LAUNCHES[k] + ops.REPLAYED[k] for k in ops.LAUNCHES}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fused_phase(cfg, params, ops, store):
    """The fused adaptive path at full width (phase 11; budget ~20 s): the
    serve phase's adaptive artifact, 4 requests (bucket 4, B = 8 in the
    kernel).  Capture seconds and graph count; peak memory before and
    after the capture; fused ≡ host loop (decisions and latents) with the
    replays under ``set_sync_debug_mode("error")`` and no decision sync;
    τ = 0 fused ≡ ``sample_compiled``; chunks of 4 ≡ one call; the walls
    of the fused batch and the host loop in the order A B B A; the idle
    share of one traced fused batch; the replayed attention launches from
    the trace against the captured ones."""
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    t_phase = time.perf_counter()
    per_step = attn_calls(cfg, ("attn",))       # launches per attention step
    entry = store.get(SERVE_ADAPTIVE)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    kw = dict(schedule=entry.schedule, proxy_map=entry.proxy_map,
              pool=entry.pool(), k_max=entry.k_max, label=labels)
    n = len(REQUEST_LABELS)

    def gen():
        return torch.Generator().manual_seed(SEED + 8)

    # the capture, outside the guard: memory and seconds
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rs = executor.start_adaptive_fused_run(params, gen(), n, tau=entry.tau,
                                           **kw)
    _reset_counts(ops)
    (step, capture_wall) = _timed(lambda: executor.fused_step_for(params, rs))
    captured = ops.CAPTURED["flash_attention"]
    warm = ops.LAUNCHES["flash_attention"]
    mem1 = torch.cuda.memory_allocated()
    peak1 = torch.cuda.max_memory_allocated()
    expect = per_step * attn_branches(step.stats)
    check(captured == expect and warm == expect,
          f"{warm} warm-up and {captured} captured attention calls, "
          f"expected {per_step} x {attn_branches(step.stats)} "
          "branches each")
    # one model call per branch, its products through the linear kernel
    expect_linear = sum(
        linear_calls(cfg, [t for t in cfg.layer_types()
                           if not sig.skip.get(t, False)])
        for sig in step.table.branches)
    linear_calls_seen = (ops.LAUNCHES["linear"], ops.CAPTURED["linear"])
    check(linear_calls_seen == (expect_linear, expect_linear),
          f"{linear_calls_seen} warm-up and captured linear calls, "
          f"expected {expect_linear} each")

    # the run state's copy into the graph's buffers and out of them, at
    # bucket 4 (median of 5, CUDA events)
    def event_ms(fn):
        ms = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return sorted(ms)[2]

    state_bytes = sum(v.numel() * v.element_size() for v in
                      [rs.x, rs.x_prev, rs.acc, rs.lag, rs.trace,
                       rs.healthy] + [c for stage in rs.cache for d in stage
                                      for c in d.values()])
    copy = {"state_bytes": state_bytes,
            "copy_in_ms": event_ms(lambda: step._load(rs)),
            "copy_out_ms": event_ms(step._unload)}

    # fused (B) under the sync guard against the host loop (A)
    syncs = executor.host_sync_count

    def fused_run(rs=None):
        """One fused batch (start unless given, then every step), its
        replays under the sync guard: (run state, wall s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rs is None:
            rs = executor.start_adaptive_fused_run(params, gen(), n,
                                                   tau=entry.tau, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            rs = executor.advance_adaptive_fused(params, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return rs, time.perf_counter() - t0

    (xh, dh), a1 = _timed(lambda: executor.sample_adaptive(
        params, gen(), n, tau=entry.tau, return_decisions=True, **kw))
    host_syncs = executor.host_sync_count - syncs
    syncs = executor.host_sync_count
    rs, _ = fused_run(rs)            # the captured run (started above)
    _, b1 = fused_run()
    fused_syncs = executor.host_sync_count - syncs
    xf, df = rs.x, rs.decisions
    max_abs = float((xf - xh).abs().max())
    row = {"phase": "fused", "requests": n, "steps": rs.num_steps,
           # whether this PyTorch has its own conditional-node API (the
           # port builds IF nodes with core/cuda_graphs.cu either way)
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "torch_if_nodes": hasattr(torch.cuda.CUDAGraph,
                                     "begin_capture_to_if_node"),
           "graphs": len(executor.fused_graphs()),
           "capture": step.stats, "capture_wall_s": capture_wall,
           "linear_captured": ops.CAPTURED["linear"],
           "state_copy": copy,
           "device_bytes": {"before": mem0, "after_capture": mem1,
                            "peak_with_capture": peak1},
           "sync_guard": "error", "host_sync_count": fused_syncs,
           "host_loop_syncs": host_syncs,
           "decisions_equal": df == dh,
           "bitwise_vs_host_loop": bool(torch.equal(xf, xh)),
           "max_abs_vs_host_loop": max_abs}
    check(fused_syncs == 0, f"{fused_syncs} host syncs on the fused path")
    check(df == dh, "fused decisions differ from the host loop's")
    check(row["bitwise_vs_host_loop"],
          f"fused latents differ from the host loop's: max abs {max_abs}")

    # the rule compares a (1,) tensor τ as it compares a float τ (both
    # round to f32; a float divisor, by contrast, becomes a reciprocal
    # multiply on CUDA): values one ulp around τ, every k_max edge
    from repro_torch.core import calibration
    g = torch.Generator().manual_seed(SEED + 13)
    tau32 = torch.tensor(entry.tau, dtype=torch.float32)
    near = torch.stack([torch.nextafter(tau32, torch.tensor(-1.0)), tau32,
                        torch.nextafter(tau32, torch.tensor(2.0))])
    acc = torch.cat([near, torch.rand(509, generator=g) * 2 * entry.tau])
    acc = acc.reshape(128, 4).cuda()
    lag = torch.randint(0, entry.k_max + 2, (128, 4), generator=g,
                        dtype=torch.int32).cuda()
    zeros = (torch.zeros(128, device="cuda"), torch.zeros(4, device="cuda"),
             torch.zeros(4, device="cuda"))
    want = calibration.batch_rule(zeros[0], acc, lag, zeros[1], zeros[2],
                                  entry.tau, entry.k_max)
    got = calibration.batch_rule(
        zeros[0], acc, lag, zeros[1], zeros[2],
        *calibration.rule_limits(entry.tau, entry.k_max, "cuda"))
    row["tau_buffer_vs_float_bitwise"] = all(
        bool(torch.equal(a, b)) for a, b in zip(want, got))
    check(row["tau_buffer_vs_float_bitwise"],
          "the rule decides otherwise with a tensor tau than a float tau")

    # τ = 0 on the base schedule against the segmented path
    x0 = executor.sample_adaptive_fused(params, gen(), n, tau=0.0, **kw)
    xc = executor.sample_compiled(params, gen(), n, schedule=entry.schedule,
                                  label=labels)
    row["tau0_bitwise_vs_compiled"] = bool(torch.equal(x0, xc))
    check(row["tau0_bitwise_vs_compiled"],
          "fused tau=0 differs from sample_compiled")
    # chunks of 4 against one call
    rc = executor.start_adaptive_fused_run(params, gen(), n, tau=entry.tau,
                                           **kw)
    while not rc.done:
        rc = executor.advance_adaptive_fused(params, rc, n_steps=4)
    row["chunked_bitwise"] = bool(torch.equal(rc.x, xf))
    check(row["chunked_bitwise"], "chunks of 4 differ from one call")
    # a graph first built at the last step (a split at step num_steps − 1
    # into buckets of 2, which have no graph yet): its warm-up runs every
    # branch, one step each, and must stay inside the step tables; the
    # second half replays the graph the first half built
    n_graphs = len(executor.fused_graphs())
    late = executor.start_adaptive_fused_run(params, gen(), n,
                                             tau=entry.tau, **kw)
    late = executor.advance_adaptive_fused(params, late,
                                           n_steps=late.num_steps - 1)
    halves = [executor.advance_adaptive_fused(params, h)
              for h in executor.split_run(late, [[0, 1], [2, 3]])]
    again = executor.advance_adaptive_fused(
        params, executor.split_run(late, [[0, 1]])[0])
    merged = executor.merge_runs(halves)
    torch.cuda.synchronize()
    row["late_capture"] = {
        "split_at": late.step,
        "new_graphs": len(executor.fused_graphs()) - n_graphs,
        "finite": bool(torch.isfinite(merged.x).all()),
        "repeat_bitwise": bool(torch.equal(again.x, halves[0].x)),
        "max_abs_vs_unsplit": float((merged.x - xf).abs().max())}
    check(all(h.done for h in halves) and row["late_capture"]["finite"]
          and row["late_capture"]["repeat_bitwise"]
          and row["late_capture"]["new_graphs"] == 1,
          f"a graph built at step {late.step}: {row['late_capture']}")

    # walls, A B B A (A: host loop, B: fused), and one traced fused batch
    rs2, b2 = fused_run()
    check(torch.equal(rs2.x, xf), "two fused batches differ")
    _, a2 = _timed(lambda: executor.sample_adaptive(
        params, gen(), n, tau=entry.tau, **kw))
    # the attention kernels the traced batch's replays launched, from what
    # cannot drop a record: each step replays the graph, whose IF bodies
    # hold the attention calls captured in each branch, and runs the
    # branch of that step's decision (read from the device after the
    # run).  The trace's own count is a second reading: a torch.profiler
    # trace has dropped kernel records (1 of 9 runs, 1 of 12), so the
    # batch is traced again (up to ``TRACE_TRIES`` times) until it holds
    # them all, and the trace's times are null if none does.
    by_branch = step.stats["captured_by_branch"]
    for tries in range(1, TRACE_TRIES + 1):
        traced = {}
        wall_us, prof = _profiled(lambda: traced.update(
            d=executor.sample_adaptive_fused(
                params, gen(), n, tau=entry.tau, return_decisions=True,
                **kw)[1]))
        busy, attn_us, attn_kernels = _device_us(prof, "attn_fwd")
        replayed = sum(by_branch[step.table.code_of(d)]["flash_attention"]
                       for d in traced["d"])
        complete = attn_kernels == replayed
        if complete:
            break
    attn_steps = sum("attn" not in d for d in traced["d"])
    row.update({
        "walls_ABBA_s": {"host_loop": [a1, a2], "fused": [b1, b2]},
        "order": "A B B A",
        "traced_fused": {"wall_ms": wall_us / 1e3,
                         "trace_complete": complete, "traces": tries,
                         "device_ms": busy / 1e3 if complete else None,
                         "idle_share": 1 - busy / wall_us if complete
                         else None,
                         "attn_ms": attn_us / 1e3 if complete else None,
                         "attn_kernels_in_trace": attn_kernels},
        "attn_steps": attn_steps,
        "replayed_launches": replayed,
        "captured_by_branch": [b["flash_attention"] for b in by_branch],
        "trace_dropped_attn_kernels": replayed - attn_kernels,
        "captured_launches_per_graph": captured,
        "phase_s": time.perf_counter() - t_phase})
    emit(row)
    check(replayed == per_step * attn_steps,
          f"{replayed} attention kernels replayed in the traced fused "
          f"batch, expected {per_step} x {attn_steps} attention steps")
    check(attn_kernels <= replayed,
          f"the trace holds {attn_kernels} attention kernels, more than the "
          f"{replayed} replayed")
    return row


def gemm_row_stability(cfg, ops):
    """Whether the DiT's f32 products keep a row's bits across batch
    shapes: the first M rows of an (M_max, K) @ (K, N) product against the
    (M, K) @ (K, N) product of those rows alone, for M = 2·256·bucket
    (CFG-doubled rows of 1 and 2 requests) against 4 requests — through
    ``ops.linear`` (the linear kernel; must read 0) and, for the record,
    cuBLAS.  The same for the served path's row reductions: the adaptive
    proxy (``calibration.rel_l1_change_rows``, must read 0; beside it the
    plain ``sum`` it replaced) over B = 1, 2, 4 of 8 latents, and
    layernorm and gelu over 2, 4 of 8 requests' tokens (must read 0).
    Seeded N(0, 1) inputs; max abs difference per shape and M."""
    from repro_torch.core import calibration
    from repro_torch.kernels import gemm
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(SEED + 10)
    tok, d = 256, cfg.d_model
    shapes = [(d, d), (d, 3 * d), (d, 4 * d), (4 * d, d), (d, 6 * d)]
    out = {"linear": {}, "cublas": {}}
    for k, n in shapes:
        a = torch.randn(2 * 4 * tok, k, generator=gen).cuda()
        b = torch.randn(k, n, generator=gen).cuda()
        for name, fn in (("linear", ops.linear), ("cublas", torch.mm)):
            full = fn(a, b)
            out[name][f"{k}x{n}"] = {
                str(m): float((fn(a[:m], b) - full[:m]).abs().max())
                for m in (2 * tok, 2 * 2 * tok)}
    # the request-row products over the rows of 1 and 2 of 4 requests
    for k, n in ((256, d), (d, d), (d, 6 * d), (d, 2 * d)):
        a = torch.randn(2 * 4, k, generator=gen).cuda()
        b = torch.randn(k, n, generator=gen).cuda()
        full = ops.linear(a, b, rows="requests")
        out["linear"][f"{k}x{n}:requests"] = {
            str(m): float((ops.linear(a[:m], b, rows="requests")
                           - full[:m]).abs().max()) for m in (2, 4)}
    gemm.release()

    def rows(fn, x, ms):
        full = fn(x)
        return {str(m): float((fn(x[:m]) - full[:m]).abs().max())
                for m in ms}

    lat = [torch.randn((8,) + cfg.latent_shape, generator=gen).cuda()
           for _ in range(2)]
    dims = tuple(range(1, lat[0].dim()))
    out["proxy"] = rows(lambda x: calibration.rel_l1_change_rows(
        x, lat[1][:len(x)]), lat[0], (1, 2, 4))
    out["proxy_plain_sum"] = rows(lambda x: (
        (x - lat[1][:len(x)]).abs().sum(dim=dims)
        / (lat[1][:len(x)].abs().sum(dim=dims) + 1e-12)), lat[0], (1, 2, 4))
    h = torch.randn(2 * 8, tok, d, generator=gen).cuda()
    norm = {"scale": torch.randn(d, generator=gen).cuda(),
            "bias": torch.randn(d, generator=gen).cuda()}
    out["layernorm"] = rows(lambda x: layers.layernorm(norm, x), h, (4, 8))
    out["gelu"] = rows(layers.gelu_tanh, h, (4, 8))
    return out


def continuous_phase(cfg, params, ops, store):
    """Continuous batching at full width (phase 12; budget ~25 s): the
    SmoothCache artifact, ``static:n=2`` and the adaptive artifact,
    ``max_batch`` 4, 2 in flight, ``interleave``, ``adaptive_chunk`` 4, a
    wall clock; 2 requests per entry at t = 0 and 2 more per entry at
    t ≈ 0.3 s, inside the 0.5 join horizon.  Once with ``continuous=True``
    and once without; joins ≥ 1 and merges ≥ 1, variants within the
    budget; every served request against its own solo ``generate``
    (B = 1) from its seed: the max abs difference per row; and whether
    the DiT's f32 products keep a row's bits across batch shapes."""
    import numpy as np
    from repro_torch import serve
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    entries = ("smoothcache:alpha=0.18", "static:n=2", SERVE_ADAPTIVE)
    rng = np.random.RandomState(SEED + 9)
    trace = [(i, entries[i % 3], 0.0 if i < 6 else 0.3,
              int(rng.randint(1 << 31)), int(rng.randint(cfg.num_classes)))
             for i in range(12)]

    def drain(continuous):
        executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
        eng = serve.ServeEngine(executor, params, store, max_batch=4,
                                max_inflight=2, scheduler="interleave",
                                adaptive_chunk=4, continuous=continuous)
        t0 = eng.clock.now()
        reqs = [serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                              arrival=t0 + at)
                for i, pol, at, seed, lab in trace]
        eng.submit(*reqs)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        rep = eng.report()
        waits = [r.queue_wait for r in reqs]
        service = [r.service_time for r in reqs]
        out = {"continuous": continuous, "drain_s": time.perf_counter() - w0,
               "images_per_s": rep["throughput_rps"],
               "queue_wait_s": {"p50": percentile(waits, 50),
                                "p95": percentile(waits, 95)},
               "service_s": {"p50": percentile(service, 50),
                             "p95": percentile(service, 95)},
               **{k: rep["continuous"][k] for k in
                  ("joins", "joined_requests", "merges", "join_merges",
                   "regroups", "coalesces")},
               "lineage": [list(r.lineage) for r in eng.records
                           if r.lineage],
               "buckets": rep["buckets"],
               "model_variants": rep["compiles"]["model_variants"],
               "variants": rep["compiles"],
               "program_budget": rep["program_budget"],
               "host_sync_count": executor.host_sync_count,
               "graphs": len(executor.fused_graphs())}
        check(sorted(eng.results) == list(range(12)),
              f"served {sorted(eng.results)} of 12 requests")
        check(out["model_variants"] <= out["program_budget"],
              f"{out['model_variants']} model variants over the budget "
              f"{out['program_budget']}")
        check(executor.host_sync_count == 0, "decision syncs in the drain")
        return eng, out

    eng, on = drain(True)
    check(on["joins"] >= 1 and on["merges"] >= 1,
          f"continuous drain: {on['joins']} joins, {on['merges']} merges")
    _, off = drain(False)
    # each request's solo replay: generate(batch_generator([seed]), 1)
    solo = {name: DiffusionPipeline(cfg, solvers.ddim(50), name,
                                    cfg_scale=1.5) for name in entries}
    for name in entries:
        e = store.get(name)
        if e.artifact is not None:
            solo[name].load_artifact(e.artifact, strict=True)
    rows = []
    for i, pol, _, seed, lab in trace:
        x = solo[pol].generate(params, serve.batch_generator([seed]), 1,
                               label=torch.tensor([lab], device="cuda"))
        got = torch.from_numpy(eng.results[i])
        rows.append({"rid": i, "entry": pol,
                     "max_abs": float((x[0].cpu() - got).abs().max()),
                     "max_abs_latent": float(got.abs().max())})
    stability = gemm_row_stability(cfg, ops)
    emit({"phase": "continuous", "requests": 12, "runs": [on, off],
          "solo_replay_max_abs": rows, "solo_replay_limit": 0.0,
          "gemm_row_max_abs_vs_4_requests": stability,
          "phase_s": time.perf_counter() - t_phase})
    check(all(v == 0.0 for d in stability["linear"].values()
              for v in d.values())
          and all(v == 0.0 for op in ("proxy", "layernorm", "gelu")
                  for v in stability[op].values()),
          f"a served-path op's rows change with the batch: {stability}")
    # every product goes through the batch-invariant linear kernel and
    # the proxy's row sums through one fixed tree: bitwise
    bad = [r for r in rows if r["max_abs"] != 0.0]
    check(not bad, f"served rows differ from their solo replays: {bad}")
    return on, off, rows


SLO_TAUS = [0.0, 0.05, 0.3]
SLO_CONTROLLER = dict(target_p95_wait_s=2.0, min_samples=2, interval_s=0.5,
                      cooldown_s=2.0)
# headroom < 1: the backlog estimate prices two interleaved batches'
# service times in full, which overstates each one's wait
SLO_ADMISSION = dict(max_backlog_s=8.0, aging_rate=0.5, headroom=0.75)
SLO_PHASES = [(1.0, 6), (4.0, 14), (1.0, 6)]   # (requests / s, requests)


def slo_phase(cfg, params, ops, store):
    """The SLO layer at full width (phase 13; budget ~40 s): a τ ladder
    (``SLO_TAUS``) of the serve phase's adaptive artifact behind an
    ``ElasticPolicy`` (target p95 wait 2 s) and an ``AdmissionController``
    (backlog threshold 8 s, aging 0.5 / s), ``max_batch`` 4, 2 in flight, a
    wall clock; an ``overload_trace`` of 26 requests (6 at ~1 / s, 14 at
    ~4 / s, above the ~1.7 images / s the drain sustains, then 6 at
    ~1 / s), strict (max τ 0.05, 6 s deadline, priority 1, 1 in 8) and
    bulk (8–16 s deadlines).  Then one
    request at each τ > 0 rung through a second engine on the same
    executor, the rung set by hand: the second rung must capture no graph.
    Checks: ≥ 1 controller change; graphs = distinct (bucket, τ > 0) pairs
    served; variants within the budget; every request served or shed with
    a reason; every served batch bitwise its ``generate`` at its rung's
    τ."""
    import numpy as np
    from repro_torch import serve, slo
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.serve.metrics import percentile
    t_phase = time.perf_counter()
    art = store.get(SERVE_ADAPTIVE).artifact
    ladder_store = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
    ladder = ladder_store.add_ladder("gen", art, taus=SLO_TAUS)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    changes = []

    class Elastic(slo.ElasticPolicy):
        # records the graphs and captured calls at each rung change
        def on_finish(self, engine, record, requests, now):
            before = self.controller.rung
            super().on_finish(engine, record, requests, now)
            if self.controller.rung != before:
                changes.append({
                    "t": now - t0, "rung": self.controller.rung,
                    "graphs": len(engine.executor.fused_graphs()),
                    "captured_linear": ops.CAPTURED["linear"]})

    ctrl = slo.ElasticTauController(len(ladder.taus), **SLO_CONTROLLER)
    eng = serve.ServeEngine(
        executor, params, ladder_store, max_batch=4, max_inflight=2,
        scheduler=Elastic(ctrl),
        admission=slo.AdmissionController(**SLO_ADMISSION))
    classes = [slo.RequestClass("strict", "gen", weight=1.0, priority=1,
                                deadline_budget=6.0, max_tau=0.05),
               slo.RequestClass("bulk", "gen", weight=7.0,
                                deadline_budget=(8.0, 16.0))]
    rng = np.random.RandomState(SEED + 12)
    t0 = eng.clock.now()
    reqs = slo.overload_trace(classes, SLO_PHASES, rng, start=t0)
    for r in reqs:
        r.label = int(rng.randint(cfg.num_classes))
    eng.submit(*reqs)
    torch.cuda.synchronize()
    eng.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t_phase
    rep = eng.report()
    outcomes = {r.rid: eng.outcome(r.rid)[0] for r in reqs}
    graphs = len(executor.fused_graphs())
    pairs = {(r.bucket, r.tau > 0) for r in eng.records}

    # the rung moved by hand between the two τ > 0 rungs: one request each
    # through an engine on the same executor (no controller)
    probe = serve.ServeEngine(executor, params, ladder_store, max_batch=4,
                              scheduler="edf")
    seen = []
    for i, rung in enumerate((1, 2)):
        ladder_store.set_rung("gen", rung)
        probe.submit(serve.Request(rid=1000 + i, seed=1000 + i,
                                   policy="gen", label=i))
        probe.run_until_drained()
        seen.append((len(executor.fused_graphs()), ops.CAPTURED["linear"]))
    # every served batch against generate at its rung's τ
    replay = {}
    for tau in sorted({r.tau for r in eng.records + probe.records}):
        replay[tau] = DiffusionPipeline(
            cfg, solvers.ddim(50),
            f"adaptive:base=smoothcache(alpha=0.18),tau={tau:g}",
            cfg_scale=1.5)
        replay[tau].load_artifact(art.at_tau(tau), strict=True)
    mismatched = []
    results = {**eng.results, **probe.results}
    for rec in eng.records + probe.records:
        x, dec = replay[rec.tau].generate(
            params, serve.batch_generator(rec.seeds), rec.bucket,
            label=torch.tensor(rec.labels, device="cuda"),
            return_decisions=True)
        served = torch.from_numpy(np.stack([results[i] for i in rec.rids]))
        if not (torch.equal(x.cpu(), served) and dec == rec.decisions):
            mismatched.append(rec.rids)
    waits = [r.queue_wait for r in reqs if r.queue_wait is not None]
    row = {"phase": "slo", "requests": len(reqs),
           "classes": {c.name: sum(r.slo.cls == c.name for r in reqs)
                       for c in classes},
           "served": rep["requests"], "shed": rep["shed"],
           "deferrals": rep["deferrals"],
           "attainment": rep["slo"]["attainment"],
           "goodput_fraction": rep["slo"]["goodput_fraction"],
           "goodput_rps": rep["slo"].get("goodput_rps"),
           "images_per_s": rep.get("throughput_rps"),
           "queue_wait_p95_s": percentile(waits, 95) if waits else None,
           "realized_tau": rep["realized_tau"],
           "batches": [(r.bucket, r.tau) for r in eng.records],
           "controller_history": [(t - t0, rung, p95)
                                  for t, rung, p95 in ctrl.history],
           "changes": changes, "graphs": graphs,
           "graph_keys_served": sorted(pairs),
           "graph_records": executor.fused_graphs(),
           "rung_probe": {"graphs_and_captured_after": seen,
                          "batches": [(r.bucket, r.tau)
                                      for r in probe.records]},
           "model_variants": rep["compiles"]["model_variants"],
           "program_budget": rep["program_budget"],
           "controller": SLO_CONTROLLER, "admission": SLO_ADMISSION,
           "arrivals": SLO_PHASES,
           "replays": len(eng.records) + len(probe.records),
           "replays_bitwise": not mismatched,
           "drain_s": drain_s, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check(len(ctrl.history) >= 1, "the controller never moved a rung")
    check(graphs == len(pairs),
          f"{graphs} fused graphs for the served (bucket, tau > 0) pairs "
          f"{sorted(pairs)}")
    check(seen[1] == seen[0],
          f"moving between tau > 0 rungs captured: {seen}")
    check(row["model_variants"] <= row["program_budget"],
          f"{row['model_variants']} model variants over the budget "
          f"{row['program_budget']}")
    check(all(o in ("done", "shed") for o in outcomes.values())
          and all(eng.shed[r][0] for r in eng.shed),
          f"requests without an outcome: {outcomes}")
    check(not mismatched, f"served batches differ from generate at their "
          f"rung's tau: {mismatched}")
    return row


RESILIENCE_POLICY = dict(watchdog_factor=4.0, watchdog_floor_s=0.5)
RESILIENCE_RAMP = dict(seed=1, nan_rate=0.15, stuck_rate=0.09,
                       error_rate=0.06)


def _replay_pipe(cfg, entry):
    """A pipeline that replays ``entry``'s batches through ``generate``
    (its policy, and its artifact where it has one)."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    pipe = DiffusionPipeline(cfg, solvers.ddim(50), entry.policy,
                             cfg_scale=1.5)
    if entry.artifact is not None:
        pipe.load_artifact(entry.artifact, strict=True)
    return pipe


def resilience_phase(cfg, params, ops, store):
    """Fault recovery at full width (phase 14; budget ~25 s): the
    SmoothCache artifact and the adaptive artifact, ``max_batch`` 4, 2 in
    flight, a wall clock, ``ResiliencePolicy(watchdog_factor=4.0,
    watchdog_floor_s=0.5)``, the chaos harness writing real NaNs into
    latents with ``mark_flags=False`` (only the executor's sentinels
    detect them).  (a) 8 requests clean, resilience off and on (A B B A):
    bitwise equal, the same batches, 0 faults, the health reads.  (b) 16
    requests under a fixed plan — the first batch formed (the adaptive
    one: the batcher takes groups in name order) a NaN in row 2 at chunk
    1, the second (static) a NaN in row 1, serial 2 an injected fault,
    serial 3 a stall 1 s past the deadline the watchdog holds that advance
    to: every request served, the fault kinds exact, one watchdog fire,
    records on the degraded and fallback entries, the static survivors
    bitwise their clean rows, every record without a split replaying
    bitwise through ``generate``.  (c) 16 requests under a seeded ramp of
    rate 0.3: every request resolves."""
    import dataclasses
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.resilience import (ChaosExecutor, FaultPlan, FaultSpec,
                                        ResiliencePolicy, faults)
    from repro_torch.serve.store import DEGRADED_PREFIX, FALLBACK_ENTRY
    from repro_torch.slo.slo import remaining_steps
    t_phase = time.perf_counter()
    static, adaptive = "smoothcache:alpha=0.18", SERVE_ADAPTIVE
    rng = np.random.RandomState(SEED + 19)
    trace = [(i, (static, adaptive)[i % 2], int(rng.randint(1 << 31)),
              int(rng.randint(cfg.num_classes))) for i in range(32)]
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    _reset_counts(ops)
    # the bucket-4 adaptive graph, captured before any drain is timed
    entry = store.get(adaptive)
    warm = executor.start_adaptive_fused_run(
        params, torch.Generator().manual_seed(0), 4, schedule=entry.schedule,
        tau=entry.tau, proxy_map=entry.proxy_map, pool=entry.pool(),
        k_max=entry.k_max,
        label=torch.zeros(4, dtype=torch.int64, device="cuda"))
    executor.fused_step_for(params, warm)
    del warm

    class Stall(ChaosExecutor):
        """Stalls a ``stuck_batch`` 1 s past the deadline the engine's
        watchdog will hold that advance to (the engine's own formula on
        its own cost model, for the batch the plan's serial turns out to
        be); ``stalls`` records (deadline, stall) per strike."""
        engine = None

        def _strike(self, rs):
            spec = rs._spec
            if (spec is not None and spec.kind == faults.STUCK_BATCH
                    and not rs._struck and rs._advances >= spec.chunk):
                fl = next(f for f in self.engine._inflight if f.rs is rs)
                steps = rs.num_steps - remaining_steps(rs)
                deadline = self.engine._watchdog_deadline(
                    steps, fl.mb.group, fl.mb.bucket)
                rs._spec = dataclasses.replace(spec, stall_s=deadline + 1.0)
                self.stalls.append({"serial": rs._serial,
                                    "group": fl.mb.group,
                                    "bucket": fl.mb.bucket, "steps": steps,
                                    "deadline_s": deadline,
                                    "stall_s": deadline + 1.0})
            super()._strike(rs)

    def drain(reqs, plan=None, chaos=ChaosExecutor):
        ex = executor
        if plan is not None:
            ex = chaos(executor, plan, mutate_latent=True, mark_flags=False)
            ex.stalls = []
        eng = serve.ServeEngine(
            ex, params, store, max_batch=4, max_inflight=2,
            scheduler="interleave",
            resilience=(ResiliencePolicy(**RESILIENCE_POLICY)
                        if plan is not None else None))
        if plan is not None:
            ex.engine = eng
        t0 = eng.clock.now()
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                                   arrival=t0)
                     for i, pol, seed, lab in reqs])
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        return eng, time.perf_counter() - w0

    # (a) clean: off (A), on (B), on (B), off (A)
    clean = trace[:8]
    runs = [drain(clean, FaultPlan() if on else None)
            for on in (False, True, True, False)]
    off, on = runs[0][0], runs[1][0]
    same_batches = all([(r.group, r.rids) for r in e.records]
                       == [(r.group, r.rids) for r in off.records]
                       for e, _ in runs)
    bitwise = all(sorted(e.results) == list(range(8)) and all(
        np.array_equal(e.results[i], off.results[i]) for i in range(8))
        for e, _ in runs)
    row_a = {"requests": 8, "walls_ABBA_s": [w for _, w in runs],
             "order": "A B B A (A: resilience off, B: on)",
             "bitwise": bitwise, "same_batches": same_batches,
             "faults": [e.metrics.faults_total for e, _ in runs],
             "batches": len(on.records), "health_reads": on.health_reads,
             "health_reads_per_batch": on.health_reads / len(on.records)}
    check(bitwise and same_batches and row_a["faults"] == [0, 0, 0, 0],
          f"clean drains differ with resilience on: {row_a}")

    # (b) the fixed plan; the first 8 requests are the clean drain's
    mem0 = torch.cuda.memory_allocated()
    graphs0 = len(executor.fused_graphs())
    plan = FaultPlan(faults={
        0: FaultSpec(faults.NAN_LATENT, row=2, chunk=1),
        1: FaultSpec(faults.NAN_LATENT, row=1, chunk=1),
        2: FaultSpec(faults.INJECTED, chunk=1),
        3: FaultSpec(faults.STUCK_BATCH, chunk=1)})
    eng, wall_b = drain(trace[:16], plan, Stall)
    rep = eng.report()
    m = eng.metrics
    last = {}
    for rec in eng.records:                  # a rid's delivering record is
        for rid in rec.rids:                 # its last one
            last[rid] = rec
    groups = {r.group for r in eng.records}
    batches0 = eng.executor.serial
    static_rids = [i for i, pol, _, _ in trace[:8] if pol == static]
    survivors = [r for r in static_rids if r != static_rids[1]]
    surv_diff = max(float(np.abs(eng.results[r] - off.results[r]).max())
                    for r in survivors)
    adaptive_split = [r for r in eng.records if r.group == adaptive
                      and any("split_retry@" in t for t in r.lineage)]
    replays, mismatched = 0, []
    pipes = {}
    for rec in eng.records:
        if any("split_retry@" in t for t in rec.lineage):
            continue
        e = store.get(rec.group)
        pipe = pipes.setdefault(rec.group, _replay_pipe(cfg, e))
        out = pipe.generate(params, serve.batch_generator(rec.seeds),
                            rec.bucket,
                            label=torch.tensor(rec.labels, device="cuda"),
                            **({"return_decisions": True} if e.adaptive
                               else {}))
        x, dec = out if isinstance(out, tuple) else (out, None)
        x = x.cpu().numpy()
        replays += 1
        rows = [j for j, rid in enumerate(rec.rids) if last[rid] is rec]
        if dec != rec.decisions or not all(
                np.array_equal(x[j], eng.results[rec.rids[j]])
                for j in rows):
            mismatched.append((rec.group, rec.rids))
    row_b = {"requests": 16, "drain_s": wall_b, "served": len(eng.results),
             "goodput": len(eng.results) / 16,
             "goodput_fraction": rep["slo"]["goodput_fraction"],
             "faults": rep["faults"], "row_retries": m.row_retries,
             "stalls": eng.executor.stalls,
             "injected": dict(eng.executor.injected),
             "launched_serials": batches0,
             "records": [(r.group, r.bucket, list(r.lineage))
                         for r in eng.records],
             "static_survivors": survivors,
             "static_survivors_max_abs_vs_clean": surv_diff,
             "adaptive_split_records": len(adaptive_split),
             "adaptive_survivors_finite": all(
                 bool(np.isfinite(eng.results[rid]).all())
                 for r in adaptive_split for rid in r.rids),
             "replays": replays, "replays_bitwise": not mismatched,
             "host_sync_count": executor.host_sync_count,
             "health_reads": eng.health_reads,
             "model_variants": rep["compiles"]["model_variants"],
             "program_budget": rep["program_budget"],
             "new_graphs": executor.fused_graphs()[graphs0:],
             "device_bytes_added": torch.cuda.memory_allocated() - mem0}
    check(sorted(eng.results) == list(range(16)),
          f"fixed plan: served {sorted(eng.results)} of 16")
    check(m.fault_kinds == {faults.NAN_LATENT: 2, faults.INJECTED: 1,
                            faults.STUCK_BATCH: 1},
          f"fixed plan: fault kinds {m.fault_kinds}")
    check(len(row_b["stalls"]) == 1
          and row_b["stalls"][0]["stall_s"] > row_b["stalls"][0][
              "deadline_s"], f"fixed plan: stalls {row_b['stalls']}")
    check(f"{DEGRADED_PREFIX}{adaptive}/tau0" in groups
          and FALLBACK_ENTRY in groups,
          f"fixed plan: no degraded or fallback record in {groups}")
    check(surv_diff == 0.0,
          f"static survivors differ from the clean run: {surv_diff}")
    check(adaptive_split and row_b["adaptive_survivors_finite"],
          "the adaptive batch did not split its NaN row out, or a "
          "survivor is not finite")
    check(not mismatched, f"records differ from generate: {mismatched}")
    check(executor.host_sync_count == 0,
          f"{executor.host_sync_count} decision syncs")
    check(row_b["model_variants"] <= row_b["program_budget"],
          f"{row_b['model_variants']} variants over the budget "
          f"{row_b['program_budget']}")

    # (c) a seeded ramp: 50 / 30 / 20 NaN / stall / error at rate 0.3
    eng, wall_c = drain(trace[16:], FaultPlan(**RESILIENCE_RAMP))
    rep = eng.report()
    m = eng.metrics
    outcomes = {i: eng.outcome(i) for i, _, _, _ in trace[16:]}
    row_c = {"requests": 16, "plan": RESILIENCE_RAMP, "drain_s": wall_c,
             "served": len(eng.results),
             "goodput": len(eng.results) / 16,
             "shed": rep["shed"], "faults": rep["faults"],
             "row_retries": m.row_retries,
             "injected": dict(eng.executor.injected),
             "host_sync_count": executor.host_sync_count}
    check(all(k == "done" or (k == "shed" and (v == "stalled"
                                               or v.startswith("fault:")))
              for k, v in outcomes.values()),
          f"ramp: unresolved requests {outcomes}")
    check(m.faults_total == sum(m.fault_kinds.values()),
          f"ramp: {m.faults_total} faults against {m.fault_kinds}")
    check(executor.host_sync_count == 0, "ramp: decision syncs")
    launches = _launched(ops)
    emit({"phase": "resilience", "policy": RESILIENCE_POLICY,
          "clean": row_a, "fixed_plan": row_b, "ramp": row_c,
          "launches": launches, "captured": dict(ops.CAPTURED),
          "replayed": dict(ops.REPLAYED),
          "phase_s": time.perf_counter() - t_phase})
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the resilience phase: {launches}")
    return launches


def telemetry_phase(cfg, params, ops, store):
    """Step telemetry at full width (phase 15; budget ~4 s): one fused
    batch of 4 on the adaptive artifact with ``telemetry=True`` and
    without, the replays under ``set_sync_debug_mode("error")``: latents,
    decisions and flags bitwise equal, no decision sync, 4 reports whose
    realized decisions are the host loop's, proxies finite from step 1;
    the telemetry graph's capture seconds and device bytes.  Then 8
    requests (adaptive and SmoothCache) through a ``ServeEngine`` with a
    ``Tracer`` and ``telemetry=True``, and with both off: bitwise equal,
    a report per served request, a valid trace."""
    import math
    import numpy as np
    from repro_torch import serve
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.obs import Tracer, run_cache_reports, \
        validate_chrome_trace
    t_phase = time.perf_counter()
    entry = store.get(SERVE_ADAPTIVE)
    executor = SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)
    labels = torch.tensor(REQUEST_LABELS, device="cuda")
    kw = dict(schedule=entry.schedule, tau=entry.tau,
              proxy_map=entry.proxy_map, pool=entry.pool(),
              k_max=entry.k_max, label=labels)
    n = len(REQUEST_LABELS)
    _reset_counts(ops)

    def gen():
        return torch.Generator().manual_seed(SEED + 19)

    runs, capture = {}, {}
    for on in (False, True):
        rs = executor.start_adaptive_fused_run(params, gen(), n,
                                               telemetry=on, **kw)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        step, wall = _timed(lambda: executor.fused_step_for(params, rs))
        capture[on] = {"warmup_s": step.stats["warmup_s"],
                       "capture_s": step.stats["capture_s"],
                       "wall_s": wall,
                       "device_bytes": torch.cuda.memory_allocated() - mem0}
        torch.cuda.set_sync_debug_mode("error")
        try:
            rs = executor.advance_adaptive_fused(params, rs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        runs[on] = rs
    on, off = runs[True], runs[False]
    _, dh = executor.sample_adaptive(params, gen(), n, return_decisions=True,
                                     **kw)
    host_syncs = executor.host_sync_count
    reps = run_cache_reports(on, n)
    fields = ("x", "trace", "healthy", "acc", "lag")
    row = {"requests": n, "capture": {"off": capture[False],
                                      "telemetry": capture[True]},
           "bitwise": {f: bool(torch.equal(getattr(on, f), getattr(off, f)))
                       for f in fields},
           "decisions_equal": on.decisions == off.decisions == dh,
           "sync_guard": "error", "host_loop_syncs": host_syncs,
           "reports": len(reps),
           "reports_realized_host_loop": all(r.realized == dh
                                             for r in reps),
           "proxy_finite_from_step_1": all(
               all(p is not None and math.isfinite(p) for p in r.proxy[1:])
               for r in reps),
           "proxy_rows": [[round(p, 6) for p in r.proxy[1:6]] for r in reps],
           "graphs": executor.fused_graphs()}
    check(all(row["bitwise"].values()) and row["decisions_equal"],
          f"telemetry changed the run: {row['bitwise']}")
    check(row["reports"] == n and row["reports_realized_host_loop"]
          and row["proxy_finite_from_step_1"],
          "telemetry reports disagree with the host loop or hold a "
          "non-finite proxy")

    # the engine with a tracer and telemetry, and with both off
    rng = np.random.RandomState(SEED + 20)
    reqs = [(i, (SERVE_ADAPTIVE, "smoothcache:alpha=0.18")[i % 2],
             int(rng.randint(1 << 31)), int(rng.randint(cfg.num_classes)))
            for i in range(8)]
    engines = {}
    for obs_on in (True, False):
        clock = serve.WallClock()
        kwe = ({"tracer": Tracer(clock), "telemetry": True} if obs_on
               else {})
        eng = serve.ServeEngine(executor, params, store, clock=clock,
                                max_batch=4, max_inflight=2, **kwe)
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab)
                     for i, pol, seed, lab in reqs])
        _, wall = _timed(eng.run_until_drained)
        engines[obs_on] = (eng, wall)
    e_on, e_off = engines[True][0], engines[False][0]
    n_events = validate_chrome_trace(e_on.tracer.to_chrome_trace())
    drain_bitwise = sorted(e_on.results) == sorted(e_off.results) == \
        list(range(8)) and all(np.array_equal(e_on.results[i],
                                              e_off.results[i])
                               for i in range(8))
    realized = all(e_on.cache_reports[rid].realized == rec.decisions
                   for rec in e_on.records if rec.decisions
                   for rid in rec.rids)
    launches = _launched(ops)
    row.update({"engine": {
        "requests": 8, "walls_s": {"tracer_and_telemetry":
                                   engines[True][1],
                                   "both_off": engines[False][1]},
        "bitwise": drain_bitwise,
        "reports": sorted(e_on.cache_reports),
        "reports_realized": realized,
        "trace_events": n_events,
        "host_sync_count": executor.host_sync_count - host_syncs},
        "launches": launches, "captured": dict(ops.CAPTURED),
        "replayed": dict(ops.REPLAYED),
        "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "telemetry", **row})
    check(drain_bitwise, "the traced telemetry drain differs from the "
          "plain one")
    check(sorted(e_on.cache_reports) == list(range(8)) and realized,
          "a served request has no report, or one realizing other "
          "decisions")
    check(row["engine"]["host_sync_count"] == 0,
          "decision syncs in the telemetry drains")
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the telemetry phase: {launches}")
    return launches


DURABLE_KILLS = dict(seed=0, kill_rate=0.3, max_kills=4)
DURABLE_MIN_FREE = 4e9        # bytes the snapshot directory must have free


def _free_engine(eng):
    """What a process death frees on the card: the engine's in-flight run
    states and its executor's captured graphs (buffers and memory pool)."""
    eng._inflight.clear()
    eng.executor.release_graphs()
    gc.collect()
    torch.cuda.empty_cache()


def durable_phase(cfg, params, ops, store):
    """Durable serving at full width (phase 16; budget ~30 s): the
    SmoothCache artifact and the adaptive artifact (fused), ``max_batch``
    2, 2 in flight, ``adaptive_chunk`` 4, a wall clock, the fused
    advances under ``set_sync_debug_mode("error")`` (captures and
    checkpoints outside it).  (d) 8 requests with durability off, on, on,
    off at ``checkpoint_every=1`` and one on / off pair at 4: walls,
    overhead, and per run kind the bytes of a snapshot and the seconds of
    its device→host copy, sha256 and file write, with the journal's
    fsyncs; the off drains' rows are the uninterrupted rows below.  (a)
    2 + 2 requests stepped until both batches hold a snapshot, killed; a
    fresh engine on a fresh executor (the old one's graphs freed)
    restores both and finishes bitwise the uninterrupted rows.  (b) the
    same with one snapshot's body byte flipped and the other's entry
    re-registered under a new version: both quarantined with reasons,
    their requests replayed from the start, bitwise.  (c) the 8 requests
    under ``KillPlan(seed=0, kill_rate=0.3, max_kills=4)``, a fresh
    engine and executor per incarnation: 0 lost, rows bitwise, every rid
    ``done`` in a probe recovered from the journal alone, device memory
    at each restart not growing."""
    import shutil

    import numpy as np
    from repro_torch import serve
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.durable import KillPlan, crash, drain_with_kills
    t_phase = time.perf_counter()
    static, adaptive = "smoothcache:alpha=0.18", SERVE_ADAPTIVE
    rng = np.random.RandomState(SEED + 23)
    reqs = [(i, (adaptive, static)[i % 2], int(rng.randint(1 << 31)),
             int(rng.randint(cfg.num_classes))) for i in range(8)]
    _reset_counts(ops)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    free = shutil.disk_usage(tmp).free
    check(free >= DURABLE_MIN_FREE,
          f"{tmp} has {free} bytes free; the durable phase needs "
          f"{DURABLE_MIN_FREE:.0f}")
    costs = {}                               # run kind → checkpoint costs

    def make_store(bump=None):
        dstore = serve.ArtifactStore(cfg, solvers.ddim(50), cfg_scale=1.5)
        for name in (static, adaptive):
            dstore.add_artifact(name, store.get(name).artifact)
        if bump is not None:                 # re-registered: version 2
            dstore.reload(bump, store.get(bump).artifact)
        return dstore

    class Engine(serve.ServeEngine):
        """Fused advances under the sync guard (a new graph's capture
        before it); each checkpoint's bytes and seconds by run kind."""

        def _advance(self, fl):
            if fl.kind != "adaptive_fused":
                return super()._advance(fl)
            self.executor.fused_step_for(self.params, fl.rs)
            torch.cuda.set_sync_debug_mode("error")
            try:
                super()._advance(fl)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def _checkpoint(self, fl):
            t0 = dict(self._snapshots.timings)
            b0, n0 = self.metrics.checkpoint_bytes, self.metrics.checkpoints
            super()._checkpoint(fl)
            row = costs.setdefault(fl.kind, {"snapshots": 0, "bytes": 0})
            row["snapshots"] += self.metrics.checkpoints - n0
            row["bytes"] += self.metrics.checkpoint_bytes - b0
            for k, v in self._snapshots.timings.items():
                row[k] = row.get(k, 0.0) + v - t0.get(k, 0.0)

    def engine(ex, dstore=None, sub=None, **kw):
        dur = {}
        if sub is not None:
            dur = dict(journal=str(Path(tmp) / sub / "journal.jsonl"),
                       snapshot_dir=str(Path(tmp) / sub / "snapshots"))
        return Engine(ex, params, dstore or make_store(), max_batch=2,
                      max_inflight=2, adaptive_chunk=4, **dur, **kw)

    def submit(eng, rows):
        t0 = eng.clock.now()
        eng.submit(*[serve.Request(rid=i, seed=seed, policy=pol, label=lab,
                                   arrival=t0) for i, pol, seed, lab in rows])

    def executor():
        return SmoothCacheExecutor(cfg, solvers.ddim(50), cfg_scale=1.5)

    def bitwise(results, rids):
        return (sorted(results) == sorted(rids) and max(
            float(np.abs(results[i] - clean[i]).max()) for i in rids) == 0.0)

    # (d) what durability costs: off, on, on, off at checkpoint_every=1,
    # then on, off at 4; one executor, its bucket-2 graph captured first
    ex = executor()
    warm = engine(ex)
    submit(warm, reqs[:2])
    warm.run_until_drained()
    drains, syncs = [], []
    for on, every in ((False, 1), (True, 1), (True, 1), (False, 1),
                      (True, 4), (False, 4)):
        costs.clear()
        eng = engine(ex, sub=f"d{len(drains)}" if on else None,
                     checkpoint_every=every)
        submit(eng, reqs)
        _, wall = _timed(eng.run_until_drained)
        row = {"durability": on, "checkpoint_every": every, "wall_s": wall,
               "checkpoints": eng.metrics.checkpoints,
               "checkpoint_bytes": eng.metrics.checkpoint_bytes}
        if on:
            row.update(fsyncs=eng.journal.synced,
                       fsync_s=eng.journal.sync_s,
                       by_kind={k: dict(v) for k, v in costs.items()})
        drains.append(row)
        syncs.append(ex.host_sync_count)
        if not on and every == 1:
            if len(drains) == 1:
                clean = dict(eng.results)
            check(bitwise(eng.results, [r[0] for r in reqs]),
                  "two durability-off drains differ")
        else:
            check(bitwise(eng.results, [r[0] for r in reqs]),
                  f"a drain with durability on differs: {row}")
    walls = [d["wall_s"] for d in drains]
    per_kind = {}
    for kind in ("plan", "adaptive_fused"):
        rows = [d["by_kind"][kind] for d in drains[1:3]
                if kind in d["by_kind"]]
        n = sum(r["snapshots"] for r in rows)
        check(n > 0, f"no {kind} snapshot in the durable drains")
        per_kind[kind] = {"snapshots": n,
                          "bytes_per_snapshot": sum(r["bytes"]
                                                    for r in rows) / n}
        for k in ("sync_s", "copy_s", "hash_s", "write_s"):
            per_kind[kind][k + "_per_snapshot"] = sum(
                r.get(k, 0.0) for r in rows) / n
    off1, on1 = (walls[0] + walls[3]) / 2, (walls[1] + walls[2]) / 2
    row_d = {"requests": 8, "walls_s": walls,
             "order": "off, on, on, off at checkpoint_every=1; on, off at 4",
             "drains": drains, "per_kind": per_kind,
             "overhead_every_1": (on1 - off1) / off1,
             "overhead_every_4": (walls[4] - walls[5]) / walls[5],
             "host_sync_count": ex.host_sync_count}
    check(ex.host_sync_count == 0, f"decision syncs: {syncs}")
    _free_engine(warm)
    del warm, eng, ex

    # (a) kill with a static and a fused batch in flight, restore, finish
    def kill_midflight(sub):
        ex = executor()
        eng = engine(ex, sub=sub)
        submit(eng, reqs[:4])
        for _ in range(64):
            if (len(eng._inflight) == 2 and len(eng._snapshots.live()) == 2
                    and all(not fl.rs.done for fl in eng._inflight)):
                break
            eng.step()
        kinds = sorted(fl.kind for fl in eng._inflight)
        steps = [int(fl.rs.step) for fl in eng._inflight]
        check(len(eng._snapshots.live()) == 2,
              f"{sub}: no snapshot of both batches ({kinds}, {steps})")
        crash(eng)
        _free_engine(eng)
        return kinds, steps

    kinds, steps = kill_midflight("a")
    mem0 = torch.cuda.memory_allocated()
    ex = executor()
    eng = engine(ex, sub="a")
    summary = eng.recover()
    _, wall = _timed(eng.run_until_drained)
    rids = [r[0] for r in reqs[:4]]
    diff = max(float(np.abs(eng.results[i] - clean[i]).max()) for i in rids)
    row_a = {"requests": 4, "killed_kinds": kinds, "killed_at_steps": steps,
             "summary": summary, "drain_s": wall, "max_abs_vs_clean": diff,
             "lineage": [list(r.lineage) for r in eng.records],
             "host_sync_count": ex.host_sync_count,
             "device_bytes_before_restart": mem0}
    check(summary["restored_runs"] == 2 and summary["replayed"] == 0
          and not summary["refused"], f"(a) recover: {summary}")
    check(kinds == ["adaptive_fused", "plan"], f"(a) in flight: {kinds}")
    check(bitwise(eng.results, rids), f"(a) restored rows differ: {diff}")
    check(ex.host_sync_count == 0, "(a) decision syncs")
    _free_engine(eng)
    del eng, ex

    # (b) one snapshot torn by a flipped body byte, the other's entry
    # re-registered under a new version
    kill_midflight("b")
    sdir = Path(tmp) / "b" / "snapshots"
    for path in sorted(sdir.iterdir()):
        if ckpt_io.read_meta(str(path))["kind"] == "plan":
            raw = bytearray(path.read_bytes())
            raw[-1] ^= 0xFF
            path.write_bytes(bytes(raw))
    dstore = make_store(bump=adaptive)
    ex = executor()
    eng = engine(ex, dstore, sub="b")
    summary = eng.recover()
    eng.run_until_drained()
    reasons = {q: dstore.health.quarantine_reason(f"snapshot:{q}")
               for q, _ in summary["refused"]}
    row_b = {"summary": summary, "health": reasons,
             "quarantined_files": sorted(p.name for p in sdir.iterdir()),
             "max_abs_vs_clean": max(float(np.abs(
                 eng.results[i] - clean[i]).max()) for i in rids)}
    check(summary["restored_runs"] == 0 and summary["replayed"] == 4
          and len(summary["refused"]) == 2, f"(b) recover: {summary}")
    check(all(reasons[q] == r for q, r in summary["refused"])
          and any("CheckpointError" in r for r in reasons.values())
          and any("provenance drift on version" in r
                  for r in reasons.values()),
          f"(b) quarantine reasons: {reasons}")
    check(bitwise(eng.results, rids), "(b) replayed rows differ")
    _free_engine(eng)
    del eng, ex

    # (c) the kill ramp: a fresh engine and executor per incarnation
    incarnations, live = [], {}

    def factory():
        old = live.pop("eng", None)
        if old is not None:
            incarnations[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
            _free_engine(old)
        torch.cuda.reset_peak_memory_stats()
        incarnations.append({"start_bytes": torch.cuda.memory_allocated()})
        live["eng"] = engine(executor(), sub="c")
        return live["eng"]

    first = factory()
    submit(first, reqs)
    crash(first)
    plan = KillPlan(**DURABLE_KILLS)
    t0 = time.perf_counter()
    rep = drain_with_kills(factory, plan)
    ramp_s = time.perf_counter() - t0
    incarnations[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
    final = rep.engine.report()["durable"]
    probe = factory()
    probe.recover()
    outcomes = {r[0]: probe.outcome(r[0])[0] for r in reqs}
    starts = [m["start_bytes"] for m in incarnations[:-1]]
    row_c = {"requests": 8, "plan": DURABLE_KILLS, "restarts": rep.restarts,
             "kill_ticks": sorted(t for t, hit in plan._memo.items() if hit),
             "ticks": rep.ticks, "ramp_s": ramp_s,
             "delivered": len(rep.delivered),
             "max_abs_vs_clean": max(float(np.abs(
                 rep.delivered[i] - clean[i]).max()) for i in rep.delivered),
             "final_durable": final, "probe_outcomes": outcomes,
             "incarnations": incarnations[:-1]}
    check(rep.restarts == DURABLE_KILLS["max_kills"],
          f"(c) {rep.restarts} restarts")
    check(bitwise(rep.delivered, [r[0] for r in reqs]),
          f"(c) lost or changed rows: {sorted(rep.delivered)}")
    check(all(v == "done" for v in outcomes.values()),
          f"(c) probe outcomes: {outcomes}")
    check(max(starts) - starts[0] <= 64 << 20,
          f"(c) device memory grew across restarts: {starts}")
    _free_engine(probe)
    del probe, first, rep, live
    shutil.rmtree(tmp, ignore_errors=True)
    launches = _launched(ops)
    emit({"phase": "durable", "costs": row_d, "restore": row_a,
          "refusals": row_b, "kill_ramp": row_c, "launches": launches,
          "captured": dict(ops.CAPTURED), "replayed": dict(ops.REPLAYED),
          "phase_s": time.perf_counter() - t_phase})
    check(launches["flash_attention"] > 0 and launches["linear"] > 0,
          f"a kernel never launched in the durable phase: {launches}")
    return launches


# ---------------------------------------------------------------------------
# The video slice: OpenSora-v1.2 at full width
# ---------------------------------------------------------------------------

VIDEO_STEPS, VIDEO_CFG, VIDEO_MEM = 30, 7.0, 300     # Open-Sora v1.2's own
VIDEO_SMOOTH = "smoothcache:alpha=0.1"
VIDEO_ADAPTIVE = "adaptive:base=smoothcache(alpha=0.1),tau=0.3"


def video_kernel_phase(fa, ref, gemm, peaks, cfg):
    """The attention kernel at the video path's shapes for one request
    under CFG (B = 2) — spatial (32, 256), temporal (512, 16), cross
    (2, 4096) over a 300-token memory (ragged against the 32-key tile) —
    and temporal at 8 requests (B·S·H = 65536 blocks, past the old grid
    limit): against the plain version (≤ 5e-5), two launches bitwise,
    device ms beside the bound and SDPA's; a ragged-key sweep; then every
    product shape of one B = 2 forward against cuBLAS f32 (≤ 5e-5 of the
    output's scale) with its device ms, bound and cuBLAS's ms."""
    import torch.nn.functional as F
    from repro_torch.core.diffusion import token_shape
    from repro_torch.kernels.products import gemms
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 40)
    h, d = 16, 72
    n_tok, _, (frames, space) = token_shape(cfg)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    sweep = []
    for lq, lk in ((64, 1), (64, 33), (100, 300), (16, 300), (256, 77)):
        q, k, v = rand(2, lq, 4, 72), rand(2, lk, 4, 72), rand(2, lk, 4, 72)
        out = fa.flash_attention_cuda(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        sweep.append({"lq": lq, "lk": lk, "max_abs_err": err})
        check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
              f"ragged-key attention vs plain {sweep[-1]}")
    emit({"phase": "video_attention_sweep", "cases": sweep})

    shapes = {"spatial": (2 * frames, space, space),
              "temporal": (2 * space, frames, frames),
              "cross": (2, n_tok, VIDEO_MEM),
              "temporal_8req": (16 * space, frames, frames)}
    attn = {}
    for name, (b, lq, lk) in shapes.items():
        q, k, v = rand(b, lq, h, d), rand(b, lk, h, d), rand(b, lk, h, d)
        out = fa.flash_attention_cuda(q, k, v, causal=False)
        again = fa.flash_attention_cuda(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
              f"{name} attention vs plain: max abs err {err}")
        check(bool(torch.equal(out, again)),
              f"two launches at the {name} shape differ")
        flops, nbytes, unit = fa.work(b, lq, lk, h, h, d)
        bound, by = kernel_bound(peaks, (flops, nbytes, unit))
        row = {"shape": [b, lq, lk, h, d], "blocks": b * h * -(-lq // 64),
               "max_abs_err": err, "bound_ms": bound, "bound_by": by,
               "flops": flops, "bytes": nbytes}
        if name != "temporal_8req":
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            row.update(
                ms=device_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                             causal=False)),
                plain_ms=device_ms(lambda: ref.flash_attention_ref(
                    q, k, v, causal=False), iters=10),
                library_ms=device_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt)))
            row["bound_share"] = bound / row["ms"]
        attn[name] = row
        del q, k, v, out, again, want
    emit({"phase": "video_attention", "shapes": attn})

    products, worst = [], 0.0
    for m, k, n, bias, calls, rows in gemms(cfg, 2, VIDEO_MEM):
        x = rand(m, k)
        w = rand(k, n) / k ** 0.5
        b = rand(n) if bias else None
        out = gemm.linear_cuda(x, w, b, rows=rows)
        want = ref.linear_ref(x, w, b)
        torch.cuda.synchronize()
        rel = float((out - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(rel <= 5e-5, f"video product ({m}, {k}, {n}) {rows}: "
              f"relative error {rel}")
        products.append({**product_times(gemm, ref, peaks, x, w, b, rows,
                                         reps=SWEEP_REPS),
                         "calls": calls, "rel_max_err": rel})
        gemm.release()
    summary = {"products": products, "max_rel_err": worst,
               **{f"forward_{key}": sum(p[key] * p["calls"]
                                        for p in products)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    emit({"phase": "video_products", "batch": 2, **summary,
          "seconds": time.perf_counter() - t_phase})
    return attn, summary


def video_cross_check_phase(cfg, diffusion, gemm, random_params):
    """Card forward against CPU forward at full width and the full 16 × 256
    tokens plus a 300-token memory, depth cut to 2 block pairs, one request
    under CFG (B = 2, the second half with a zero memory)."""
    from repro_torch.config import Stage
    from repro_torch.data import synthetic
    from repro_torch.models.transformer import tree_map
    cut = cfg.replace(stages=(Stage(unit=cfg.stages[0].unit, repeat=2),))
    p_cpu = random_params(torch.Generator().manual_seed(SEED + 41), cut,
                          device="cpu")
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    gen = torch.Generator().manual_seed(SEED + 42)
    x = torch.randn((1,) + cut.latent_shape, generator=gen).repeat(2, 1, 1,
                                                                   1, 1)
    mem = synthetic.text_memory(gen, 1, VIDEO_MEM, cut.cond_dim,
                                device="cpu")
    mem = torch.cat([mem, torch.zeros_like(mem)])
    t = torch.tensor([700.0, 700.0])
    (pred_gpu, _), gpu_s = _timed(lambda: diffusion.apply(
        cut, p_gpu, x.cuda(), t.cuda(), memory=mem.cuda()))
    t0 = time.perf_counter()
    pred_cpu, _ = diffusion.apply(cut, p_cpu, x, t, memory=mem)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(pred_cpu).all()), "CPU prediction not finite")
    scale = float(pred_cpu.abs().max())
    rel = float((pred_gpu.cpu() - pred_cpu).abs().max()) / scale
    emit({"phase": "video_cross_check", "blocks": cut.num_layers,
          "tokens": diffusion.token_shape(cut)[0], "memory": VIDEO_MEM,
          "batch": 2, "max_abs_pred": scale, "rel_max_err": rel,
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(rel <= 1e-4, f"video card vs CPU forward: relative error {rel}")
    gemm.release()          # the cut model's prepared halves


def video_slice_phase(cfg, params, ops, memory):
    """The full-width OpenSora slice: rectified flow 30, CFG 7.0, a
    300-token memory.  Calibrate on 2 samples at k_max 3 under the adaptive
    policy (its base is ``smoothcache:alpha=0.1``), save the artifact, load
    it strictly into fresh pipelines, answer 1 request with ``no_cache``,
    the artifact's SmoothCache schedule and ``static:n=2``: every latent
    finite, attention launches = Σ over steps of 28 per computed
    ``s_attn`` / ``t_attn`` / ``s_xattn`` / ``t_xattn``, linear launches =
    Σ over steps of 5 + Σ over the 56 blocks of (1 + 4 per computed
    attention or cross branch + 2 per computed MLP), segmented ≡ eager
    bitwise; walls, compute fraction, rel-L1 to ``no_cache``, peak
    memory."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.core.diffusion import token_shape
    t_phase = time.perf_counter()
    calib_mem = torch.cat([memory, memory.flip(1)])   # 2 samples
    types = cfg.layer_types()
    # the calibration's window: k_max + 1 steps of every branch output of
    # the conditioned half (2 samples), each layer type over its 28 blocks
    window = ((3 + 1) * len(types) * (cfg.num_layers // 2) * 2
              * token_shape(cfg)[0] * cfg.d_model * 4)
    pipe = DiffusionPipeline(cfg, solvers.rectified_flow(VIDEO_STEPS),
                             VIDEO_ADAPTIVE, cfg_scale=VIDEO_CFG)
    torch.cuda.reset_peak_memory_stats()
    art, calib_s = _timed(lambda: pipe.calibrate(
        params, torch.Generator().manual_seed(SEED + 43), 2,
        cond_args={"memory": calib_mem}, k_max=3))
    emit({"phase": "video_calibrate", "samples": 2, "steps": VIDEO_STEPS,
          "k_max": 3, "seconds": calib_s,
          "window_bytes_reckoned": window,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "compute_fraction": pipe.compute_fraction(),
          "lag1_err_mid": {t: float(c[15, 1])
                           for t, c in art.curves.items()}})
    with tempfile.TemporaryDirectory() as tmp:
        path = pipe.save_artifact(str(Path(tmp) / "opensora_rf30.cache.json"))
        serve = DiffusionPipeline(cfg, solvers.rectified_flow(VIDEO_STEPS),
                                  VIDEO_SMOOTH, cfg_scale=VIDEO_CFG)
        serve.load_artifact(path, strict=True)
        adaptive = DiffusionPipeline(cfg,
                                     solvers.rectified_flow(VIDEO_STEPS),
                                     VIDEO_ADAPTIVE, cfg_scale=VIDEO_CFG)
        adaptive.load_artifact(path, strict=True)
    check(serve.schedule.to_json() == art.schedule.to_json()
          == serve.schedule_for(VIDEO_SMOOTH).to_json(),
          "the artifact's schedule is not smoothcache:alpha=0.1's")

    runs, latents = [], {}
    torch.cuda.reset_peak_memory_stats()
    for name, sch in (("no_cache", None), (VIDEO_SMOOTH, serve.schedule),
                      ("static:n=2", serve.schedule_for("static:n=2"))):
        kw = {} if name == VIDEO_SMOOTH else {"schedule": sch}
        steps = [[t for t in types if sch is None or not sch.skip[t][s]]
                 for s in range(VIDEO_STEPS)]
        want_attn = sum(attn_calls(cfg, c) for c in steps)
        want_linear = sum(linear_calls(cfg, c) for c in steps)
        counts = graph_counts(ops, serve.executor)
        x, wall = _timed(lambda: serve.generate(
            params, torch.Generator().manual_seed(SEED + 44), 1,
            memory=memory, **kw))
        counts = graph_counts(ops, serve.executor, counts)
        attn = counts["replayed"]["flash_attention"]
        linear = counts["replayed"]["linear"]
        latents[name] = x
        frac = (1.0 if sch is None else float(sum(
            sch.compute_fraction(t) for t in types) / len(types)))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(attn == want_attn, f"{name}: {attn} attention launches, "
              f"expected {want_attn}")
        check(linear == want_linear, f"{name}: {linear} linear launches, "
              f"expected {want_linear}")
        check(counts["calls"] == counts["warmup"],
              f"{name}: calls {counts['calls']} besides the warm-ups "
              f"{counts['warmup']}")
        base = latents["no_cache"]
        runs.append({"run": name, "requests": 1, "wall_s": wall,
                     "compute_fraction": frac, "attn_launches": attn,
                     "linear_launches": linear,
                     "new_graphs": counts["new_graphs"],
                     "peak_device_bytes": torch.cuda.max_memory_allocated(),
                     "skipped_steps": {t: int(sch.skip[t].sum())
                                       for t in types} if sch is not None
                     else None,
                     "rel_l1_to_no_cache": float((x - base).abs().sum()
                                                 / base.abs().sum())})
        emit({"phase": "video_generate", **runs[-1]})
    eager, eager_s = _timed(lambda: serve.generate(
        params, torch.Generator().manual_seed(SEED + 44), 1, memory=memory,
        compiled=False))
    same = bool(torch.equal(eager, latents[VIDEO_SMOOTH]))
    emit({"phase": "video_segmented_vs_eager", "run": VIDEO_SMOOTH,
          "bitwise_equal": same, "eager_wall_s": eager_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(same, "video: segmented and eager latents differ")
    return adaptive, time.perf_counter() - t_phase


def video_fused_phase(cfg, params, ops, adaptive, memory):
    """One fused adaptive batch (1 request, B = 2 in the kernels) against
    the host loop, latents and decisions bitwise, the replays under
    ``set_sync_debug_mode("error")`` with no decision sync: capture
    seconds, branches, walls."""
    ex = adaptive.executor
    kw = dict(schedule=adaptive.schedule, tau=adaptive.policy.tau,
              proxy_map=adaptive.proxy_map, k_max=adaptive.policy.k_max,
              memory=memory)

    def gen():
        return torch.Generator().manual_seed(SEED + 45)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rs = ex.start_adaptive_fused_run(params, gen(), 1, **kw)
    step, capture_s = _timed(lambda: ex.fused_step_for(params, rs))
    mem1 = torch.cuda.memory_allocated()
    syncs = ex.host_sync_count
    (xh, dh), host_s = _timed(lambda: ex.sample_adaptive(
        params, gen(), 1, return_decisions=True, **kw))
    host_syncs = ex.host_sync_count - syncs
    syncs = ex.host_sync_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rs = ex.advance_adaptive_fused(params, rs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    same = bool(torch.equal(rs.x, xh)) and rs.decisions == dh
    row = {"phase": "video_fused", "requests": 1, "steps": VIDEO_STEPS,
           "branches": step.stats["branches"], "types": step.stats["types"],
           "warmup_s": step.stats["warmup_s"],
           "capture_s": step.stats["capture_s"],
           "capture_wall_s": capture_s, "graph_bytes": mem1 - mem0,
           "host_loop_s": host_s, "fused_s": fused_s,
           "host_syncs": host_syncs,
           "fused_syncs": ex.host_sync_count - syncs,
           "skipped_per_step": [len(d) for d in dh],
           "bitwise_equal": same}
    emit(row)
    check(same, "video: fused and host-loop latents or decisions differ")
    check(row["fused_syncs"] == 0, "the fused video run synced the host")
    check(any(dh), "the adaptive video run skipped nothing")


def memory_profile_phase(phase, seed, cfg, diffusion, params, ops, memory):
    """Where a video or audio step's time goes (``phase`` names the line):
    one full-width B = 2 forward (one request under CFG) after an untraced
    warm-up — device time by kernel, the attention and linear kernels'
    shares, the device's idle share.  The launches are the wrappers'
    counts and must be one forward's; a trace drops kernel records, never
    adds one, so the forward is traced again (up to ``TRACE_TRIES`` times)
    until the trace holds every attention and linear launch, and its times
    are null if none does."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2,) + cfg.latent_shape, generator=gen).cuda()
    t = torch.full((2,), 500.0, device="cuda")
    mem = torch.cat([memory, torch.zeros_like(memory)])
    diffusion.apply(cfg, params, x, t, memory=mem)
    for tries in range(1, TRACE_TRIES + 1):
        before = dict(ops.LAUNCHES)
        wall_us, kern = _traced(lambda: diffusion.apply(cfg, params, x, t,
                                                        memory=mem))
        calls = {k: ops.LAUNCHES[k] - before[k]
                 for k in ("flash_attention", "linear")}
        in_trace = {
            "flash_attention": sum(n for k, (_, n) in kern.items()
                                   if "attn_fwd" in k),
            "linear": sum(n for k, (_, n) in kern.items()
                          if any(v in k for v in LINEAR_KERNELS.values()))}
        check(all(in_trace[k] <= calls[k] for k in calls),
              f"{phase}: the trace holds {in_trace} kernels, more than the "
              f"{calls} launched")
        complete = in_trace == calls
        if complete:
            break
    busy = sum(us for us, _ in kern.values())
    attn = sum(us for k, (us, _) in kern.items() if "attn_fwd" in k)
    linear = sum(us for k, (us, _) in kern.items()
                 if any(n in k for n in LINEAR_KERNELS.values()))
    library = [k for k in kern
               if not any(n in k for n in LINEAR_KERNELS.values()) and any(
                   f in k.lower() for f in ("gemm", "cutlass", "xmma",
                                            "cublas"))]
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]

    def timed(v):
        return v if complete else None

    row = {"phase": phase, "batch": 2, "wall_ms": wall_us / 1e3,
           "trace_complete": complete, "traces": tries,
           "device_ms": timed(busy / 1e3),
           "idle_share": timed(1 - busy / wall_us),
           "attn_ms": timed(attn / 1e3),
           "attn_calls": calls["flash_attention"],
           "attn_kernels_in_trace": in_trace["flash_attention"],
           "attn_share": timed(attn / busy) if busy else None,
           "linear_ms": timed(linear / 1e3),
           "linear_share": timed(linear / busy) if busy else None,
           "linear_calls": calls["linear"],
           "linear_kernels_in_trace": in_trace["linear"],
           "library_gemm_kernels": library,
           "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": n}
                   for k, (us, n) in top]}
    emit(row)
    check(busy > 0, f"{phase}: the profiler saw no device time")
    types = cfg.layer_types()
    check(calls["flash_attention"] == attn_calls(cfg, types),
          f"{phase}: {calls['flash_attention']} attention calls in one "
          f"forward ({in_trace['flash_attention']} in the trace)")
    check(calls["linear"] == linear_calls(cfg, types) and not library,
          f"{phase}: {calls['linear']} linear calls in one forward, other "
          f"product kernels {library}")
    return row


def video_phase(peaks, kernels):
    """The OpenSora-v1.2 text-to-video path at full width (56 blocks, 16 ×
    256 tokens, a 300-token T5 memory stub, rectified flow 30, CFG 7.0),
    after the LM phases, on weights of its own.  Budget ~110 s."""
    from repro_torch import configs
    from repro_torch.core import diffusion
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve_diffusion import random_params
    t_phase = time.perf_counter()
    cfg = configs.get("opensora-v12")
    attn_shapes, products = video_kernel_phase(fa, ref, gemm, peaks, cfg)
    video_cross_check_phase(cfg, diffusion, gemm, random_params)
    t0 = time.perf_counter()
    # drawn on the card (a CPU draw of these widths took ~10-30 s)
    params = random_params(torch.Generator(device="cuda").manual_seed(
        SEED + 47), cfg, device="cuda")
    prepared = diffusion.prepare_linear(params)
    torch.cuda.synchronize()
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params)),
          "linear_prepared_bytes": prepared,
          "device_bytes": torch.cuda.memory_allocated()})
    check(prepared == dryrun.halves_bytes(diffusion.token_weights(params)),
          f"{prepared} prepared bytes")
    memory = synthetic.text_memory(torch.Generator().manual_seed(SEED + 48),
                                   1, VIDEO_MEM, cfg.cond_dim)
    _reset_counts(ops)
    adaptive, slice_s = video_slice_phase(cfg, params, ops, memory)
    launches = _launched(ops)
    check(launches["ssd"] == 0, "SSD launched in the video slice")
    video_fused_phase(cfg, params, ops, adaptive, memory)
    profile = memory_profile_phase("video_profile", SEED + 46, cfg,
                                   diffusion, params, ops, memory)
    for name, key in (("flash_attention", "flash_attention"),
                      ("linear", "linear")):
        kernels[name]["video_launches"] = launches[key]
    kernels["flash_attention"]["video"] = attn_shapes
    kernels["linear"]["video"] = {**products,
                                  "profile_linear_ms": profile["linear_ms"]}
    del params, adaptive
    gemm.release()
    gc.collect()
    emit({"phase": "video", "seconds": time.perf_counter() - t_phase,
          "slice_s": slice_s, "launches": launches})


# ---------------------------------------------------------------------------
# The audio slice: Stable-Audio-Open at full width
# ---------------------------------------------------------------------------

# the paper's Table 3 protocol (benchmarks/table3_audio.py): DPM-Solver++(3M)
# SDE at 100 steps, CFG 7.0, calibration on 8 samples, α ∈ {0.15, 0.30};
# a 128-token memory, the max_length of Stable Audio Open 1.0's T5 prompt
# conditioner
AUDIO_STEPS, AUDIO_CFG, AUDIO_MEM, AUDIO_CALIB = 100, 7.0, 128, 8
# Stable-Audio-Open's depth on the card, of 24: all 24 until the codebook
# and prefix LM phases came, which this cut pays for (the host bounds its
# steps, so their time follows the block count)
AUDIO_BLOCKS = 12
AUDIO_SMOOTH = "smoothcache:alpha=0.15"
AUDIO_ADAPTIVE = "adaptive:base=smoothcache(alpha=0.15),tau=0.3"


def audio_kernel_phase(fa, ref, gemm, peaks, cfg):
    """The attention kernel at the audio path's shapes — self (B, 216, 24,
    64) over 216 keys (ragged against the 32-key tile) and cross over the
    128-token memory — at B = 2 and 8 (1 and 4 requests under CFG):
    against the plain version (≤ 5e-5), two launches bitwise, device ms
    beside the bound and SDPA's.  Every product shape of a forward for 1–4
    requests, each through its call site's variant, against cuBLAS f32 (≤
    5e-5 of the output's scale) and an f64 product (≤ ``F64_LIMIT``); each
    row bitwise against the product of fewer requests' rows and of permuted rows; device ms of one B = 2
    forward's products beside their bound and cuBLAS's."""
    import torch.nn.functional as F
    from repro_torch.core.diffusion import token_shape
    from repro_torch.kernels.products import gemms
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 60)
    spec = cfg.stages[0].unit[0].mixer
    h, d = spec.num_heads, spec.head_dim
    n_tok = token_shape(cfg)[0]

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    attn = {}
    for name, lk in (("self", n_tok), ("cross", AUDIO_MEM)):
        for b in (2, 8):
            q, k, v = rand(b, n_tok, h, d), rand(b, lk, h, d), rand(b, lk, h, d)
            out = fa.flash_attention_cuda(q, k, v, causal=False)
            again = fa.flash_attention_cuda(q, k, v, causal=False)
            want = ref.flash_attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            check(bool(torch.allclose(out, want, atol=5e-5, rtol=5e-5)),
                  f"audio {name} attention at B = {b} vs plain: max abs "
                  f"err {err}")
            check(bool(torch.equal(out, again)),
                  f"two launches of audio {name} attention at B = {b} "
                  "differ")
            flops, nbytes, unit = fa.work(b, n_tok, lk, h, h, d)
            bound, by = kernel_bound(peaks, (flops, nbytes, unit))
            qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            row = {"shape": [b, n_tok, lk, h, d], **fa.plan(q, k, v),
                   "max_abs_err": err, "bound_ms": bound, "bound_by": by,
                   "flops": flops, "bytes": nbytes,
                   "ms": device_ms(lambda: fa.flash_attention_cuda(
                       q, k, v, causal=False)),
                   "plain_ms": device_ms(lambda: ref.flash_attention_ref(
                       q, k, v, causal=False), iters=10),
                   "library_ms": device_ms(
                       lambda: F.scaled_dot_product_attention(qt, kt, vt))}
            row["bound_share"] = bound / row["ms"]
            attn[f"{name}_b{b}"] = row
    emit({"phase": "audio_attention", "limit": 5e-5, "shapes": attn})

    def inputs(m, k, n, bias):
        x = rand(m, k)
        return x, rand(k, n) / k ** 0.5, rand(n) if bias else None

    sweep, worst = [], 0.0
    for requests in (1, 2, 3, 4):
        for m, k, n, bias, _, rows in gemms(cfg, 2 * requests, AUDIO_MEM):
            x, w, b = inputs(m, k, n, bias)
            out = gemm.linear_cuda(x, w, b, rows=rows)
            want = ref.linear_ref(x, w, b)
            # the exact product, to tell the kernel's error from cuBLAS's
            exact = ref.linear_ref(x.double(), w.double(),
                                   None if b is None else b.double())
            torch.cuda.synchronize()
            rel = float((out - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
            scale = float(exact.abs().max())
            sweep.append({"requests": requests, "m": m, "k": k, "n": n,
                          "rows": rows, "rel_max_err": rel,
                          "kernel_vs_f64": float((out - exact).abs().max())
                          / scale,
                          "plain_vs_f64": float((want - exact).abs().max())
                          / scale})
            check(rel <= 5e-5, f"audio product {sweep[-1]}")
            check(sweep[-1]["kernel_vs_f64"] <= F64_LIMIT,
                  f"audio product against f64 {sweep[-1]}")
            gemm.release()
    stable = {}
    for m, k, n, _, _, rows in gemms(cfg, 8, AUDIO_MEM):
        per_request = m // 8
        x, w, _ = inputs(m, k, n, False)
        full = gemm.linear_cuda(x, w, rows=rows)
        diffs = {str(r): float((gemm.linear_cuda(
            x[:2 * r * per_request].contiguous(), w, rows=rows)
            - full[:2 * r * per_request]).abs().max()) for r in (1, 2, 3)}
        perm = torch.randperm(m, generator=gen).cuda()
        diffs["permuted"] = float((gemm.linear_cuda(x[perm].contiguous(), w,
                                                    rows=rows)
                                   - full[perm]).abs().max())
        stable[f"{k}x{n}:{rows}"] = {"plan": gemm.plan(k, n, rows)["tile"],
                                     **diffs}
        gemm.release()
    emit({"phase": "audio_products", "limit": 5e-5, "f64_limit": F64_LIMIT,
          "max_rel_err": worst,
          "cases": sweep, "rows_max_abs_vs_full": stable})
    check(all(v == 0.0 for row in stable.values()
              for key, v in row.items() if key != "plan"),
          f"an audio product's row changes with the batch: {stable}")

    products = []
    for m, k, n, bias, calls, rows in gemms(cfg, 2, AUDIO_MEM):
        x, w, b = inputs(m, k, n, bias)
        products.append({**product_times(gemm, ref, peaks, x, w, b, rows,
                                         reps=SWEEP_REPS),
                         "calls": calls})
        gemm.release()
    summary = {"products": products, "max_rel_err": worst,
               **{f"forward_{key}": sum(p[key] * p["calls"]
                                        for p in products)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}}
    emit({"phase": "audio_product_times", "batch": 2, **summary,
          "seconds": time.perf_counter() - t_phase})
    return attn, summary


def audio_cut(cfg, random_params, blocks=2):
    """The full-width config cut to ``blocks`` blocks, and seeded weights
    for it on the CPU and on the card."""
    from repro_torch.config import Stage
    from repro_torch.models.transformer import tree_map
    cut = cfg.replace(stages=(Stage(unit=cfg.stages[0].unit,
                                    repeat=blocks),))
    p_cpu = random_params(torch.Generator().manual_seed(SEED + 61), cut,
                          device="cpu")
    return cut, p_cpu, tree_map(lambda a: a.cuda(), p_cpu)


def audio_cross_check_phase(cfg, diffusion, gemm, random_params):
    """At full width (216 tokens, d 1536, a 128-token memory 768 wide) and
    a depth cut to 2 blocks: a card forward against a CPU forward (one
    request under CFG, the second half with a zero memory), then one
    8-step DPM++(3M) SDE sample from one seed on the card and on the CPU —
    the latent and every step's noise are drawn on the CPU from the seed,
    so the two runs see the same noise.  Both ≤ 1e-4 of the CPU's scale."""
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.data import synthetic
    cut, p_cpu, p_gpu = audio_cut(cfg, random_params)
    gen = torch.Generator().manual_seed(SEED + 62)
    x = torch.randn((1,) + cut.latent_shape, generator=gen).repeat(2, 1, 1)
    mem = synthetic.text_memory(gen, 1, AUDIO_MEM, cut.cond_dim,
                                device="cpu")
    mem2 = torch.cat([mem, torch.zeros_like(mem)])
    t = torch.tensor([700.0, 700.0])
    (pred_gpu, _), gpu_s = _timed(lambda: diffusion.apply(
        cut, p_gpu, x.cuda(), t.cuda(), memory=mem2.cuda()))
    t0 = time.perf_counter()
    pred_cpu, _ = diffusion.apply(cut, p_cpu, x, t, memory=mem2)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(pred_cpu).all()), "CPU prediction not finite")
    scale = float(pred_cpu.abs().max())
    rel = float((pred_gpu.cpu() - pred_cpu).abs().max()) / scale
    emit({"phase": "audio_cross_check", "blocks": cut.num_layers,
          "tokens": diffusion.token_shape(cut)[0], "memory": AUDIO_MEM,
          "batch": 2, "max_abs_pred": scale, "rel_max_err": rel,
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(rel <= 1e-4, f"audio card vs CPU forward: relative error {rel}")

    steps = 8
    out = {}
    for side, dev, params, m in (("gpu", "cuda", p_gpu, mem.cuda()),
                                 ("cpu", "cpu", p_cpu, mem)):
        ex = SmoothCacheExecutor(cut, solvers.dpmpp_3m_sde(steps),
                                 cfg_scale=AUDIO_CFG, device=dev)
        out[side], out[side + "_s"] = _timed(lambda: ex.sample(
            params, torch.Generator().manual_seed(SEED + 63), 1, memory=m))
    scale = float(out["cpu"].abs().max())
    rel = float((out["gpu"].cpu() - out["cpu"]).abs().max()) / scale
    emit({"phase": "audio_sample_cross_check", "blocks": cut.num_layers,
          "solver": "dpmpp_3m_sde", "steps": steps, "cfg": AUDIO_CFG,
          "max_abs_x": scale, "rel_max_err": rel, "limit": 1e-4,
          "gpu_s": out["gpu_s"], "cpu_s": out["cpu_s"]})
    check(bool(torch.isfinite(out["cpu"]).all()), "CPU sample not finite")
    check(rel <= 1e-4, f"audio card vs CPU sample: relative error {rel}")
    gemm.release()          # the cut model's prepared halves


def audio_slice_phase(cfg, params, ops, memory):
    """The full-width Stable-Audio-Open slice, Table 3's protocol:
    DPM-Solver++(3M) SDE 100, CFG 7.0, a 128-token memory.  Calibrate on 8
    samples (B = 16) under the adaptive policy (its base is
    ``smoothcache:alpha=0.15``), save the artifact, load it strictly into
    fresh pipelines, answer 1 request (B = 2) under ``no_cache``,
    ``smoothcache:alpha=0.15`` / ``0.30`` and ``static:n=2``: every latent
    finite, attention launches = Σ over steps of 24 per computed ``attn``
    and ``xattn``, linear launches = Σ over steps of 5 + Σ over the 24
    blocks of (1 + 4 per computed attn + 4 per computed xattn + 3 per
    computed ffn); segmented ≡ eager bitwise; one adaptive ``generate`` on
    the host loop (one decision sync per step past the first); the fused
    path and ``split_run`` raise.  Walls, compute fractions, rel-L1 to
    ``no_cache``, peak device memory.  Returns the artifact and, for the
    snapshot check, the ``static:n=2`` run's plan and latent and the
    adaptive pipeline with its run's latent."""
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.core import solvers
    from repro_torch.data import synthetic
    types = cfg.layer_types()
    calib_mem = synthetic.text_memory(
        torch.Generator().manual_seed(SEED + 64), AUDIO_CALIB, AUDIO_MEM,
        cfg.cond_dim)

    def pipe(policy):
        return DiffusionPipeline(cfg, solvers.dpmpp_3m_sde(AUDIO_STEPS),
                                 policy, cfg_scale=AUDIO_CFG)

    calib = pipe(AUDIO_ADAPTIVE)
    torch.cuda.reset_peak_memory_stats()
    art, calib_s = _timed(lambda: calib.calibrate(
        params, torch.Generator().manual_seed(SEED + 65), AUDIO_CALIB,
        cond_args={"memory": calib_mem}))
    check(sorted(art.curves) == sorted(types), f"curves {sorted(art.curves)}")
    emit({"phase": "audio_calibrate", "samples": AUDIO_CALIB,
          "batch": 2 * AUDIO_CALIB, "steps": AUDIO_STEPS,
          "seconds": calib_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "compute_fraction": calib.compute_fraction(),
          "lag1_err_mid": {t: float(c[AUDIO_STEPS // 2, 1])
                           for t, c in art.curves.items()}})
    with tempfile.TemporaryDirectory() as tmp:
        path = calib.save_artifact(str(Path(tmp) / "sao_dpm100.cache.json"))
        serve = pipe(AUDIO_SMOOTH)
        serve.load_artifact(path, strict=True)
        adaptive = pipe(AUDIO_ADAPTIVE)
        adaptive.load_artifact(path, strict=True)
    check(serve.schedule.to_json() == art.schedule.to_json()
          == serve.schedule_for(AUDIO_SMOOTH).to_json(),
          "the artifact's schedule is not smoothcache:alpha=0.15's")

    runs, latents = [], {}
    torch.cuda.reset_peak_memory_stats()
    for name, sch in (("no_cache", None), (AUDIO_SMOOTH, serve.schedule),
                      ("smoothcache:alpha=0.30",
                       serve.schedule_for("smoothcache:alpha=0.30")),
                      ("static:n=2", serve.schedule_for("static:n=2"))):
        kw = {} if name == AUDIO_SMOOTH else {"schedule": sch}
        steps = [[t for t in types if sch is None or not sch.skip[t][s]]
                 for s in range(AUDIO_STEPS)]
        want_attn = sum(attn_calls(cfg, c) for c in steps)
        want_linear = sum(linear_calls(cfg, c) for c in steps)
        counts = graph_counts(ops, serve.executor)
        x, wall = _timed(lambda: serve.generate(
            params, torch.Generator().manual_seed(SEED + 66), 1,
            memory=memory, **kw))
        counts = graph_counts(ops, serve.executor, counts)
        attn = counts["replayed"]["flash_attention"]
        linear = counts["replayed"]["linear"]
        latents[name] = x
        frac = (1.0 if sch is None else float(sum(
            sch.compute_fraction(t) for t in types) / len(types)))
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite latents")
        check(attn == want_attn, f"{name}: {attn} attention launches, "
              f"expected {want_attn}")
        check(linear == want_linear, f"{name}: {linear} linear launches, "
              f"expected {want_linear}")
        check(counts["calls"] == counts["warmup"],
              f"{name}: calls {counts['calls']} besides the warm-ups "
              f"{counts['warmup']}")
        base = latents["no_cache"]
        runs.append({"run": name, "requests": 1, "wall_s": wall,
                     "compute_fraction": frac, "attn_launches": attn,
                     "linear_launches": linear,
                     "new_graphs": counts["new_graphs"],
                     "linear_per_full_step": linear_calls(cfg, types),
                     "skipped_steps": {t: int(sch.skip[t].sum())
                                       for t in types} if sch is not None
                     else None,
                     "rel_l1_to_no_cache": float((x - base).abs().sum()
                                                 / base.abs().sum())})
        emit({"phase": "audio_generate", **runs[-1]})
    eager, eager_s = _timed(lambda: serve.generate(
        params, torch.Generator().manual_seed(SEED + 66), 1, memory=memory,
        compiled=False))
    same = bool(torch.equal(eager, latents[AUDIO_SMOOTH]))
    emit({"phase": "audio_segmented_vs_eager", "run": AUDIO_SMOOTH,
          "bitwise_equal": same, "eager_wall_s": eager_s,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(same, "audio: segmented and eager latents differ")

    ex = adaptive.executor
    syncs = ex.host_sync_count
    before = dict(ops.LAUNCHES)
    (xa, decisions), wall = _timed(lambda: adaptive.generate(
        params, torch.Generator().manual_seed(SEED + 66), 1, memory=memory,
        return_decisions=True))
    row = {"phase": "audio_adaptive", "route": "host loop",
           "wall_s": wall, "decision_syncs": ex.host_sync_count - syncs,
           "attn_launches": ops.LAUNCHES["flash_attention"]
           - before["flash_attention"],
           "skipped": {t: sum(t in d for d in decisions) for t in types},
           "rel_l1_to_no_cache": float(
               (xa - latents["no_cache"]).abs().sum()
               / latents["no_cache"].abs().sum())}
    emit(row)
    check(bool(torch.isfinite(xa).all()), "adaptive: non-finite latents")
    check(row["decision_syncs"] == AUDIO_STEPS - 1,
          f"{row['decision_syncs']} decision syncs in a host-loop run")
    refused = {}
    try:
        ex.sample_adaptive_fused(
            params, torch.Generator().manual_seed(SEED), 1,
            schedule=adaptive.schedule, tau=adaptive.policy.tau,
            proxy_map=adaptive.proxy_map, memory=memory)
    except ValueError as e:
        refused["fused"] = "not scannable" in str(e)
    rs = ex.start_run(params, torch.Generator().manual_seed(SEED), 1,
                      plan=serve.plan, memory=memory)
    try:
        ex.split_run(rs, [[0]])
    except ValueError as e:
        refused["split_run"] = "stochastic" in str(e)
    emit({"phase": "audio_refusals", **refused})
    check(refused == {"fused": True, "split_run": True},
          f"the fused path or split_run did not refuse: {refused}")
    static = serve.schedule_for("static:n=2")
    return art, {"plan": (serve.executor.plan_for(static),
                          latents["static:n=2"]),
                 "adaptive": (adaptive, xa)}


def audio_serve_phase(cfg, params, ops, art, memory, runs):
    """A drain of 4 requests with prompts (the engine's ``text_encoder``
    the 128-token memory stub) over two entries — ``static:n=2`` and the
    adaptive artifact on the host loop — ``max_batch`` 2, with
    ``continuous=True`` joining nothing (the solver is stochastic); both
    served batches replayed through ``generate`` bitwise.  Then a
    stochastic run's snapshot: the slice's ``static:n=2`` run and its
    host-loop run (``runs``: plan or pipeline, and the uninterrupted
    latent), each started again, exported after 3 steps, saved,
    restored, imported on a fresh executor and finished — bitwise the
    uninterrupted run."""
    import functools
    from repro_torch import serve
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.data import synthetic
    t_phase = time.perf_counter()
    encoder = functools.partial(synthetic.prompt_memory, length=AUDIO_MEM,
                                dim=cfg.cond_dim)

    def solver():
        return solvers.dpmpp_3m_sde(AUDIO_STEPS)

    def executor():
        return SmoothCacheExecutor(cfg, solver(), cfg_scale=AUDIO_CFG)

    store = serve.ArtifactStore(cfg, solver(), cfg_scale=AUDIO_CFG)
    store.add_policy("static:n=2", "static:n=2")
    store.add_artifact(AUDIO_ADAPTIVE, art)
    ex = executor()
    eng = serve.ServeEngine(ex, params, store, max_batch=2, max_inflight=2,
                            adaptive_chunk=4, continuous=True,
                            text_encoder=encoder)
    prompts = ["rain on a tin roof", "a violin tuning", "waves at night",
               "a crowd applauding"]
    before = _launched(ops)
    eng.submit(*[serve.Request(rid=i, seed=500 + i, prompt=prompts[i],
                               policy=(AUDIO_ADAPTIVE if i % 2
                                       else "static:n=2"))
                 for i in range(4)])
    results, wall = _timed(eng.run_until_drained)
    launched = _launched(ops)
    launches = {k: launched[k] - before[k] for k in ("flash_attention",
                                                      "linear")}
    check(sorted(results) == [0, 1, 2, 3], f"served {sorted(results)}")
    check(eng.metrics.joins == 0, "a stochastic run took a join")
    replays = {}
    for rec in eng.records:
        pipe = DiffusionPipeline(cfg, solver(), rec.group,
                                 cfg_scale=AUDIO_CFG)
        if rec.group == AUDIO_ADAPTIVE:
            pipe.load_artifact(art, strict=True)
        x = pipe.generate(params, serve.batch_generator(rec.seeds),
                          rec.bucket, memory=encoder(list(rec.prompts)))
        replays[rec.group] = all(
            bool(torch.equal(torch.from_numpy(results[rid]), x[j].cpu()))
            for j, rid in enumerate(rec.rids))
    emit({"phase": "audio_serve", "requests": 4, "entries": 2,
          "wall_s": wall, "batches": len(eng.records),
          "decision_syncs": ex.host_sync_count, "joins": eng.metrics.joins,
          "launches": launches, "replay_bitwise": replays})
    check(set(replays) == {"static:n=2", AUDIO_ADAPTIVE}
          and all(replays.values()),
          f"a served audio batch differs from its generate: {replays}")

    plan, want_plan = runs["plan"]
    ad, want_adaptive = runs["adaptive"]
    ad_kw = dict(schedule=ad.schedule, tau=ad.policy.tau,
                 proxy_map=ad.proxy_map, k_max=ad.policy.k_max)

    def gen():
        return torch.Generator().manual_seed(SEED + 66)

    kinds = {"plan": (lambda e: e.start_run(params, gen(), 1, plan=plan,
                                            memory=memory),
                      lambda e, rs: e.advance_run(params, rs),
                      dict(plan=plan), want_plan),
             "adaptive": (lambda e: e.start_adaptive_run(
                              params, gen(), 1, memory=memory, **ad_kw),
                          lambda e, rs: e.advance_adaptive_run(params, rs),
                          ad_kw, want_adaptive)}
    snapshots = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, (start, advance, import_kw, whole) in kinds.items():
            e1 = executor()
            rs = start(e1)
            for _ in range(3):
                rs = advance(e1, rs)
            k, arrays, static = e1.export_run(rs)
            f = str(Path(tmp) / f"{kind}.ckpt")
            ckpt_io.save(f, arrays, {"static": static})
            restored, meta = ckpt_io.restore(f)
            e2 = executor()
            rs2 = e2.import_run(params, k, restored, meta["static"],
                                **import_kw)
            while not rs2.done:
                rs2 = advance(e2, rs2)
            snapshots[kind] = {"step": int(static.get("step",
                                                      static.get("run_index",
                                                                 0))),
                               "state_none": [key for key, v in
                                              arrays["state"].items()
                                              if v is None],
                               "bitwise_equal": bool(torch.equal(rs2.x,
                                                                 whole))}
    emit({"phase": "audio_snapshot", "runs": snapshots,
          "seconds": time.perf_counter() - t_phase})
    check(all(r["bitwise_equal"] for r in snapshots.values()),
          f"a restored stochastic run differs: {snapshots}")
    return launches


def audio_attention_path(cfg, fa, params, memory):
    """How the kernel computes the q/k/v that the first audio block's self-
    and cross-attention make at B = 2 (after RoPE for self-attention)."""
    from repro_torch.models import attention, layers as L
    from repro_torch.models.transformer import tree_map
    block = tree_map(lambda a: a[0], params["backbone"]["stages"][0][0])
    unit = cfg.stages[0].unit[0]
    x = torch.randn(2, cfg.latent_shape[0], cfg.d_model, device="cuda")
    q, k, v = attention._gqa_qkv(unit.mixer, block["mixer"], x)
    pos = torch.arange(x.shape[1], device="cuda")[None, :]
    angles = L.rope_angles(pos, unit.mixer.head_dim, unit.mixer.rope_theta)
    q, k = (L.apply_rope(a, pos, angles=angles) for a in (q, k))
    mem = torch.cat([memory, torch.zeros_like(memory)])
    return {"self": fa.plan(q, k, v),
            "cross": fa.plan(*attention._gqa_qkv(unit.cross, block["cross"],
                                                 x, mem))}


def audio_phase(peaks, kernels):
    """The Stable-Audio-Open text-to-audio path at full width
    (``AUDIO_BLOCKS`` = 12 of its 24 blocks, d 1536, 216 latent rows, a
    128-token T5 memory stub 768 wide, DPM-Solver++(3M) SDE 100, CFG
    7.0), after every other phase, on weights of its own drawn on the
    card.  The host bounds its runs (~43 ms a step at 24 blocks on an
    H100 80GB HBM3 at 700 W), so the phase's time follows its depth."""
    from repro_torch import configs
    from repro_torch.core import diffusion
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve_diffusion import random_params
    from repro_torch.kernels.products import lm_cut
    t_phase = time.perf_counter()
    cfg = lm_cut(configs.get("stable-audio-open"), AUDIO_BLOCKS)
    attn_shapes, products = audio_kernel_phase(fa, ref, gemm, peaks, cfg)
    audio_cross_check_phase(cfg, diffusion, gemm, random_params)
    t0 = time.perf_counter()
    # drawn on the card (a CPU draw of these widths took ~10-30 s)
    params = random_params(torch.Generator(device="cuda").manual_seed(
        SEED + 69), cfg, device="cuda")
    prepared = diffusion.prepare_linear(params)
    torch.cuda.synchronize()
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params)),
          "linear_prepared_bytes": prepared,
          "device_bytes": torch.cuda.memory_allocated()})
    check(prepared == dryrun.halves_bytes(diffusion.token_weights(params)),
          f"{prepared} prepared bytes")
    memory = synthetic.text_memory(torch.Generator().manual_seed(SEED + 70),
                                   1, AUDIO_MEM, cfg.cond_dim)
    path = audio_attention_path(cfg, fa, params, memory)
    emit({"phase": "audio_attention_path", **path})
    check(all(p == {"arith": "3xtf32-mma.sync", "load": "cp.async"}
              for p in path.values()),
          f"the audio path's attention takes {path}")
    _reset_counts(ops)
    t0 = time.perf_counter()
    art, runs = audio_slice_phase(cfg, params, ops, memory)
    slice_s = time.perf_counter() - t0
    launches = _launched(ops)
    check(launches["ssd"] == 0, "SSD launched in the audio slice")
    check(all(launches["linear_" + rows] > 0 for rows in gemm.ROWS),
          f"a linear variant never launched in the audio slice: {launches}")
    serve_launches = audio_serve_phase(cfg, params, ops, art, memory, runs)
    profile = memory_profile_phase("audio_profile", SEED + 68, cfg,
                                   diffusion, params, ops, memory)
    for name in ("flash_attention", "linear"):
        kernels[name]["audio_launches"] = launches[name]
        kernels[name]["audio_serve_launches"] = serve_launches[name]
    kernels["flash_attention"]["audio"] = attn_shapes
    kernels["linear"]["audio"] = {**products,
                                  "profile_linear_ms": profile["linear_ms"]}
    del params
    gemm.release()
    gc.collect()
    emit({"phase": "audio", "seconds": time.perf_counter() - t_phase,
          "slice_s": slice_s, "launches": launches})


# ---------------------------------------------------------------------------
# Training (phases 27–29)
# ---------------------------------------------------------------------------

TRAIN_DIT_BATCH, TRAIN_DIT_STEPS, TRAIN_DIT_LR = 16, 12, 1e-4
TRAIN_DIT_CKPT_AFTER = 6          # save after this step, resume its next
TRAIN_CHECK_BLOCKS = 2
TRAIN_GEN_STEPS = 10              # DDIM steps of the generate after training
TRAIN_DIT_BUDGET_S = 80
QUICKSTART_BUDGET_S = 15
TRAIN_LM_BATCH, TRAIN_LM_TOKENS, TRAIN_LM_STEPS = 4, 512, 5
TRAIN_LM_CHECK_TOKENS = 64
TRAIN_LM_BUDGET_S = 23
TRAIN_SPANS = ("train.forward", "train.backward", "train.optimizer")
TRAIN_RANGES = TRAIN_SPANS + ("plain_backward.linear",
                               "plain_backward.flash_attention")


def _timed_step(timing, fn):
    """One training step ``fn()`` → (loss, metrics), run with its spans'
    CUDA events collected: the row of the step — loss, wall s, forward /
    backward / optimizer device ms, and whether every leaf's gradient was
    finite and nonzero (from the optimizer's ``grad_sq_norms``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timing.spans() as spans:
        loss, metrics = fn()
    ms = timing.span_ms(spans)
    wall = time.perf_counter() - t0
    sq = metrics["grad_sq_norms"].cpu()
    return {"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
            "wall_s": wall,
            **{n.split(".")[1] + "_ms": ms[n] for n in TRAIN_SPANS},
            "leaves": int(sq.numel()),
            "finite": bool(torch.isfinite(sq).all()),
            "nonzero": bool((sq > 0).all())}


def _leaf_rel_errs(want, got):
    """Per leaf, max |Δ| over the leaf's largest |g|."""
    return [float((a - b.to(a.device)).abs().max())
            / max(float(a.abs().max()), 1e-30) for a, b in zip(want, got)]


def _step_profile(fn):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA): wall
    ms; device ms by kernel group, its idle share and top kernels; and
    each of ``TRAIN_RANGES``' device span (the profiler's GPU-side record
    of a ``record_function`` range, summed over its calls), kept apart
    from the kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = _kernel_times(prof)
    ranges = {n: kern.pop(n, [0.0, 0])[0] / 1e3 for n in TRAIN_RANGES}
    groups = {"attention_kernel": 0.0, "linear_kernels": 0.0,
              "cublas": 0.0, "other": 0.0}
    for name, (us, _) in kern.items():
        low = name.lower()
        group = ("attention_kernel" if "attn_fwd" in name
                 else "linear_kernels" if ("gemm_tokens_wgmma" in name
                                           or "gemm_requests_ffma" in name)
                 else "cublas" if any(f in low for f in
                                      ("gemm", "cutlass", "xmma", "gemv"))
                 else "other")
        groups[group] += us / 1e3
    busy = sum(groups.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "groups_ms": groups, "range_spans_ms": ranges,
            "top_kernels": [[k[:80], us / 1e3, n] for k, (us, n) in top]}


def train_attention_row(ref, peaks, shape, causal):
    """The attention kernel's forward at a training shape (b, l, h, kv,
    d): against its plain version, device ms beside its bound, the plain
    version's and SDPA's (``enable_gqa`` where kv < h)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.timing import device_ms
    from repro_torch.launch.roofline import kernel_bound
    b, l, h, kv, d = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 300)
    q = torch.randn((b, l, h, d), generator=g, device="cuda")
    k, v = (torch.randn((b, l, kv, d), generator=g, device="cuda")
            for _ in range(2))
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    err = float((out - ref.flash_attention_ref(q, k, v, causal=causal))
                .abs().max())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, by = kernel_bound(peaks, fa.work(b, l, l, h, kv, d,
                                            causal=causal))
    row = {"shape": [b, l, h, kv, d], "causal": causal,
           "max_abs_err": err, "limit": 5e-5,
           "ms": device_ms(lambda: fa.flash_attention_cuda(
               q, k, v, causal=causal), iters=20),
           "plain_ms": device_ms(lambda: ref.flash_attention_ref(
               q, k, v, causal=causal), iters=5),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=causal, enable_gqa=kv < h), iters=20),
           "bound_ms": bound, "bound_by": by}
    check(err <= 5e-5, f"training attention {shape}: error {err}")
    return row


def train_op_grads_phase(ops, ref):
    """The differentiable ops' mechanism on the card: each op's forward is
    its hand-written kernel, launched once and counted in ``ops.LAUNCHES``,
    and its outputs agree with the plain op's within 1e-4 of each output's
    largest value; its gradient is the plain op's autograd within 1e-4 of
    each input's largest |g|.  The backward recomputes the plain op and
    never reads the kernel's output, so the gradient check holds the
    wiring, not the kernel: the kernels' effect on a gradient is held by
    the card-vs-CPU checks of the training phases.  Linear and attention
    at DiT-XL/2's training shapes (4096 token rows, (16, 256, 16, 72)),
    the SSD and RG-LRU scans at small shapes."""
    import functools
    g = torch.Generator(device="cuda").manual_seed(SEED + 301)

    def r(*s, scale=1.0):
        return scale * torch.randn(s, generator=g, device="cuda")

    def pos(*s, lo=0.1):
        return lo + torch.rand(s, generator=g, device="cuda")

    cases = {
        "linear": (lambda x, w, b: ops.linear(x, w, b), ref.linear_ref,
                   (r(4096, 1152), r(1152, 4608, scale=0.03), r(4608))),
        "flash_attention": (
            lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
            functools.partial(ref.flash_attention_ref, causal=False),
            tuple(r(16, 256, 16, 72) for _ in range(3))),
        "ssd": (lambda *t: ops.ssd(*t, chunk=64),
                functools.partial(ref.ssd_ref, chunk=64),
                (r(2, 256, 4, 32), pos(2, 256, 4, lo=0.01) * 0.1,
                 pos(4, lo=0.5), r(2, 256, 1, 32), r(2, 256, 1, 32))),
        "rglru_scan": (
            lambda *t: ops.rglru_scan(*t[:5], 8.0, t[5]),
            lambda *t: ref.rglru_scan_ref(*t[:5], 8.0, t[5]),
            tuple(r(2, 96, 256) for _ in range(4)) + (r(256), r(2, 256)))}
    rows = {}
    for name, (op, plain, args) in cases.items():
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = ops.LAUNCHES[name]
        outs = op(*leaves)
        launched = ops.LAUNCHES[name] - before
        outs = outs if isinstance(outs, tuple) else (outs,)
        weights = [r(*o.shape) for o in outs]
        got = torch.autograd.grad(
            sum((o * w).sum() for o, w in zip(outs, weights)), leaves)
        plain_leaves = [a.clone().requires_grad_(True) for a in args]
        pouts = plain(*plain_leaves)
        pouts = pouts if isinstance(pouts, tuple) else (pouts,)
        want = torch.autograd.grad(
            sum((o * w).sum() for o, w in zip(pouts, weights)),
            plain_leaves)
        fwd = _leaf_rel_errs([o.detach() for o in pouts],
                             [o.detach() for o in outs])
        errs = _leaf_rel_errs(want, got)
        rows[name] = {"launches": launched, "forward_rel_err": fwd,
                      "grad_rel_err_per_input": errs, "limit": 1e-4}
        check(launched == 1, f"{name}: {launched} kernel launches")
        check(max(fwd) <= 1e-4, f"{name} forward vs plain: {fwd}")
        check(max(errs) <= 1e-4, f"{name} gradient vs plain: {errs}")
    emit({"phase": "train_op_grads", **rows})


def train_dit_cross_check(cfg, params, data, diffusion, adamw):
    """Card against CPU at ``TRAIN_CHECK_BLOCKS`` of DiT-XL/2's blocks on
    the card's weights copied over: the ε loss and every leaf's gradient
    on the whole first training batch (B 16, the timed step's 4096 token
    rows), the same t and noise, within 1e-4 relative (the gradient of
    each leaf to its largest |g|)."""
    from repro_torch.launch.train_dit import batch_at
    from repro_torch.models.transformer import tree_map
    cut, cut_params = dit_cut(cfg, params, TRAIN_CHECK_BLOCKS)
    gpu = tree_map(lambda a: a.clone(), cut_params)
    cpu = tree_map(lambda a: a.cpu(), gpu)
    x0, cond = batch_at(data, 0, "cuda")
    n = TRAIN_DIT_BATCH
    gen = torch.Generator().manual_seed(SEED + 302)
    t = torch.randint(0, 1000, (n,), generator=gen)
    noise = torch.randn((n,) + tuple(cfg.latent_shape), generator=gen)
    sched = diffusion.vp_schedule()

    def run(p, dev):
        return adamw.value_and_grad(lambda q: diffusion.eps_loss(
            cut, q, None, x0.to(dev), sched=sched,
            label=cond["label"].to(dev), t=t.to(dev),
            noise=noise.to(dev)), p)
    (lg, gg), gpu_s = _timed(lambda: run(gpu, "cuda"))
    t0 = time.perf_counter()
    lc, gc_ = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    errs = _leaf_rel_errs(tree_leaves(gc_), tree_leaves(gg))
    emit({"phase": "train_dit_cross_check", "blocks": TRAIN_CHECK_BLOCKS,
          "rows": n, "loss_cpu": float(lc), "loss_rel_err": loss_rel,
          "grad_rel_err_max": max(errs), "leaves": len(errs),
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(loss_rel <= 1e-4, f"training loss card vs CPU: {loss_rel}")
    check(max(errs) <= 1e-4, f"gradients card vs CPU: {max(errs)}")


def train_dit_phase(cfg, params, peaks, kernels):
    """DiT-XL/2 training at every published width and all 28 blocks (phase
    27; budget ``TRAIN_DIT_BUDGET_S``), on the serving phases' weights,
    trained in place after ``gemm.release()`` by the port's
    ``make_dit_step``: ``BlobLatents`` on the card (B 16, 1000 classes),
    the ε loss, AdamW (lr 1e-4, no weight decay, ``cosine_schedule(10,
    12)``), 12 steps.  Before: the ops' mechanism (``train_op_grads``),
    the attention kernel at (16, 256, 16, 72) and the token products at
    4096 rows against their plain versions and timed, a 2-block
    card-vs-CPU loss and gradient on the whole batch.  Each step: loss
    finite, every leaf's gradient finite and nonzero (the step's
    ``grad_sq_norms``; the card's weights have no zero leaf:
    ``full_width_params``), forward / backward / optimizer device ms from
    the step's own spans, prepared and retired bytes; step 2 traced.  The
    peak after step 12 within 1% of the peak after step 3, the prepared
    and retired bytes constant from step 2; a checkpoint after step 6,
    restored into fresh tensors, whose step 7 matches the run's within
    1e-6; ``generate`` on the trained weights bitwise equal to the same,
    on the same pipeline, after ``gemm.release()`` and a fresh
    ``prepare_linear`` (its step graphs captured anew on the fresh
    halves)."""
    import shutil
    from repro_torch.cache import DiffusionPipeline
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import diffusion, solvers
    from repro_torch.data.synthetic import BlobLatents, step_generator
    from repro_torch.kernels import gemm, ops, ref, timing
    from repro_torch.launch.train_dit import batch_at, make_dit_step
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = time.perf_counter() - t_phase

    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()
    train_op_grads_phase(ops, ref)
    mark("op_grads")
    attn = train_attention_row(ref, peaks, (TRAIN_DIT_BATCH, 256, 16, 16,
                                            72), causal=False)
    rows_m = TRAIN_DIT_BATCH * 256
    shapes = sorted({tuple(w.shape)
                     for w in diffusion.token_weights(params)})
    gx = torch.Generator(device="cuda").manual_seed(SEED + 303)
    products = []
    for k, n in shapes:
        x = torch.randn((rows_m, k), generator=gx, device="cuda")
        w = torch.randn((k, n), generator=gx, device="cuda") * k ** -0.5
        want = ref.linear_ref(x, w)
        rel = float((gemm.linear_cuda(x, w, None, rows="tokens") - want)
                    .abs().max()) / float(want.abs().max())
        check(rel <= 5e-5, f"training product ({rows_m}, {k}, {n}): "
              f"relative error {rel}")
        products.append({**product_times(gemm, ref, peaks, x, w, None,
                                         "tokens", iters=10),
                         "rel_max_err": rel})
    emit({"phase": "train_dit_kernels", "attention": attn, "limit": 5e-5,
          "products": [{key: p[key] for key in (
              "m", "k", "n", "rel_max_err", "ms", "plain_ms",
              "plain_same_as", "library_ms", "bound_ms", "bound_by")}
                       for p in products]})
    mark("kernel_times")
    gemm.release()
    data = BlobLatents(cfg.latent_shape, cfg.num_classes, TRAIN_DIT_BATCH)
    train_dit_cross_check(cfg, params, data, diffusion, adamw)
    mark("cross_check")
    opt_cfg = adamw.AdamWConfig(
        lr=TRAIN_DIT_LR, weight_decay=0.0,
        schedule=adamw.cosine_schedule(10, TRAIN_DIT_STEPS))
    dit_step = make_dit_step(cfg, opt_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # the token kernel's halves of every weight, which each step's forward
    # makes anew after the last step's update: their cost a step
    diffusion.prepare_linear(params)
    with torch.no_grad():
        for a in tree_leaves(params):
            a.add_(0.0)       # moves every version, changes no value
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    diffusion.prepare_linear(params)
    ev[1].record()
    torch.cuda.synchronize()
    prepare_ms = ev[0].elapsed_time(ev[1])
    torch.cuda.reset_peak_memory_stats()
    state = adamw.init_state(params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt = os.path.join(tmp, "dit.ckpt")

    n_leaves = len(tree_leaves(params))

    def step(p, s, i):
        x0, cond = batch_at(data, i, "cuda")
        return {"step": i + 1, **_timed_step(timing, lambda: dit_step(
            p, s, x0, step_generator(SEED, i), **cond))}

    rows, profile, want7, saved = [], None, None, {}
    for i in range(TRAIN_DIT_STEPS):
        if i == 2:
            _reset_counts(ops)
        if i == 1:
            got = []
            profile = _step_profile(lambda: got.append(step(params, state,
                                                            i)))
            row = got[0]
        else:
            row = step(params, state, i)
        row.update(prepared_bytes=gemm.prepared_bytes(),
                   retired_bytes=gemm.retired_bytes(),
                   peak_bytes=torch.cuda.max_memory_allocated())
        rows.append(row)
        emit({"phase": "train_dit_step", **row})
        check(math.isfinite(row["loss"]), f"step {i + 1}: loss {row}")
        check(row["leaves"] == n_leaves and row["finite"]
              and row["nonzero"], f"step {i + 1}: a leaf's gradient "
              f"missing, non-finite or zero: {row}")
        if i + 1 == TRAIN_DIT_CKPT_AFTER:
            ckpt_io.save(ckpt, {"params": params, "opt": state},
                         {"step": i + 1}, timings=saved)
        if i == TRAIN_DIT_CKPT_AFTER:
            # on the host: a copy on the card would raise the peak
            want7 = [a.to("cpu", copy=True) for a in tree_leaves(params)]
    mark("steps")
    launches = {k: ops.LAUNCHES[k] / (TRAIN_DIT_STEPS - 2)
                for k in ("linear", "flash_attention")}
    weight_bytes = sum(a.numel() * 4 for a in tree_leaves(params))
    timed = rows[2:]
    med = {k: statistics.median(r[k] for r in timed)
           for k in ("wall_s", "forward_ms", "backward_ms",
                     "optimizer_ms")}
    peak3, peak12 = rows[2]["peak_bytes"], rows[-1]["peak_bytes"]
    held = {(r["prepared_bytes"], r["retired_bytes"]) for r in rows[1:]}
    prepared = rows[-1]["prepared_bytes"]
    emit({"phase": "train_dit_memory", "peak_after_step3": peak3,
          "peak_after_step12": peak12, "weights": weight_bytes,
          "moments": 2 * weight_bytes, "gradients": weight_bytes,
          "halves": prepared, "rest": peak12 - 4 * weight_bytes - prepared,
          "prepared_and_retired_from_step2": sorted(held)})
    check(peak12 <= 1.01 * peak3, f"peak grew: {peak3} → {peak12}")
    check(len(held) == 1, f"prepared / retired bytes moved: {held}")

    # generate on the trained weights: the halves made on demand after the
    # last update against halves made afresh, on one pipeline, whose step
    # graphs hold the halves they captured and are built anew on the new
    pipe = DiffusionPipeline(cfg, solvers.ddim(TRAIN_GEN_STEPS),
                             cfg_scale=1.5, device="cuda")

    def generate():
        return pipe.generate(params, torch.Generator().manual_seed(
            SEED + 304), 2, label=torch.tensor(REQUEST_LABELS[:2],
                                               device="cuda"))

    gen_a = generate()
    built = pipe.executor.graph_count("seg")
    gemm.release()
    diffusion.prepare_linear(params)
    captured = ops.CAPTURED["linear"]
    gen_b = generate()
    same = bool(torch.equal(gen_a, gen_b))
    check(same and bool(torch.isfinite(gen_a).all()),
          "generate after training differs from generate on fresh halves")
    check(built > 0 and pipe.executor.graph_count("seg") == built
          and ops.CAPTURED["linear"] > captured,
          f"{built} step graphs, then {pipe.executor.graph_count('seg')}, "
          "not captured anew on the fresh halves")
    del gen_a, gen_b, state, pipe
    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()
    mark("generate")

    # resume: a fresh tree from the checkpoint, its step 7 against the run's
    t0 = time.perf_counter()
    tree, meta = ckpt_io.restore(ckpt)
    p7 = tree_map(lambda a: a.cuda(), tree["params"])
    s7 = tree_map(lambda a: a.cuda(), tree["opt"])
    del tree
    restore_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(ckpt)
    shutil.rmtree(tmp, ignore_errors=True)
    row7 = step(p7, s7, TRAIN_DIT_CKPT_AFTER)
    errs = _leaf_rel_errs(want7, tree_leaves(p7))
    emit({"phase": "train_dit_resume", "after_step": meta["step"],
          "checkpoint_bytes": ckpt_bytes, "save_timings_s": saved,
          "restore_s": restore_s, "loss_step7": row7["loss"],
          "loss_step7_run": rows[TRAIN_DIT_CKPT_AFTER]["loss"],
          "param_rel_err_max": max(errs), "limit": 1e-6})
    check(max(errs) <= 1e-6, f"resumed step 7 vs the run: {max(errs)}")
    del p7, s7, want7
    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()
    mark("resume")

    summary = {"step_ms_median": 1e3 * med["wall_s"],
               "forward_ms": med["forward_ms"],
               "backward_ms": med["backward_ms"],
               "optimizer_ms": med["optimizer_ms"],
               "prepare_halves_ms": prepare_ms,
               "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
               "peak_gb": peak12 / 1e9, "launches_per_step": launches,
               "profile_step2": profile}
    kernels["flash_attention"]["train_dit"] = {
        **attn, "launches_per_step": launches["flash_attention"]}
    kernels["linear"]["train_dit"] = {
        "rows": rows_m, "ms": sum(p["ms"] for p in products),
        "plain_ms": sum(p["plain_ms"] for p in products),
        "plain_same_as": "library_ms",
        "library_ms": sum(p["library_ms"] for p in products),
        "bound_ms": sum(p["bound_ms"] for p in products),
        "shapes": [[p["k"], p["n"]] for p in products],
        "launches_per_step": launches["linear"]}
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train_dit", "arch": cfg.name, "blocks": cfg.num_layers,
          "batch": TRAIN_DIT_BATCH, "steps": TRAIN_DIT_STEPS, **summary,
          "sections_s": marks, "seconds": seconds,
          "budget_s": TRAIN_DIT_BUDGET_S})
    check(seconds <= TRAIN_DIT_BUDGET_S,
          f"train_dit took {seconds} s of its {TRAIN_DIT_BUDGET_S}")


def quickstart_phase(kernels):
    """The quickstart's protocol on the card (phase 28; budget
    ``QUICKSTART_BUDGET_S``): the smoke DiT trained by ``train_dit`` (150
    steps, B 16, lr 2e-3), a 10-sample calibration through
    ``DiffusionPipeline`` (DDIM 50, CFG 1.5), and the policy sweep against
    ``no_cache`` on 32 samples: ms a batch, speedup, Fréchet distance to
    ``BlobLatents(..., 32, seed=7)``, compute fraction.  Checked: the mean
    of the last 20 losses below the first loss, every sample finite, the
    kernels launched."""
    from repro_torch.kernels import gemm, ops
    from repro_torch.launch import quickstart
    t0 = time.perf_counter()
    _reset_counts(ops)
    out = quickstart.run("cuda", log=lambda line: None)
    launched = _launched(ops)
    launches = {k: launched[k] for k in ("linear", "flash_attention")}
    gemm.release()
    losses = out["losses"]
    last20 = statistics.mean(losses[-20:])
    seconds = time.perf_counter() - t0
    emit({"phase": "quickstart", "arch": "dit-xl-256-smoke",
          "loss_first": losses[0], "loss_last20_mean": last20,
          "policies": out["rows"], "launches": launches,
          "seconds": seconds, "budget_s": QUICKSTART_BUDGET_S})
    check(last20 < losses[0], f"loss {losses[0]} → {last20}")
    check(all(r["finite"] for r in out["rows"]), "a sample not finite")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    check(seconds <= QUICKSTART_BUDGET_S,
          f"quickstart took {seconds} s of its {QUICKSTART_BUDGET_S}")
    kernels["flash_attention"]["quickstart_launches"] = launches[
        "flash_attention"]
    kernels["linear"]["quickstart_launches"] = launches["linear"]


def train_lm_phase(peaks, kernels):
    """InternVL2-1B training at every published width and all 24 blocks
    (phase 29; budget ``TRAIN_LM_BUDGET_S``): ``make_train_step`` at B 4 ×
    (256 patch embeddings + 512 tokens) from ``TokenStream``, AdamW at lr
    3e-4 with the reference CLI's ``cosine_schedule(10, steps · 10)``, no
    remat, 5 steps on weights drawn on the card.  The attention kernel at
    the training shape (4, 768, 14 over 2, 64), causal, timed; a 2-block
    card-vs-CPU loss and gradient (1 × (256 + 64)); each step every leaf's
    gradient finite and nonzero (the step's ``grad_sq_norms``); the peak
    after step 5 within 1% of the peak after step 2; ms a step with its
    forward / backward / optimizer split from the step's own spans,
    tokens / s, step 2 traced."""
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStream, vit_patch_embeds
    from repro_torch.kernels import gemm, ops, ref, timing
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import programs, serve
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    cfg = configs.get("internvl2-1b")
    plen = cfg.num_prefix_embeds
    m = cfg.stages[0].unit[0].mixer
    attn = train_attention_row(ref, peaks, (
        TRAIN_LM_BATCH, plen + TRAIN_LM_TOKENS, m.num_heads,
        m.num_kv_heads, m.head_dim), causal=True)
    params = serve.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 320), cfg,
        device="cuda")
    weight_bytes = sum(a.numel() * 4 for a in tree_leaves(params))
    prefix = vit_patch_embeds(torch.Generator().manual_seed(SEED + 321),
                              TRAIN_LM_BATCH, plen, cfg.d_model,
                              device="cuda")

    # card against CPU at 2 blocks, one sequence of 64 tokens
    cut = lm_cut(cfg, TRAIN_CHECK_BLOCKS)
    gpu = tree_map(lambda a: a.clone(), {**params, "stages": [tuple(
        tree_map(lambda a: a[:TRAIN_CHECK_BLOCKS], u)
        for u in params["stages"][0])]})
    cpu = tree_map(lambda a: a.cpu(), gpu)
    toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_LM_CHECK_TOKENS + 1),
                         generator=torch.Generator().manual_seed(SEED + 322))

    def run(p, dev):
        return adamw.value_and_grad(lambda q: programs.lm_loss(
            cut, q, toks[:, :-1].to(dev), toks[:, 1:].to(dev),
            prefix_embeds=prefix[:1].to(dev), remat=False), p)
    (lg, gg), gpu_s = _timed(lambda: run(gpu, "cuda"))
    t0 = time.perf_counter()
    lc, gcpu = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    errs = _leaf_rel_errs(tree_leaves(gcpu), tree_leaves(gg))
    emit({"phase": "train_lm_cross_check", "arch": cfg.name,
          "blocks": TRAIN_CHECK_BLOCKS, "tokens": TRAIN_LM_CHECK_TOKENS,
          "prefix": plen, "loss_cpu": float(lc), "loss_rel_err": loss_rel,
          "grad_rel_err_max": max(errs), "leaves": len(errs),
          "limit": 1e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(loss_rel <= 1e-4, f"LM loss card vs CPU: {loss_rel}")
    check(max(errs) <= 1e-4, f"LM gradients card vs CPU: {max(errs)}")
    del gpu, cpu, gg, gcpu
    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()

    opt_cfg = adamw.AdamWConfig(
        lr=3e-4, schedule=adamw.cosine_schedule(10, TRAIN_LM_STEPS * 10))
    train_step = programs.make_train_step(cfg, opt_cfg, remat=False)
    state = adamw.init_state(params)
    stream = TokenStream(cfg.vocab_size, TRAIN_LM_TOKENS, TRAIN_LM_BATCH,
                         seed=SEED)
    n_leaves = len(tree_leaves(params))
    rows, profile = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_LM_STEPS):
        toks, tgts = stream.batch_at(i, device="cuda")
        if i == 2:
            _reset_counts(ops)

        def one():
            _, _, loss, metrics = train_step(params, state, toks, tgts,
                                             prefix_embeds=prefix)
            return loss, metrics
        if i == 1:
            got = []
            profile = _step_profile(lambda: got.append(
                _timed_step(timing, one)))
            row = got[0]
        else:
            row = _timed_step(timing, one)
        row = {"step": i + 1, **row,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        rows.append(row)
        emit({"phase": "train_lm_step", **row})
        check(math.isfinite(row["loss"]) and row["leaves"] == n_leaves
              and row["finite"] and row["nonzero"], f"LM step {i + 1}: {row}")
    launches = {k: ops.LAUNCHES[k] / (TRAIN_LM_STEPS - 2)
                for k in ("linear", "flash_attention")}
    med = {k: statistics.median(r[k] for r in rows[2:])
           for k in ("wall_s", "forward_ms", "backward_ms", "optimizer_ms")}
    step_s = med["wall_s"]
    peak2, peak5 = rows[1]["peak_bytes"], rows[-1]["peak_bytes"]
    check(peak5 <= 1.01 * peak2, f"LM peak grew: {peak2} → {peak5}")
    prepared = gemm.prepared_bytes()
    del params, state, prefix
    gemm.release()
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    kernels["flash_attention"]["train_lm"] = {
        **attn, "launches_per_step": launches["flash_attention"]}
    kernels["linear"]["train_lm_launches_per_step"] = launches["linear"]
    emit({"phase": "train_lm", "arch": cfg.name, "blocks": cfg.num_layers,
          "batch": TRAIN_LM_BATCH, "prefix": plen,
          "tokens": TRAIN_LM_TOKENS, "steps": TRAIN_LM_STEPS,
          "step_ms_median": 1e3 * step_s,
          **{k: med[k] for k in ("forward_ms", "backward_ms",
                                 "optimizer_ms")},
          "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_TOKENS / step_s,
          "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
          "peak_gb": peak5 / 1e9, "weight_bytes": weight_bytes,
          "halves": prepared, "launches_per_step": launches,
          "profile_step2": profile, "seconds": seconds,
          "budget_s": TRAIN_LM_BUDGET_S})
    check(seconds <= TRAIN_LM_BUDGET_S,
          f"train_lm took {seconds} s of its {TRAIN_LM_BUDGET_S}")


ROOFLINE_BUDGET_S = 10


def program_counts(schedules, requests, steps, lm_shape, cache_len,
                   qwen3_blocks):
    """The work of the two programs the roofline phase reads, counted on
    the meta device (``launch/op_analysis.py``: nothing allocated, nothing
    launched), in a process of its own that ``main`` starts before the
    video phase: running the ~200 k ATen ops of three 50-step samplers on
    meta takes 4–11 s of host time, which the device-bound video phase
    hides.  DiT-XL/2 at 28 of 28 blocks: ``build_sampler_fn`` of each
    schedule (JSON; None: ``no_cache``) at ``requests`` requests under CFG
    1.5, DDIM ``steps``; Qwen3-14B at ``qwen3_blocks`` blocks: the
    ``generate`` prefill of ``lm_shape`` = (prompts, length) with
    ``cache_len`` slots, the first token picked.  Returns plain dicts:
    {"dit": {name: totals}, "qwen3": totals, "seconds": s}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import diffusion, schedule as S, solvers
    from repro_torch.core.executor import SmoothCacheExecutor
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import op_analysis, programs, serve
    t0 = time.perf_counter()
    cfg = configs.get("dit-xl-256")
    with programs.on_meta():
        params = diffusion.init_params(torch.Generator(), cfg, device="meta")
    ex = SmoothCacheExecutor(cfg, solvers.ddim(steps), cfg_scale=1.5,
                             device="meta")
    x = torch.empty((requests,) + tuple(cfg.latent_shape), device="meta")
    label = torch.empty((requests,), dtype=torch.int64, device="meta")
    dit = {}
    for name, js in schedules.items():
        sch = (S.Schedule.from_json(js) if js is not None
               else S.no_cache(cfg.layer_types(), steps))
        dit[name] = dataclasses.asdict(op_analysis.analyze(
            ex.build_sampler_fn(sch), params, x, label))
    qcfg = lm_cut(configs.get("qwen3-14b"), qwen3_blocks)
    qwen3 = dataclasses.asdict(op_analysis.analyze(
        lambda p, tk: serve.generate(qcfg, p, tk, 1, cache_len=cache_len,
                                     device="meta"),
        programs.params_struct(qcfg), programs.token_struct(qcfg, *lm_shape)))
    return {"dit": dit, "qwen3": qwen3,
            "seconds": time.perf_counter() - t0}


def start_counts(pool):
    """Submit :func:`program_counts` for the DiT slice's schedules and the
    qwen3 phase's prefill to ``pool`` (one spawned process): (its future,
    the time it was submitted)."""
    schedules = {name: (None if m["schedule"] is None
                        else m["schedule"].to_json())
                 for name, m in MEASURED["dit_generate"].items()}
    return (pool.submit(program_counts, schedules, len(REQUEST_LABELS), 50,
                        (LM_BATCH, LM_PROMPT), LM_PROMPT + LM_GEN,
                        QWEN3_BLOCKS), time.perf_counter())


def roofline_phase(counts):
    """The share of the card's peak that whole programs reach: the FLOPs
    and bytes :func:`program_counts` counted on the meta device
    (``counts``: its future and when it was submitted), read against the
    H100's roofline
    (``launch/roofline.py``) and the walls measured earlier in this run.

    DiT-XL/2 at 28 of 28 blocks, the ``generate`` phase's 4 requests
    (B = 8 under CFG 1.5), DDIM 50: ``no_cache``, the run's calibrated
    ``smoothcache:alpha=0.18`` schedule and ``static:n=2`` — counted over
    analytic (``utils.flops``) in [0.8, 1.25], cached over uncached FLOPs
    within 0.15 of the schedule's compute fraction.  Qwen3-14B at the
    qwen3 phase's 8 of 40 blocks and its prefill (4 × 1024, cache_len
    1056) against that phase's prefill seconds.  The weight and
    prepared-halves bytes the dry run predicts (``launch/dryrun.py``) for
    each phase's own weights, against what it measured: equal.  No
    kernel launch in the whole phase; budget ``ROOFLINE_BUDGET_S``, and
    the counts' own seconds no more than the phases they ran beside."""
    from repro_torch import configs
    from repro_torch.core import diffusion, schedule as S
    from repro_torch.kernels import ops
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import dryrun, programs
    from repro_torch.launch.roofline import Roofline
    from repro_torch.models import transformer as T
    from repro_torch.utils import flops as F
    t_phase = time.perf_counter()
    before = (dict(ops.LAUNCHES), dict(ops.CAPTURED))
    card_name = torch.cuda.get_device_name(0)
    future, submitted = counts
    counted = future.result()
    waited = time.perf_counter() - t_phase
    beside = t_phase - submitted

    def terms(arch, shape, t, wall):
        rf = Roofline(arch, shape, "1", 1, t["flops"], t["bytes"], 0.0, {},
                      flops_by_unit=t["by_unit"], card=card_name)
        bound = max(rf.t_compute, rf.t_memory)
        return {"counted_tflop": t["flops"] / 1e12, "bytes": t["bytes"],
                "flops_by_unit": t["by_unit"],
                "kernel_calls": {k: v[0] for k, v in t["kernels"].items()},
                "t_compute_s": rf.t_compute, "t_memory_s": rf.t_memory,
                "bottleneck": rf.bottleneck, "wall_s": wall,
                "achieved_tflops": t["flops"] / wall / 1e12,
                "share_of_roofline": bound / wall}

    cfg = configs.get("dit-xl-256")
    n = len(REQUEST_LABELS)
    n_tok = diffusion.token_shape(cfg)[0]
    dit = {}
    for name, m in MEASURED["dit_generate"].items():
        t = counted["dit"][name]
        sch = m["schedule"] or S.no_cache(cfg.layer_types(), 50)
        analytic = 2 * F.sampler_tmacs(cfg, sch, n_tok, n, cfg_scale=1.5)
        dit[name] = {**terms(cfg.name, f"generate {name}", t, m["wall_s"]),
                     "analytic_tflop": analytic,
                     "counted_over_analytic": t["flops"] / 1e12 / analytic,
                     "compute_fraction": m["compute_fraction"]}
        if "walls" in m:
            # the segment_graphs phase's A B B A walls, graphs on and off
            bound = max(dit[name]["t_compute_s"], dit[name]["t_memory_s"])
            dit[name]["walls_abba_s"] = m["walls"]
            dit[name]["share_of_roofline_abba"] = {
                k: [bound / w for w in v] for k, v in m["walls"].items()}
        check(0.8 <= dit[name]["counted_over_analytic"] <= 1.25,
              f"DiT-XL/2 {name}: counted / analytic FLOPs "
              f"{dit[name]['counted_over_analytic']}")
    plain = dit["no_cache"]["counted_tflop"]
    for name, row in dit.items():
        row["over_no_cache"] = row["counted_tflop"] / plain
        check(abs(row["over_no_cache"] - row["compute_fraction"]) <= 0.15,
              f"DiT-XL/2 {name}: cached / plain FLOPs "
              f"{row['over_no_cache']}, compute fraction "
              f"{row['compute_fraction']}")
    per_image = F.sampler_tmacs(cfg, S.no_cache(cfg.layer_types(), 50),
                                n_tok, 1, cfg_scale=1.5)

    qcfg = lm_cut(configs.get("qwen3-14b"), QWEN3_BLOCKS)
    analytic = 2 * LM_BATCH * (sum(F.model_macs_by_type(
        qcfg, LM_PROMPT).values()) + F.non_block_macs(qcfg, LM_PROMPT)) / 1e12
    qwen3 = {**terms(qcfg.name, "prefill 4 x 1024", counted["qwen3"],
                     MEASURED["qwen3_prefill_s"]),
             "blocks": qcfg.num_layers, "analytic_tflop": analytic,
             "counted_over_analytic":
             counted["qwen3"]["flops"] / 1e12 / analytic}
    check(0.8 <= qwen3["counted_over_analytic"] <= 1.25,
          f"Qwen3 prefill: counted / analytic FLOPs "
          f"{qwen3['counted_over_analytic']}")

    memory = {}
    for name, (mcfg, weights, prepared) in MEASURED["params"].items():
        if mcfg.task == "lm":
            ps = programs.params_struct(mcfg)
            halves = dryrun.halves_bytes(T.token_weights(ps))
        else:
            with programs.on_meta():
                ps = diffusion.init_params(torch.Generator(), mcfg,
                                           device="meta")
            halves = dryrun.halves_bytes(diffusion.token_weights(ps))
        memory[name] = {"weights": weights, "halves": prepared,
                        "predicted_weights": dryrun.meta_params_bytes(ps),
                        "predicted_halves": halves}
        check(memory[name]["predicted_weights"] == weights
              and halves == prepared,
              f"{name}: the dry run predicts {memory[name]}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "roofline", "card": card_name,
          "dit_xl_2": dit, "qwen3_prefill": qwen3,
          "dit_tmacs_per_image_b1_cfg": per_image,
          "memory_predicted_vs_measured": memory,
          "launches_unchanged": (dict(ops.LAUNCHES), dict(ops.CAPTURED))
          == before, "seconds": seconds, "waited_for_counts_s": waited,
          "count_process_s": counted["seconds"],
          "phases_beside_counts_s": beside, "budget_s": ROOFLINE_BUDGET_S})
    check((dict(ops.LAUNCHES), dict(ops.CAPTURED)) == before,
          "the roofline phase launched a kernel")
    check(seconds <= ROOFLINE_BUDGET_S,
          f"the roofline phase took {seconds:.1f} s, over its budget")
    check(counted["seconds"] <= beside,
          f"the meta counts took {counted['seconds']:.1f} s, more than the "
          f"{beside:.1f} s of the phases they ran beside")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import cuda_graphs, diffusion
    from repro_torch.kernels import flash_attention as fa, gemm, ops, ref
    from repro_torch.kernels import rglru, ssd
    from repro_torch.kernels.products import lm_cut
    from repro_torch.launch import dryrun, serve
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = card()
    t_main = time.perf_counter()
    marks = {}

    def mark(name):
        """Seconds since the builds began, after the named step."""
        marks[name] = time.perf_counter() - t_main

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        builds = {m.__name__.rsplit(".", 1)[-1]: pool.submit(m.build)
                  for m in (fa, ssd, gemm, rglru, cuda_graphs)}
        builds = {k: f.result() for k, f in builds.items()}
    emit({"phase": "build",
          "seconds": {k: r["seconds"] for k, r in builds.items()},
          "wall_s": time.perf_counter() - t0})
    sass = sass_phase({k: r["path"] for k, r in builds.items()})
    mark("build_and_sass")
    cfg = configs.get("dit-xl-256")
    kernels = {"flash_attention": kernel_phase(fa, ref, peaks),
               "ssd": ssd_kernel_phase(ssd, ref, peaks),
               "linear": gemm_kernel_phase(gemm, ref, peaks, cfg)}
    mark("kernel_sweeps")

    t0 = time.perf_counter()
    params_cpu = full_width_params(cfg)
    params_gpu = tree_map(lambda a: a.cuda(), params_cpu)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    # the token products' split weights, made once before anything is
    # timed or captured
    t0 = time.perf_counter()
    prepared = diffusion.prepare_linear(params_gpu)
    torch.cuda.synchronize()
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "seconds": params_s,
          "count": sum(a.numel() for a in tree_leaves(params_cpu)),
          "linear_prepared_bytes": prepared,
          "linear_prepare_s": time.perf_counter() - t0,
          "device_bytes": torch.cuda.memory_allocated()})
    check(prepared == dryrun.halves_bytes(diffusion.token_weights(params_gpu)),
          f"{prepared} prepared bytes")
    MEASURED["params"][cfg.name] = (
        cfg, sum(a.numel() * a.element_size()
                 for a in tree_leaves(params_gpu)), prepared)
    kernels["linear"]["prepared_bytes"] = prepared
    cross_check_phase(cfg, diffusion, params_cpu, params_gpu)
    del params_cpu
    dit_profile_phase(cfg, diffusion, params_gpu, ops)
    mark("dit_params_cross_check_profile")

    _reset_counts(ops)
    torch.cuda.reset_peak_memory_stats()
    _, smooth_art = slice_phase(cfg, params_gpu, ops)
    # the segmented path's graph replays launch without a wrapper call:
    # the slice's launches are its wrapper calls (calibration, the eager
    # reference, the graphs' warm-ups) and its replays
    dit_calls, dit_replayed = dict(ops.LAUNCHES), dict(ops.REPLAYED)
    dit_launches = {k: dit_calls[k] + dit_replayed[k] for k in dit_calls}
    path = attention_path(cfg, diffusion, fa, params_gpu)
    emit({"phase": "slice", "launches": dit_launches, "calls": dit_calls,
          "replayed": dit_replayed, "attention_path": path,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    check(dit_launches["ssd"] == 0, "SSD launched in the DiT slice")
    check(path == {"arith": "3xtf32-mma.sync", "load": "cp.async"},
          f"the DiT slice's attention takes {path}")
    kernels["flash_attention"]["launches"] = dit_launches["flash_attention"]
    kernels["linear"]["launches"] = dit_launches["linear"]
    for rows in gemm.ROWS:
        kernels["linear"]["variants"][rows]["launches"] = \
            dit_launches["linear_" + rows]
    check(all(dit_launches["linear_" + rows] > 0 for rows in gemm.ROWS),
          f"a linear variant never launched in the DiT slice: "
          f"{dit_launches}")
    mark("dit_slice")
    segment_graphs_phase(cfg, params_gpu, ops, smooth_art)
    mark("segment_graphs")
    serve_launches, serve_calls, store = serve_phase(cfg, params_gpu, ops,
                                                     smooth_art)
    kernels["flash_attention"]["serve_launches"] = serve_launches
    kernels["flash_attention"]["serve_calls"] = serve_calls
    fused = fused_phase(cfg, params_gpu, ops, store)
    kernels["flash_attention"]["fused_captured_per_graph"] = \
        fused["captured_launches_per_graph"]
    kernels["flash_attention"]["fused_replayed"] = fused["replayed_launches"]
    continuous_phase(cfg, params_gpu, ops, store)
    slo_phase(cfg, params_gpu, ops, store)
    cut, cut_params = dit_cut(cfg, params_gpu, SERVE_CUT_BLOCKS)
    for name, phase in (("resilience", resilience_phase),
                        ("telemetry", telemetry_phase),
                        ("durable", durable_phase)):
        launches = phase(cut, cut_params, ops, store)
        kernels["flash_attention"][name + "_launches"] = \
            launches["flash_attention"]
        kernels["linear"][name + "_launches"] = launches["linear"]
    mark("serving")
    del cut_params, store
    # training trains the serving phases' weights in place
    train_dit_phase(cfg, params_gpu, peaks, kernels)
    del params_gpu
    gemm.release()            # the prepared halves hold the DiT weights
    gc.collect()              # the DiT weights go before the Mamba phases
    torch.cuda.empty_cache()
    mark("train_dit")
    quickstart_phase(kernels)
    mark("quickstart")

    cfg = lm_cut(configs.get("mamba2-1.3b"), MAMBA2_BLOCKS)
    t0 = time.perf_counter()
    # drawn on the card (a CPU draw was the slow part of this set-up),
    # copied to the CPU for the cross check
    params_gpu = serve.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params_gpu)
    emit({"phase": "params", "arch": cfg.name, "blocks": cfg.num_layers,
          "d_model": cfg.d_model, "drawn_on": "cuda",
          "seconds": time.perf_counter() - t0,
          "count": sum(a.numel() for a in tree_leaves(params_cpu))})
    lm_cross_check_phase(cfg, T, params_cpu, params_gpu)
    del params_cpu
    prompts, toks, lm_launches = lm_slice_phase(cfg, T, serve, params_gpu,
                                                ops)
    kernels["ssd"]["launches"] = lm_launches["ssd"]
    lm_decode_consistency_phase(cfg, T, params_gpu, prompts, toks)
    lm_profile_phase(cfg, T, params_gpu, prompts, toks)
    mark("mamba2")
    del params_gpu, prompts, toks
    free_lm_weights(gemm)     # the Mamba weights go before the qwen3 phases
    qwen3_phase(peaks, kernels, sass)
    mark("qwen3")
    gemma2_phase(peaks, kernels, sass)
    mark("gemma2")
    minicpm3_phase(peaks, kernels, sass)
    mark("minicpm3")
    deepseek3_phase(peaks, kernels, sass)
    mark("deepseek3")
    recurrentgemma_phase(peaks, kernels, sass)
    mark("recurrentgemma")
    musicgen_phase(peaks, kernels, sass)
    mark("musicgen")
    internvl2_phase(peaks, kernels, sass)
    mark("internvl2")
    train_lm_phase(peaks, kernels)
    mark("train_lm")
    llama4_phase(peaks, kernels, sass)
    mark("llama4")
    # the roofline phase's meta counts run in a process of their own
    # beside the video and audio phases
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        counts = start_counts(pool)
        video_phase(peaks, kernels)
        mark("video")
        torch.cuda.empty_cache()  # the video weights go before audio
        audio_phase(peaks, kernels)
        mark("audio")
        roofline_phase(counts)
        mark("roofline")

    # the decode graphs: each kernel's calls captured a step × the timed
    # generate's replays, by LM phase
    for name, k in (("flash_attention", "flash_attention"),
                    ("linear", "linear"), ("rglru_scan", "rglru_scan")):
        kernels[name]["decode_captured_per_graph_x_replays"] = {
            tag: [g["captured"][k], g["replays"]]
            for tag, g in MEASURED["decode_graphs"].items()
            if g["captured"][k]}
    emit({"phase": "script_marks", "seconds_since_build": marks})
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
