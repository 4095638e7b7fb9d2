#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases, one JSON line each; any failure exits non-zero:

  1. build   - nvcc builds the pod-GEMM (NN, NT and grouped), flash-
               attention and SSD kernels from src/ for sm_90a, in parallel,
               and prints each ptxas report.
  2. kernel  - the pod-GEMM kernel against its plain PyTorch version on the
               card: f32/bf16/int8 x every activation x ragged shapes x
               f32/bf16 out, each within runtime.TOLERANCES, with
               granite-8b's and dbrx-132b's served shapes (dbrx's q/o, k/v
               and head at M = 4 and 1277), deepseek-v2's head [4, 5120]
               x [5120, 102400], and shapes that reach each bf16
               mainloop's edges (wgmma at M = 65, 129, 1000, 1277, N =
               1032, K = 4104; splitk with splits that do not divide the
               k-steps evenly); a planted control that sums in bf16 must
               fail, and at granite-8b's q and head (M = 4) two split-K
               controls (the last split's partial left out; each k-step's
               products taken with the previous step's w tile) must fail.
               A row's result must be bit-equal at M = 256, 65, 57, 4 and
               1 (wgmma and splitk sum K in one order), in the NN form at
               granite's q and dbrx's k and in the NT form at mamba2's
               head; and in the grouped form at dbrx's up projection (G =
               16) at M = 399, 320, 129 and 65, all on wgmma. hymba-1.5b's
               ragged head (N = 32001, wmma) at M = 4 and 1024. Then
               (kernel_dense_archs) minitron-8b's up with relu2 in the
               epilogue at M = 4 and 8192 and nemotron-4-340b's decode
               GEMMs at M = 4 (q, k/v, o, up with relu2, down, the
               256000-row head), and whisper-small's (the encoder's q,
               up with GELU and down at M = 1500 on wgmma, the decoder's
               at M = 4 on splitk, the head [4 and 64, 768] x [768,
               51865], N odd, on wmma), and llama-3.2-vision-90b's
               (q, k, o, gate with SiLU, down and the 128256-row head at
               M = 4 on splitk, up at M = 600 on wgmma), bf16 and f32 out
               within their tolerances, each timed beside its plain
               version, torch.matmul with the activation and its bound.
  3. gemm_nt - the same for the transposed-weight kernel (w [N, K], the
               tied LM head), with mamba2's head [4, 1024] x [50280, 1024]^T
               among the shapes (a 104-column ragged tail) and its NT
               mainloop edges (wgmma at M = 65, 129, 300, 1277; splitk at
               4 and 29; K = 4104 split 13 ways on both); the two split-K
               controls, planted on w [N, K], must fail at mamba2's head
               and at the 13-way split.
  4. flash   - the flash-attention kernel against its plain version:
               f32/bf16 x the cases of tests/test_kernels.py, granite-8b's
               and dbrx-132b's heads (48 over 8 at its longest and
               shortest prompts), Sq != Skv, D = 192, and the wgmma
               mainloop's edges (Sq and Skv at 127, 128, 129; a kv_len
               tail inside a key tile and on its edge; a window across two
               key tiles; B > 1 with ragged S; D = 64 and 128), hymba-
               1.5b's heads (25 over 5, D 64) with its 1024-token window
               at [4, 2048] and [1, 1277] and global at [4, 2048], within
               runtime.TOLERANCES, each case with its mainloop
               (flash_plan); bf16 also against the Pallas kernel's own
               arithmetic at the kernel's key tile (flash_bf16_tiled_served:
               one bf16 ulp and a flipped p of a heavy key). Two planted
               controls (causal mask off by one, GQA map h % Hkv) must
               fail; at granite-8b's [4, 2048, 32, 128] two that err on
               late KV tiles only (a stale K tile, PV summed in bf16) must
               fail that tolerance. A prompt's rows must be bit-equal
               prefilled alone ([1, S]) and in a [4, 2S] bucket, at
               granite's and dbrx's heads. nemotron-4-340b's heads (96
               over 8, D 192) at [4, 2048] on the mma mainloop, against
               both plain versions, timed beside SDPA. whisper-small's
               encoder, [1, 1500, 12 over 12, 64] non-causal (G = 1, a
               ragged last key tile), and llama-3.2-vision-90b's dense
               layers, [1, 600, 64 over 8, 128] causal, among the cases.
  5. ssd     - the SSD chunk-scan kernel against the Pallas kernel's own
               arithmetic (ssd_kernel_ref) at about one bf16 ulp and
               against the reference (ssd_ref, bf16 state) at its stated
               drift, y and final state: the cases of tests/test_kernels.py
               in f32 and bf16, mamba2's [4, 2048, 32, 64] (N 128, chunk
               256; in bf16 and in f32, where the kernel runs 128-token
               sub-chunks), a ragged S and G > 1, hymba-1.5b's [4, 2048,
               50, 64] at N 16 with the served model's dt and with
               Mamba-2's (slow heads carry their state across chunks),
               each on the mainloop ssd_plan picks (bf16 at mamba2's tiles
               on chunked, the rest on serial). At the served shape
               seven planted controls (no state carried across chunks, the mask after exp, y_inter
               from the updated state, ssd_ref itself, the state and
               y_inter rounded to bf16, the state pass without its decay,
               cum carried across chunks) must fail the one-ulp tolerance;
               a long-chunk-decay case ([4, 1024] at the same tiles, dt and
               A as Mamba-2 initialises them, so slow heads carry their
               state across whole chunks) passes it too, and the same
               controls fail there, cum across chunks on the state itself
               (the bf16 state is reported there, not gated);
               a prompt of 1277 tokens gives bit-equal rows and state alone
               ([1, 1277]) and in a [4, 2048] bucket; strided views of one
               projection give bit-equal results to contiguous copies.
  6. grouped - the grouped pod-GEMM kernel (the MoE experts) against its
               plain version: f32/bf16/int8 x every activation x ragged
               shapes x f32/bf16 out with per-group scale and bias (G > 1
               on wgmma at M = 65 and 129 too), an all-zero group exactly
               0, G = 1 equal to the pod-GEMM kernel bit for bit where
               both run one mainloop (wmma, simt or wgmma; within
               tolerance where the NN launch runs splitk and the grouped
               one wmma), dbrx-132b's served shapes ([16, 1, 6144] x
               [16, 6144, 10752], the down [16, 1, 10752] x [16, 10752,
               6144], M = 320 and 399 rows per expert, up and down) and
               deepseek-v2's ([160, 1, 5120] x [160, 5120, 1536] with
               SiLU, the down [160, 1, 1536] x [160, 1536, 5120], and up
               at M = 59), each with an all-zero middle group that must
               come out exactly 0. Two planted controls (sums in bf16,
               group g+1 reading group g's weights) must fail.
  7. serve   - granite-8b at full width and depth (random weights from a
               seeded torch.Generator, bf16) served by ServeEngine, whose
               bucketed prefills and decode chunks replay CUDA graphs
               (serve/graphs.py); every request must finish with valid
               tokens, and the pod-GEMM launch count must be 7 x 36 + 1 =
               253 per forward, each on splitk (M <= 64) or wgmma (M >
               64), none on wmma. The paged and moe phases hold their
               pod-GEMM launches to the same rule. Every serve phase
               (7, 9, 11, 13) then serves the same requests through an
               eager engine (ServeEngine(eager=True)) in the same run:
               tokens, every host read (first tokens and packed decode
               chunks) bit for bit, host syncs and launch counts by
               mainloop must be equal, the graphs within
               max_prefill_compiles and log2(decode_chunk) + 1; a second
               pass of each engine gives its steady figures (decode
               ms/step, prefill ms/call, tokens/s; the graphed one
               captures nothing), and one decode chunk of each is traced
               with torch.profiler (its kernels and walls), with capture
               seconds, graph count, the graph
               pool's bytes and whether one decode step's logits are
               bit-equal graphed and eager.
  8. oracle  - the same requests through the per-token ReferenceEngine.
               Random weights at 36 layers turn a last-bit difference into
               different tokens, so agreement is reported there and the
               rule (tokens agree, or differ only after a near tie) is held
               on the first ORACLE_LAYERS layers of the same weights.
  9. serve_paged  - the same weights as Model(attention_impl="pallas"),
               served by a paged ServeEngine (max_len 2048, a pool of half
               the dense pages) on prompts of up to 1500 tokens: every
               request done, the pool drained, at least one lane recycled,
               36 flash launches per prefill, each on wgmma, 253 pod-GEMM
               launches per forward, one host sync per prefill group and
               decode chunk.
 10. paged_oracle - the same requests through a dense ServeEngine on the
               same flash model: tokens must be equal. On ORACLE_LAYERS
               layers the paged flash engine is held to the margin rule
               against the per-token ReferenceEngine of the same model.
               The kernel on layer 0's real activations of the served
               prompts is held to the Pallas kernel's own arithmetic.
 11. serve_ssm - mamba2-370m at full width and depth (48 layers, d 1024,
               vocab 50280, tied embeddings; random bf16 weights) as
               Model(ssd_impl="pallas", use_pallas=True), served by
               ServeEngine(slots 4, max_len 2048, decode_chunk 8) on the
               paged phase's prompts: every request done, one NT-GEMM
               launch per forward, each on splitk (decode) or wgmma
               (prefill), 48 SSD launches per prefill, each on chunked, and
               none per decode step, no other kernel, one host sync per prefill group and
               decode chunk.
 12. ssm_oracle - the same requests through the per-token ReferenceEngine:
               agreement reported at 48 layers, the margin rule held on
               ORACLE_LAYERS layers of the same weights.
 13. serve_moe - dbrx-132b at full width and MOE_LAYERS of its 40 layers
               (random bf16 weights) as Model(attention_impl="pallas",
               use_pallas=True), served by ServeEngine(slots 4, max_len
               2048, decode_chunk 8) on the paged phase's prompts with
               exact-length prefill: every request done, 8 prefills of
               [1, S], 24 grouped and 33 pod-GEMM launches per forward, the
               grouped ones on wgmma where a prefill gives an expert more
               than 64 rows and on wmma otherwise, 8 flash launches per
               prefill, each on wgmma, and none per decode step, no NT or
               SSD launch, one host sync per prefill and decode chunk.
 14. moe_oracle - the first 4 of those requests through a fresh ServeEngine
               and the per-token ReferenceEngine: every decode batch is
               fully live in both, so capacity coupling through dead lanes
               cannot tell them apart. Agreement reported at MOE_LAYERS,
               the margin rule held at the first difference anywhere in the
               batch on ORACLE_LAYERS layers of the same weights.
 14a. serve_mla - deepseek-v2-236b at full width and MLA_LAYERS of its 60
               layers (dense0 and 7 MoE layers of 160 experts, top 6, 2
               shared; MLA at kv_lora 512, 128 heads; random bf16 weights
               drawn after dbrx's are freed) as Model(attention_impl=
               "pallas", use_pallas=True), served by ServeEngine(slots 4,
               max_len 2048, decode_chunk 8) on the paged phase's prompts
               with exact-length prefill, graphed against eager as every
               serve phase: every request done, 8 prefills of [1, S], 25
               pod-GEMM launches per forward (the dense layer's MLP, the
               shared experts, the head) on splitk or wgmma and 21 grouped
               (the routed experts, G = 160) on wgmma where a prefill gives
               an expert more than 64 rows and on wmma otherwise, no
               flash, NT or SSD launch (MLA is torch ops: prefill
               decompressed into chunked attention, decode absorbed over
               the latent cache), one host sync per prefill and decode
               chunk; the latent cache's bytes against a GQA cache of the
               same heads, peak memory, the top kernels of one profiled
               decode chunk.
 14b. mla_oracle - as moe_oracle on deepseek-v2 (the 2-layer cut: dense0
               and the first MoE layer); then, on that cut with the
               capacity factor raised to 160 (no assignment drops), the
               last logits of a [1, 957] prefill against the same tokens
               fed through the absorbed decode one at a time: argmax equal
               or a near tie (the margin rule), max |difference| reported.
 14c. serve_audio - after mla_oracle (deepseek's weights freed):
               whisper-small at full width and depth (12 encoder and 12
               decoder layers, d 768, 12 heads of 64, d_ff 3072 with GELU,
               layernorm, vocab 51865 untied; random bf16 weights) as
               Model(attention_impl="pallas", use_pallas=True), served by
               ServeEngine(slots 4, max_len 448, src_len 1500,
               decode_chunk 8) on 8 prompts of 4-64 tokens (whisper's
               4-token start of transcript, then text), each request with
               its own bf16 frames [1, 1500, 768] in `extras`, graphed
               against eager as every serve phase: every request done, 8
               exact-length prefills of [1, S], each encoder pass 72
               pod-GEMM and 12 flash launches (none at decode), each
               prefill's decoder 73 and 12, each decode step 73 and no
               flash; the encoder's GEMMs on wgmma, the decoder's on
               splitk, the head on wmma, flash on wgmma; no NT, grouped or
               SSD launch; one host sync per prefill and decode chunk; a
               paged engine refuses a request with frames (InvalidRequest,
               field extras). Reports the encoder's ms beside prefill
               ms/call, kernels per decode step, the cross K/V bytes and
               the decode floor.
 14d. audio_oracle - the served tokens against the per-token
               ReferenceEngine on the same weights and frames: agreement
               and the margin rule reported at 12 + 12 layers, the margin
               rule held on the first ORACLE_LAYERS encoder and decoder
               layers of the same weights.
 14e. serve_vlm - after audio_oracle (whisper's weights freed):
               llama-3.2-vision-90b at full width and VLM_LAYERS = 30 of
               its 100 layers (6 groups of 4 dense layers and a
               cross_layer; d 8192, 64 heads over 8 of 128, d_ff 28672
               gated SiLU, vocab 128256 untied, 1601 image tokens; 55.7 GB
               of random bf16 weights) as Model(attention_impl="pallas",
               use_pallas=True), served by ServeEngine(slots 4, max_len
               1024, decode_chunk 8; src_len 0: the cross cache takes
               1601 rows) on 8 prompts of 16-600 tokens, each request
               with its own bf16 image embeddings [1, 1601, 8192] in
               `extras`, graphed against eager as every serve phase: every
               request done, 8 exact-length prefills of [1, S], 187
               pod-GEMM launches a forward (7 a dense layer, 3 a cross
               layer, the head), on splitk at M <= 64 (decode, a 16-token
               prompt) and wgmma above, the head (N = 128256) with them;
               24 flash launches a prefill on wgmma and none a decode
               step; no NT, grouped or SSD launch; one host sync per
               prefill and decode chunk; a paged engine refuses image
               embeddings. Reports the image path's ms (img_adapter and
               the 12 cross K/V projections) beside prefill ms/call, the
               self KV and cross K/V bytes, the decode floor and the
               profiled decode chunk's top kernels.
 14f. vlm_oracle - the served tokens against the per-token
               ReferenceEngine on the same weights and images: agreement
               and the margin rule reported at 30 layers, the margin rule
               held on the first group (5 layers) of the same weights; a
               6-layer cut (not whole groups) must be refused.
 15. serve_hybrid - hymba-1.5b at full width and depth (32 layers, d
               1600, 25 heads over 5 of 64, a 50-head Mamba-2 mixer beside
               the attention in every layer, a 1024-token window except in
               the global layers 0, 15 and 31, vocab 32001, untied; random
               bf16 weights) as Model(attention_impl="pallas",
               ssd_impl="pallas", use_pallas=True), served on the paged
               phase's prompts (the 1277- and 957-token ones cross the
               window in prefill, and their decode wraps the ring) by a
               dense ServeEngine (slots 4, max_len 2048, decode_chunk 8;
               graphed against eager as every serve phase) and by a paged
               one (the paged phase's pool for the global layers; rings
               and SSM state lane-resident), two graphed passes: every
               request done, paged tokens equal to dense and the pool
               drained, 225 pod-GEMM launches per forward (the head, N =
               32001, on wmma; the rest on splitk or wgmma by M), 32 flash
               launches per prefill on wgmma (the window of each: 29
               windowed, 3 global) and 32 SSD launches on serial, none per
               decode step, no NT or grouped launch, one host sync per
               prefill group and decode chunk; weights, rings, global KV,
               SSM state and graph pools' bytes and the decode floor.
 16. hybrid_oracle - the same requests through the per-token
               ReferenceEngine (exact-length prefill: the ring's roll):
               agreement reported at 32 layers, the margin rule held on
               ORACLE_LAYERS layers of the same weights (glob0 and the
               first layer of swa1).
 17. serve_controls - run after phase 10 on granite-8b's weights at full
               width (Model(cfg, use_pallas=True); the flash model for the
               paged engine): the overload case of tests/test_admission.py
               (slots 2, decode_chunk 8, 12 requests of 5-8 tokens, 6 new,
               deadlines 0.8 and 7.0 s alternating) under a VirtualClock
               with ChaosConfig(seed=0, service_seconds=0.05), under fifo,
               edf and slo-aware: every request terminal, no slot held,
               edf and slo-aware above fifo in SLO attainment. The serve
               phase's requests with the defaults and with metrics and a
               trace recorder on, real clock: equal tokens, host syncs,
               graphs and launches by kernel and mainloop, one span per
               device call; a second pass gives effective_tops_summary per
               phase (prefill, decode), the token wait p50/p99 and tok/s.
               The paged engine (edf) with ChaosConfig(seed=3, p_fault=0.3,
               p_slow=0.3), max_retries 3: faults injected, every request
               done with the chaos-free run's tokens, runners and graphs
               equal to its, no page or slot held; with transient_tries 5
               (retries exhausted) requests end rejected device-fault and
               nothing leaks. The wave-model predictor's host ms per new
               key at full width. Two planted controls must fail their
               gates: an engine whose call writes before the injector
               raises (token equality after retry), and a metrics hook
               that reads a device tensor (the sync count).
 18. launch_serve - repro_torch.launch.serve.main in-process (reduced
               granite-8b, edf, deadline 5 s, chaos seed 1, metrics, a
               trace file under build/): it returns, it launched the
               pod GEMM and flash kernels, and the trace file holds one
               span per device call; then reduced deepseek-v2 with the
               defaults: every request done, pod-GEMM and grouped
               launches, no flash launch.
 19. guard   - run after phase 18 on granite-8b's weights at full width:
               the 253 pod GEMMs of a decode step and of a [4, 256]
               forward under the SDC guard off, probe and abft (the
               guarded GEMM: the raw kernel, on wmma at abft's ragged
               [M+1, K] x [K, N+1], then the verdict and the epilogue in
               torch ops), each against the plain version, timed with L2
               flushed, with its launches by mainloop and torch.matmul on
               the augmented operands; an element planted at a known
               (row, col) located there and repaired within
               gemm_bf16_f32out. Engines on the serve requests under a
               VirtualClock (benchmarks/serving.py's SDC parameters):
               guard "off" equal to phase 7's engine (tokens, host reads,
               runners, graphs, launches, syncs); clean abft and probe
               runs (syncs, chunks and graphs equal to off; capture_s,
               graph pool bytes); abft with ChaosConfig(seed=7, p_sdc=0.5,
               sdc_elems=1, transient_tries=1): injected, corrected, none
               uncorrectable, nothing leaked, tokens equal to the clean
               abft run's (a difference only under the margin rule,
               listed); two elements a hit heal through retries, and a
               planted verdict that ignores uncorrected output must fail
               that token equality; p_sdc 0.9, two elements,
               transient_tries 10, max_retries 1: sdc-uncorrectable
               rejections and nothing leaked, dense and paged. Second
               passes in turns (off, abft, abft, off, then probe) give
               decode ms/step; one abft decode chunk is profiled. Probe
               with single elements on granite's k (N = 1024) heals to
               the clean probe run's tokens; on q (N = 4096) fewer hits
               are detected than made, as the reference's tolerance says
               (ROADMAP queue 3). One engine a mode serves every gate,
               re-armed (a fresh clock, injector and guard events), and
               no gate captures a graph.
 20. guard_ssm - run after phase 12 on mamba2-370m's weights (phase 11's
               engine configuration; its one guarded GEMM is the tied
               head, N = 50280): abft with two-element hits (p_sdc 0.6,
               replayed once): decode chunks that fail the guard are
               retried after the SSM state, conv window and lengths they
               advanced are restored, and the tokens equal the clean abft
               run's; a planted engine without the restore must fail
               that. probe with single elements is reported: at N =
               50280 its tolerance lies above any lone element.
 21. dense_archs - run after phase 16: yi-6b and minitron-8b at full
               width and depth, nemotron-4-340b at full width cut to 4 of
               96 layers (46.5 GB of weights), each as Model(
               attention_impl="pallas", use_pallas=True) on the serve
               requests, bucketed prefill and graphed decode: every
               request done, (7 or 6) x layers + 1 pod-GEMM launches per
               forward on splitk or wgmma, one flash launch per layer a
               prefill (wgmma at D 128, mma at nemotron's 192), one host
               sync per call, relu2 (minitron, nemotron) or SiLU (yi) in
               one epilogue a layer; a second pass's figures, one
               profiled decode chunk, the oracle's margin rule at
               ORACLE_LAYERS layers of the same weights.
 22. train_flash_vjp - run after phase 21, training's flash backward
               (models/attention.py::_FlashVJP, torch ops: the reference's
               training path reaches no Pallas kernel) against autograd
               through naive_attention in f32 without TF32: yi-6b's heads
               [2, 1024, 32 over 4, 128] causal with 256-key blocks, a
               ragged S = 1000, deepseek-v2's MLA widths (128 heads, D
               192, Dv 128), in f32 and bf16 (flash_vjp_f32,
               flash_vjp_bf16_card); the planted backward without its
               delta term must fail both; fwd+bwd ms beside SDPA's.
 23. train   - yi-6b at full width, 8 of 32 layers (1.91 G parameters,
               26.7 GB of params and AdamW state), its attention
               projections drawn at fan-in d_model (fan_in_attention),
               batch 8 x 1024 from the synthetic stream, 12 AdamW steps
               with remat: every loss finite and the last 3 below the
               first 3; remat off equal to on (loss and gradients);
               microbatches=4 within the reference's test bounds of 1;
               a checkpoint saved at step 6 and restored into fresh state
               repeats steps 7-9's losses. Step ms, tokens/s, TFLOP/s
               against the bf16 floor, AdamW's ms, peak memory of a step
               and of the gradients with remat on and off, the
               checkpoint's bytes and save and restore seconds.
 24. launch_train - the train launcher in-process at reduced yi-6b:
               --kill-at 7 exits 42, --resume goes on from step 5 and
               prints the steps of a run that was not killed.
 25. parallel - run after phase 24 on freed memory: an NCCL process group
               of one rank on the card (tcp://127.0.0.1, a free port),
               make_host_mesh(model=1) (data 1, model 1); yi-6b at full
               width, 8 of 32 layers, phase 23's batch and redrawn
               attention projections: grads_fn on the plain parameters,
               then on the same storage wrapped as DTensors
               (DTensor.from_local with pspecs_from_schema's placements,
               no copy; the batch on batch_sharding; make_constrain the
               Model's hook; parallel/sharding.py::sharded_step): the loss
               and every gradient leaf bit-equal, both steps' ms (the cost
               of DTensor's dispatch, first call and warm). The DTensor
               gradients (Partial over data) through
               make_grad_sync(mesh, "data", impl): psum, butterfly,
               butterfly2 and ring return them bit-equal; compressed's
               reduced + new_error equals the input within one f32 ulp,
               its error below 0.05 of each 256-block's maximum; the flat
               vector's bytes and each reducer's ms and GB/s. At one rank
               no mesh axis splits the vocabulary or the heads, so the
               step takes the replicated loss; the vocabulary-parallel
               sums that a split vocabulary takes
               (models/layers.py::_VocabParallelSums, NCCL all-reduces
               of max and sum over the one-rank "model" group) run beside
               the plain loss on the step's bf16 logits [8, 1024, 64000]:
               loss within sharded_loss_f32, the logits' gradient within
               sharded_grads_f32 (bit-equality reported), each path's ms
               and peak above the logits. No gloo, no CPU path; the group
               is destroyed at the end.
 26. dryrun - run after phase 25 has destroyed its NCCL group: the
               port's dry-run (repro_torch/launch/dryrun.py) checked
               against the card. (a) phase 23's yi-6b cut (full width, 8
               of 32 layers) at its batch 8 x 1024, registered as a
               ShapeConfig of its own for the phase, traced on fake cuda
               tensors over a one-rank fake group and a (data 1, model 1)
               mesh: the full step with AdamW, and the gradients with
               remat on and off. The predicted peak (argument bytes plus
               MemTracker's peak above them) must be within 15% of phase
               23's measured peak of a step, and the predicted bytes above
               the arguments within 15% of its gradients' peak above the
               state, remat on and off; roofline.analysis.HBM_PER_CHIP
               must equal the card's total_memory. The traced FLOPs of a
               step are printed beside phase 23's analytic count (6 N T +
               2 N_layers T) and must read 1.00-1.10 of that count with
               the two terms no op performs taken out (the token table's
               lookup priced as a product, 6 V d T, and each layer's last
               product, which checkpoint's early stop does not recompute,
               2 d d_ff L T); the measured step's roofline fraction
               against 989 TFLOP/s. (b) `python -m
               repro_torch.launch.dryrun --arch granite-8b --shape
               decode_32k --multi-pod` and `--arch yi-6b --shape
               train_4k` (the pod mesh: the sharded step's
               vocabulary-parallel loss and its GQA attention on split
               query heads at 256 ranks on this torch), each in a child
               process (a fake group of 512 or 256 ranks, fake cuda
               tensors; both started before phase 22, they run beside
               phases 22-25 and (a)): status ok, its chips, compute_s >
               0, collective_s >= 0; its hbm_gb_per_chip and bottleneck;
               yi-6b's cell must fit under the card's total_memory. The
               dry-run reaches no kernel (its Model runs no use_pallas),
               so the kernels line is unchanged.
 27. kernels - each kernel's time at the served shapes beside its bound,
               its plain version and one PyTorch call (a yardstick only);
               the pod GEMM at granite-8b's, dbrx-132b's and hymba-1.5b's
               shapes (hymba's head on wmma at M = 4 and 8192), flash
               at granite's [4, 256] and [4, 2048], dbrx's [1, 1277] and
               hymba's [4, 2048] windowed and global prefills (mainloop,
               key tile and TFLOP/s each; the window's bound counts the
               keys inside it, SDPA takes it as a mask), the NT
               head up to a [4, 2048] prefill, SSD at [4, 256] and [4,
               2048] on its mainloop with the serial mainloop timed beside
               it and hymba's [4, 2048] on serial, the grouped experts' up
               and down at M = 320; launches by mainloop from the served
               runs (hymba's under "hybrid" in each entry); the pod GEMM's
               entry adds granite's GEMMs under the guard ("guard": a
               forward under off, probe and abft, launches by mainloop)
               and the dense archs' shapes and served launches
               ("dense_archs"), flash's nemotron's row; deepseek-v2's
               25 pod GEMMs a forward at M = 4 and 1277 and its grouped
               experts at G = 160 (M = 1 and 59), with its served
               launches by mainloop, under "deepseek" in rows 1 and 5;
               whisper-small's GEMMs (an encoder pass, a decode step) and
               flash rows (the encoder's non-causal [1, 1500], a decoder
               prefill's [1, 64]) with its served launches under
               "whisper" in rows 1 and 2; llama-3.2-vision-90b's GEMMs (a
               decode step over the 30-layer cut) and flash row ([1, 600,
               64 over 8, 128], a prefill's 24) with its served launches
               under "vlm" in rows 1 and 2.

The last lines are the card's name and power limit, the kernels line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import HOST_SYNCS, TOLERANCES  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_tiled_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    CHUNKED_FAULTS, ssd_chunked_ref, ssd_kernel_ref, ssd_ref)
from repro_torch.kernels.systolic_gemm import guard as guard_mod  # noqa: E402
from repro_torch.kernels.systolic_gemm import ops as sg_ops  # noqa: E402
from repro_torch.kernels.systolic_gemm import systolic_gemm as sg  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict  # noqa: E402
from repro_torch.roofline.analysis import HBM_PER_CHIP  # noqa: E402
from repro_torch.parallel.compression import BLOCK, compressed_psum  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    batch_sharding, make_constrain, placements, pspec_for_axes, sharded_step)
from repro_torch.train.grad_sync import make_grad_sync, pending  # noqa: E402
from repro_torch.kernels.systolic_gemm.ref import (  # noqa: E402
    epilogue_ref, grouped_systolic_gemm_ref, splitk_partials, systolic_gemm_ref,
    systolic_gemm_t_ref)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models.layers import (apply_norm, apply_rope, embed,  # noqa: E402
                                       cross_entropy_loss, pod_dense)
from repro_torch.runtime import no_tf32  # noqa: E402
from repro_torch.train import tree as train_tree  # noqa: E402
from repro_torch.train.checkpoint import (restore_checkpoint,  # noqa: E402
                                          save_checkpoint)
from repro_torch.train.data import DataConfig, batches  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,  # noqa: E402
                                         adamw_update, init_adamw)
from repro_torch.train.train_step import (TrainConfig, grads_fn,  # noqa: E402
                                          make_train_step)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import cross_kv_precompute  # noqa: E402
from repro_torch.obs.drift import effective_tops_summary  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.admission import (POLICIES, AdmissionConfig,  # noqa: E402
                                         InvalidRequest,
                                         WaveLatencyPredictor)
from repro_torch.serve.chaos import (ChaosConfig, TransientDeviceError,  # noqa: E402
                                     VirtualClock)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.graphs import GraphPool, StepRunner  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from repro_torch.tenancy.trace import ServeTraceRecorder  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # CUDA cores, outside the tensor cores

ARCH = "granite-8b"
SLOTS, MAX_LEN, DECODE_CHUNK, MAX_NEW = 4, 512, 8, 16
N_REQUESTS = 6
ORACLE_LAYERS = 2       # depth at which the engine/oracle margin rule holds
GEMMS_PER_LAYER = ("q", "k", "v", "o", "gate", "up", "down")
# the paged engine: a pool of half the dense 4 x 2048 / 16 = 512 pages
PAGED = dict(slots=4, max_len=2048, decode_chunk=8, paged=True, page_size=16,
             kv_pages=256)
N_PAGED_REQUESTS = 8
PAGED_MAX_PROMPT = 1500
# mamba2: the paged phase's traffic on a dense lane-resident SSM cache
SSM_ARCH = "mamba2-370m"
SSM_SERVE = dict(slots=4, max_len=2048, decode_chunk=8)
# dbrx-132b at full width, depth cut to 8 of 40 layers: 54.6 GB of bf16
# weights on one 80 GB card (all 40 layers hold 264 GB: four cards and
# expert parallelism). The paged phase's traffic, exact-length prefill.
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 8
MOE_SERVE = dict(slots=4, max_len=2048, decode_chunk=8)
MOE_ORACLE_REQUESTS = 4     # = slots: every decode batch fully live
# deepseek-v2-236b at full width, depth cut to 8 of 60 layers: dense0 and
# 7 MoE layers of 160 experts, 58.4 GB of bf16 weights (all 60 layers hold
# 472 GB). MLA stays on einsums, as in the reference; exact-length
# prefill on the paged phase's traffic, as dbrx
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 8
MLA_SERVE = dict(slots=4, max_len=2048, decode_chunk=8)
# hymba-1.5b at full width and depth (32 layers, 1.64 G parameters): the
# paged phase's traffic, dense and paged for its three global layers
HYBRID_ARCH = "hymba-1.5b"
HYBRID_GEMMS_PER_LAYER = len(GEMMS_PER_LAYER)   # the SSM's in/out are einsums
# whisper-small at full width and depth (12 encoder and 12 decoder layers,
# 0.278 G parameters): 1500 frames (30 s of audio) and 448 decoder
# positions, whisper's published n_audio_ctx and n_text_ctx
# (arXiv:2212.04356); each request carries its own bf16 frames
AUDIO_ARCH = "whisper-small"
AUDIO_SERVE = dict(slots=4, max_len=448, src_len=1500, decode_chunk=8)
N_AUDIO_REQUESTS = 8
# whisper's start of transcript: <|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|> in its multilingual vocabulary
AUDIO_PREFIX = (50258, 50259, 50359, 50363)
# the pod GEMMs of an encoder layer and of a decoder layer (the cross
# attention's projections are einsums, as in the reference)
AUDIO_GEMMS_PER_LAYER = ("q", "k", "v", "o", "up", "down")
# llama-3.2-vision-90b at full width, depth cut to 30 of 100 layers in
# whole groups (6 groups of 4 dense layers and a cross layer), 55.7 GB of
# bf16 weights (all 100 layers hold 175.5 GB: several cards); 1601 image
# tokens a request (src_len 0: the cross cache takes the config's
# n_image_tokens), each request with its own bf16 image embeddings (the
# vision tower is a stub, as in the reference)
VLM_ARCH, VLM_LAYERS = "llama-3.2-vision-90b", 30
VLM_SERVE = dict(slots=4, max_len=1024, decode_chunk=8)
N_VLM_REQUESTS = 8
VLM_MAX_PROMPT = 600
# the pod GEMMs of a cross layer: its MLP (the cross attention's q/k/v/o
# and img_adapter are einsums, as in the reference); a dense layer's are
# GEMMS_PER_LAYER
VLM_CROSS_GEMMS_PER_LAYER = ("gate", "up", "down")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

def phase_build() -> None:
    """Every kernel builds at once, one nvcc each."""
    t0 = time.perf_counter()
    libs = (sg._lib, fa._lib, ssd_mod._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in ("systolic_gemm", "flash_attention", "ssd"):
        info = _build.build_info(name)
        ptxas[name] = {"seconds": info["seconds"], "report": [
            ln.strip() for ln in info["ptxas"].splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]}
    emit("build", seconds=seconds, ptxas=ptxas, torch=torch.__version__,
         cuda=torch.version.cuda, gpu=gpu_name_and_power())


# --------------------------------------------------------------------------
# 2. kernel vs plain
# --------------------------------------------------------------------------

def gemm_inputs(M, K, N, dtype, g, transposed: bool = False):
    """x [M, K] and w [K, N], or w [N, K] when transposed."""
    dev = "cuda"
    w_shape = (N, K) if transposed else (K, N)
    if dtype == torch.int8:
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, w_shape, generator=g, device=dev,
                          dtype=torch.int8)
    else:
        # the model's fan-in scale keeps outputs O(1)
        x = torch.randn((M, K), generator=g, device=dev).to(dtype)
        w = (torch.randn(w_shape, generator=g, device=dev)
             / math.sqrt(K)).to(dtype)
    return x, w


def tolerance(dtype, out_dtype, activation):
    """int8 products are exact; an epilogue (scale, bias, exp or tanh) may
    round differently in the kernel and in torch."""
    if dtype == torch.int8:
        return TOLERANCES["gemm_int8_exact" if activation is None
                          else "gemm_int8_epilogue"]
    if out_dtype == torch.bfloat16:
        return TOLERANCES["gemm_bf16out"]
    if dtype == torch.bfloat16:
        return TOLERANCES["gemm_bf16_f32out"]
    return TOLERANCES["gemm_f32"]


def bf16_summed(x, w, k_step: int = 16) -> torch.Tensor:
    """Planted control: the plain version with its partial sums rounded to
    bf16 every k_step terms (one mma's K), as a kernel that accumulates in
    bf16 would. The tolerances must reject it."""
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for k0 in range(0, x.shape[1], k_step):
        part = x[:, k0:k0 + k_step].float() @ w[k0:k0 + k_step].float()
        acc = (acc + part).to(torch.bfloat16).float()
    return acc


# (M, K, N) at the bf16 mainloops' edges: wgmma one row past a 64-row
# half (65) and a 128-row tile (129), at dbrx's prime M = 1277, with N =
# 1032 (TMA-aligned, not a tile multiple) and K = 4104 (not a multiple of
# 64); at M = 1000, N = K = 4104 (6 split ranges, the last short);
# splitk where the 129 k-steps of K = 4104 do not split evenly (13
# splits of 10, the last of 9), at M = 4 and 29 rows; hymba-1.5b's
# untied head, N = 32001 (not a multiple of 8: wmma), at decode and at a
# prefill-sized M
KERNEL_EDGES = [(65, 1024, 1032), (129, 4104, 4096), (1277, 4104, 1032),
                (1000, 4104, 4104), (4, 4104, 4096), (29, 4104, 1032),
                (4, 1600, 32001), (1024, 1600, 32001)]
# where the split-K controls must fail, (M, K, N) at decode: NN at
# granite-8b's q and head; NT at mamba2's head (one split) and where 129
# k-steps split 13 ways, the last range short
SPLITK_CONTROL_SHAPES = {"nn": [(4, 4096, 4096), (4, 4096, 49152)],
                         "nt": [(4, 1024, 50280), (4, 4104, 1032)]}


def phase_kernel() -> dict:
    """A ragged small case, granite-8b's shapes, and dbrx-132b's q/o, k/v
    and untied head at decode (M = 4 lanes) and at its longest served
    exact-length prefill (M = 1277 rows, a prime); deepseek-v2's untied
    head at decode ([4, 5120] x [5120, 102400]); the mainloop edges of
    KERNEL_EDGES; then the split-K controls and the row checks of every
    form."""
    gemm_phase("kernel", sg.systolic_gemm_cuda, systolic_gemm_ref,
               [(37, 100, 130), (1, 4096, 14336), (5, 4096, 49152),
                (4, 6144, 6144), (4, 6144, 1024), (4, 6144, 100352),
                (1277, 6144, 6144), (1277, 6144, 1024),
                (1277, 6144, 100352), (4, 5120, 102400)] + KERNEL_EDGES,
               transposed=False, seed=1)
    splitk_controls("nn", seed=14)
    rows_independent_of_m(seed=15)
    dense = dense_arch_gemms(seed=23)
    emit("kernel_dense_archs", **dense)
    check(not dense["failures"],
          f"{len(dense['failures'])} dense-arch GEMM checks failed")
    return dense


# the dense archs' served GEMMs (bf16, out bf16 as served): minitron-8b's
# up with relu2 in the epilogue at decode and at a [4, 2048] prefill, and
# nemotron-4-340b's at decode (its v as its k)
DENSE_ARCH_GEMMS = [
    ("minitron-8b", "up", SLOTS, 4096, 16384, "relu2"),
    ("minitron-8b", "up", SLOTS * 2048, 4096, 16384, "relu2"),
    ("nemotron-4-340b", "q", SLOTS, 18432, 18432, None),
    ("nemotron-4-340b", "k", SLOTS, 18432, 1536, None),
    ("nemotron-4-340b", "o", SLOTS, 18432, 18432, None),
    ("nemotron-4-340b", "up", SLOTS, 18432, 73728, "relu2"),
    ("nemotron-4-340b", "down", SLOTS, 73728, 18432, None),
    ("nemotron-4-340b", "head", SLOTS, 18432, 256000, None),
]
# whisper-small's: the encoder's at M = 1500 frames (q as k, v and o; up
# with GELU in the epilogue; down) on wgmma, the decoder's at decode (M =
# 4) on splitk, and the untied head (N = 51865, odd: wmma) at decode and
# at the longest served prompt, 64 tokens
AUDIO_GEMMS = [
    ("whisper-small", "enc_q", 1500, 768, 768, None),
    ("whisper-small", "enc_up", 1500, 768, 3072, "gelu"),
    ("whisper-small", "enc_down", 1500, 3072, 768, None),
    ("whisper-small", "q", SLOTS, 768, 768, None),
    ("whisper-small", "up", SLOTS, 768, 3072, "gelu"),
    ("whisper-small", "down", SLOTS, 3072, 768, None),
    ("whisper-small", "head", SLOTS, 768, 51865, None),
    ("whisper-small", "head_prefill", 64, 768, 51865, None),
]
# llama-3.2-vision-90b's at decode (M = 4, splitk): q and o [8192 ->
# 8192], k (as v) [8192 -> 1024], gate with SiLU (as up) [8192 -> 28672],
# down and the untied 128256-row head; and up at its longest served
# prompt (M = 600, wgmma)
VLM_GEMMS = [
    (VLM_ARCH, "q", SLOTS, 8192, 8192, None),
    (VLM_ARCH, "k", SLOTS, 8192, 1024, None),
    (VLM_ARCH, "o", SLOTS, 8192, 8192, None),
    (VLM_ARCH, "gate", SLOTS, 8192, 28672, "silu"),
    (VLM_ARCH, "down", SLOTS, 28672, 8192, None),
    (VLM_ARCH, "head", SLOTS, 8192, 128256, None),
    (VLM_ARCH, "up_prefill", VLM_MAX_PROMPT, 8192, 28672, None),
]


def torch_activation(y: torch.Tensor, act) -> torch.Tensor:
    """The epilogue's activation in torch ops, after a torch.matmul."""
    if act == "relu2":
        return torch.square(torch.relu(y))
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "silu":
        return F.silu(y)
    return y


def dense_arch_gemms(seed: int) -> dict:
    """DENSE_ARCH_GEMMS, AUDIO_GEMMS and VLM_GEMMS on the pod GEMM against
    its plain version, bf16 out (gemm_bf16out) and f32 out
    (gemm_bf16_f32out), each timed with L2 flushed beside its plain
    version, torch.matmul with the same activation, and its bound, with
    its mainloop; nemotron's decode step summed over its 4 served layers
    and head, whisper's encoder pass and decode step over its 12 layers
    (and the head), llama-3.2-vision's decode step over its 24 dense and 6
    cross layers at the 30-layer cut (and the head; v counted at k's
    time, up at gate's: the same shapes)."""
    g = torch.Generator("cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, failures = [], []
    for arch, name, M, K, N, act in DENSE_ARCH_GEMMS + AUDIO_GEMMS + \
            VLM_GEMMS:
        x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
        row = {"arch": arch, "gemm": name, "M": M, "K": K, "N": N,
               "activation": act,
               "plan": list(sg.nn_plan(M, N, K, torch.bfloat16, True))}
        for out_dtype, tol_name in ((torch.bfloat16, "gemm_bf16out"),
                                    (torch.float32, "gemm_bf16_f32out")):
            got = sg.systolic_gemm_cuda(x, w, activation=act,
                                        out_dtype=out_dtype)
            ref = systolic_gemm_ref(x, w, activation=act,
                                    out_dtype=out_dtype)
            tol = TOLERANCES[tol_name]
            excess = tol.excess(got, ref)
            row[f"excess_{tol_name}"] = excess
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), float(
                (got.double() - ref.double()).abs().max()))
            if not excess <= 1.0:
                failures.append(f"{arch} {name} {M}x{K}x{N} {tol_name} "
                                f"excess {excess}")
            del got, ref

        def library(x=x, w=w, act=act):
            return torch_activation(torch.matmul(x, w), act)
        iters = 10 if M <= 64 else 3
        row["ms"] = time_ms(lambda: sg.systolic_gemm_cuda(
            x, w, activation=act, out_dtype=torch.bfloat16), iters, flush)
        row["plain_ms"] = time_ms(lambda: systolic_gemm_ref(
            x, w, activation=act, out_dtype=torch.bfloat16), 2, flush)
        row["library_ms"] = time_ms(library, iters, flush)
        row["bound_ms"], row["bound_by"] = bound(
            2 * M * N * K, 2 * (M * K + K * N + M * N))
        rows.append(row)
        del x, w
    nem = {r["gemm"]: r for r in rows if r["arch"] == "nemotron-4-340b"}
    layers = dict(DENSE_ARCHS)["nemotron-4-340b"]
    per_layer = {"q": 1, "k": 2, "o": 1, "up": 1, "down": 1}
    decode = {key: layers * sum(n * nem[g][key] for g, n in
                                per_layer.items()) + nem["head"][key]
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    wh = {r["gemm"]: r for r in rows if r["arch"] == AUDIO_ARCH}
    L = get_arch(AUDIO_ARCH).n_layers
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    whisper = {
        "rows": [r for r in rows if r["arch"] == AUDIO_ARCH],
        "encoder_pass": {"gemms": 6 * L, **{k: L * (
            4 * wh["enc_q"][k] + wh["enc_up"][k] + wh["enc_down"][k])
            for k in keys}},
        "decode_step": {"gemms": 6 * L + 1, **{k: L * (
            4 * wh["q"][k] + wh["up"][k] + wh["down"][k]) + wh["head"][k]
            for k in keys}}}
    vl = {r["gemm"]: r for r in rows if r["arch"] == VLM_ARCH}
    vcfg = dataclasses.replace(get_arch(VLM_ARCH), n_layers=VLM_LAYERS)
    groups = VLM_LAYERS // vcfg.cross_attn_every
    dense_layers = VLM_LAYERS - groups
    vlm = {
        "rows": [r for r in rows if r["arch"] == VLM_ARCH],
        "decode_step": {
            "n_layers": VLM_LAYERS, "dense_layers": dense_layers,
            "cross_layers": groups,
            "gemms": len(GEMMS_PER_LAYER) * dense_layers
            + len(VLM_CROSS_GEMMS_PER_LAYER) * groups + 1,
            **{k: dense_layers * (vl["q"][k] + 2 * vl["k"][k] + vl["o"][k]
                                  + 2 * vl["gate"][k] + vl["down"][k])
               + groups * (2 * vl["gate"][k] + vl["down"][k])
               + vl["head"][k] for k in keys}}}
    return {"rows": [r for r in rows
                     if r["arch"] not in (AUDIO_ARCH, VLM_ARCH)],
            "nemotron_decode_step": {
                "n_layers": layers, "gemms": 6 * layers + 1, **decode},
            "whisper": whisper, "vlm": vlm, "failures": failures}



def last_split_dropped(x, w, splits: int) -> torch.Tensor:
    """Planted control: the splitk mainloop's partials summed in split
    order, the last split's left out (a reduction that misses one
    arrival)."""
    parts = splitk_partials(x, w, splits)[:-1]
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for p in parts:
        acc = acc + p
    return acc


def stale_w_tile(x, w, k_step: int) -> torch.Tensor:
    """Planted control: k-step i's products taken with k-step i - 1's w
    tile (a ring slot read before its load landed); step 0 keeps its own."""
    shifted = torch.cat([w[:k_step], w[:-k_step]])
    with no_tf32():
        return x.float() @ shifted.float()


# (form, G, K, N, rows M of x, the largest first): granite-8b's q and
# dbrx-132b's k projections (NN: wgmma at 256 and 65, splitk at 57, 4
# and 1), mamba2-370m's tied head (NT, the same), dbrx's up projection
# over its 16 experts (grouped: wgmma at every M, its ragged capacities)
ROW_CHECK_MS = (256, 65, 57, 4, 1)
ROW_CHECKS = [("nn", 1, 4096, 4096, ROW_CHECK_MS),
              ("nn", 1, 6144, 1024, ROW_CHECK_MS),
              ("nt", 1, 1024, 50280, ROW_CHECK_MS),
              ("grouped", 16, 6144, 10752, (399, 320, 129, 65))]
KERNELS = {"nn": sg.systolic_gemm_cuda, "nt": sg.systolic_gemm_nt_cuda,
           "grouped": sg.grouped_systolic_gemm_cuda}


def rows_independent_of_m(seed: int) -> None:
    """A row's result must not depend on M, across mainloops: the first M
    rows of x (of every group) give bit-equal outputs, as the engine
    (bucketed prefill, M = 4 x bucket; decode, M = 4) and the per-token
    oracle (M = S; M = 1) need, and as dbrx's experts see capacities that
    change with the prompt."""
    g = torch.Generator("cuda").manual_seed(seed)
    rows, failures = [], []
    for form, G, K, N, Ms in ROW_CHECKS:
        kernel = KERNELS[form]
        if form == "grouped":
            x, w = grouped_inputs(G, max(Ms), K, N, torch.bfloat16, g)
        else:
            x, w = gemm_inputs(max(Ms), K, N, torch.bfloat16, g,
                               transposed=form == "nt")
        for out_dtype in (torch.float32, torch.bfloat16):
            full = kernel(x, w, out_dtype=out_dtype)
            for M in Ms[1:]:
                part = kernel(x[..., :M, :].contiguous(), w,
                              out_dtype=out_dtype)
                torch.cuda.synchronize()
                row = {"form": form, "G": G, "K": K, "N": N, "M": M,
                       "out": str(out_dtype)[6:],
                       "mainloops": [sg.gemm_plan(form, m, N, K,
                                                  torch.bfloat16,
                                                  True).mainloop
                                     for m in (max(Ms), M)],
                       "bit_equal": torch.equal(part, full[..., :M, :])}
                if not row["bit_equal"]:
                    failures.append(f"rows depend on M: {row}")
                rows.append(row)
            del full
        del x, w
    emit("kernel_rows", rows=rows, failures=failures)
    check(not failures, f"{len(failures)} row-independence checks failed")


def splitk_controls(form: str, seed: int) -> None:
    """At SPLITK_CONTROL_SHAPES[form] (bf16, both output types): the
    kernel within tolerance, both split-K controls outside it (NT's w
    [N, K] planted through its [K, N] view)."""
    g = torch.Generator("cuda").manual_seed(seed)
    nt = form == "nt"
    kernel, plain = ((sg.systolic_gemm_nt_cuda, systolic_gemm_t_ref) if nt
                     else (sg.systolic_gemm_cuda, systolic_gemm_ref))
    rows, failures = [], []
    for (M, K, N) in SPLITK_CONTROL_SHAPES[form]:
        x, w = gemm_inputs(M, K, N, torch.bfloat16, g, transposed=nt)
        wkn = w.t() if nt else w
        plan = sg.gemm_plan(form, M, N, K, torch.bfloat16, True)
        planted = {"last_split_dropped": last_split_dropped(x, wkn,
                                                            plan.splits),
                   "stale_w_tile": stale_w_tile(x, wkn, sg.SPLITK_K_STEP)}
        for out_dtype in (torch.float32, torch.bfloat16):
            tol = tolerance(torch.bfloat16, out_dtype, None)
            got = kernel(x, w, out_dtype=out_dtype)
            ref = plain(x, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            row = {"form": form, "shape": [M, K, N], "plan": list(plan),
                   "out": str(out_dtype)[6:], "kernel": tol.excess(got, ref)}
            if not row["kernel"] <= 1.0:
                failures.append(f"kernel disagrees with plain {row}")
            for name, acc in planted.items():
                row[name] = tol.excess(epilogue_ref(acc).to(out_dtype), ref)
                if not row[name] > 1.0:
                    failures.append(f"{name} control passes {row}")
            rows.append(row)
    emit("kernel_controls" if form == "nn" else f"{form}_controls",
         rows=rows, failures=failures)
    check(not failures, f"{len(failures)} {form} split-K control checks "
                        f"failed")


# (M, K, N) of the NT form at mamba2's head (K 1024, N 50280: a 104-column
# tail past the last 128-wide tile): wgmma one row past a 64-row half (65)
# and a 128-row tile (129), at 300 and at 1277 (prime); splitk at 4 and
# 29 rows. Where the 129 k-steps of K = 4104 split 13 ways (the last
# range short): splitk at 29 rows, wgmma at 1277.
NT_EDGES = [(65, 1024, 50280), (129, 1024, 50280), (300, 1024, 50280),
            (1277, 1024, 50280), (29, 1024, 50280), (29, 4104, 1032),
            (1277, 4104, 1032)]


def phase_gemm_nt() -> None:
    """mamba2's tied head at decode, [4, 1024] x [50280, 1024]^T, a ragged
    prefill-sized M with a ragged K (wmma), the mainloop edges of
    NT_EDGES; then the NT split-K controls."""
    gemm_phase("gemm_nt", sg.systolic_gemm_nt_cuda, systolic_gemm_t_ref,
               [(37, 100, 130), (4, 1024, 50280), (300, 1000, 50280)]
               + NT_EDGES, transposed=True, seed=5)
    splitk_controls("nt", seed=16)


def gemm_phase(phase: str, kernel, plain, shapes, *, transposed: bool,
               seed: int) -> None:
    """Every case is read before any verdict, so one failing run shows
    all of them. `excess` is max |got - ref| / (atol + rtol |ref|): the
    kernel must stay at or below 1, the bf16-summing control above it."""
    g = torch.Generator("cuda").manual_seed(seed)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, dict] = {}
    mainloops = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for (M, K, N) in shapes:
            x, w = gemm_inputs(M, K, N, dtype, g, transposed)
            plan = sg.gemm_plan("nt" if transposed else "nn", M, N, K, dtype,
                                True)
            mainloops[f"{str(dtype)[6:]} {M}x{K}x{N}"] = list(plan)
            scale = torch.rand(N, generator=g, device="cuda") + 0.5
            bias = torch.randn(N, generator=g, device="cuda")
            for act in sg.ACTIVATIONS:
                for out_dtype in (torch.float32, torch.bfloat16):
                    # the epilogue with and without scale/bias
                    sb = (scale, bias) if act is not None else (None, None)
                    got = kernel(x, w, *sb, activation=act,
                                 out_dtype=out_dtype)
                    ref = plain(x, w, *sb, activation=act,
                                out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    tol = tolerance(dtype, out_dtype, act)
                    err = float((got.double() - ref.double()).abs().max())
                    excess = tol.excess(got, ref)
                    key = f"{str(dtype)[6:]}->{str(out_dtype)[6:]}"
                    row = worst.setdefault(key, {"max_abs_err": 0.0,
                                                 "excess": 0.0})
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    row["excess"] = max(row["excess"], excess)
                    case = (f"{key} {M}x{K}x{N} act={act} max_abs_err={err} "
                            f"excess={excess} ({tol})")
                    if not bool(torch.isfinite(got.float()).all()):
                        failures.append("non-finite kernel output " + case)
                    elif not excess <= 1.0:
                        failures.append("kernel disagrees with plain " + case)
                    if act is None and dtype != torch.int8:
                        planted = bf16_summed(
                            x, w.t() if transposed else w).to(out_dtype)
                        c = tol.excess(planted, ref)
                        row = control.setdefault(key, {"min_excess": c,
                                                       "max_abs_err": 0.0})
                        row["min_excess"] = min(row["min_excess"], c)
                        row["max_abs_err"] = max(row["max_abs_err"], float(
                            (planted.double() - ref.double()).abs().max()))
                        if c <= 1.0:
                            failures.append("bf16-summing control passes "
                                            f"{key} {M}x{K}x{N} excess={c}")
                    cases += 1
    emit(phase, cases=cases, worst=worst, control=control,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("gemm")}, mainloops=mainloops,
         failures=failures)
    check(not failures, f"{len(failures)} {phase} checks failed")


# --------------------------------------------------------------------------
# 3. flash attention vs plain
# --------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, kv_len
    # the six cases of tests/test_kernels.py
    (2, 64, 64, 4, 2, 32, True, None, None),
    (1, 100, 100, 8, 8, 16, True, None, None),
    (2, 33, 33, 4, 1, 64, False, None, None),
    (1, 128, 128, 5, 5, 32, True, 48, None),
    (1, 256, 256, 16, 2, 64, True, None, None),
    (1, 80, 80, 6, 3, 128, True, 16, None),
    # granite-8b's heads, at a tile multiple and ragged
    (2, 256, 256, 32, 8, 128, True, None, None),
    (2, 333, 333, 32, 8, 128, True, None, None),
    # Sq != Skv (positions from 0 on both), a kv_len tail, D = 192
    (2, 300, 200, 8, 2, 64, True, None, None),
    (2, 100, 300, 8, 2, 64, False, None, 250),
    (1, 200, 200, 8, 8, 192, True, None, None),
    # dbrx-132b's exact-length prefills: 48 q heads over 8 KV heads (6 per
    # group), D 128, its longest (prime) and shortest served prompts
    (1, 1277, 1277, 48, 8, 128, True, None, None),
    (1, 29, 29, 48, 8, 128, True, None, None),
    # the wgmma mainloop's edges (128-row q tiles, 128-key tiles): S below,
    # at and just past a tile; Sq != Skv with a kv_len tail inside a key
    # tile and on a tile edge; a window across two key tiles; B > 1 with
    # ragged S (a tile that reaches past S must not read the next batch)
    (1, 127, 127, 8, 2, 128, True, None, None),
    (1, 128, 128, 8, 2, 128, True, None, None),
    (1, 129, 129, 8, 2, 128, True, None, None),
    (2, 129, 257, 8, 2, 128, True, None, 200),
    (2, 300, 384, 8, 2, 128, False, None, 256),
    (1, 512, 512, 8, 2, 128, True, 200, None),
    (2, 384, 384, 4, 4, 64, True, 130, None),
    (3, 200, 200, 8, 2, 128, True, None, None),
    (3, 150, 150, 4, 2, 64, False, None, None),
    # hymba-1.5b's heads (25 q heads over 5, D 64): its 1024-token window
    # at the largest bucket and its longest prompt (windowed layers), and
    # the largest bucket global (its three global layers)
    (4, 2048, 2048, 25, 5, 64, True, 1024, None),
    (1, 1277, 1277, 25, 5, 64, True, 1024, None),
    (4, 2048, 2048, 25, 5, 64, True, None, None),
    # whisper-small's encoder: 12 heads over 12 (G = 1), D 64, non-causal
    # over its 1500 frames (11 key tiles of 128 and a ragged 92)
    (1, 1500, 1500, 12, 12, 64, False, None, None),
    # llama-3.2-vision-90b's dense layers: 64 heads over 8 (G = 8), D 128,
    # causal at its longest served prompt
    (1, VLM_MAX_PROMPT, VLM_MAX_PROMPT, 64, 8, 128, True, None, None),
]


def pv_summed_in_bf16(q, k, v, block_k: int) -> torch.Tensor:
    """Planted control: flash_attention_tiled_ref (causal) with its PV
    accumulator rounded to bf16 after every KV tile, as a kernel that sums
    PV in bf16 would. Its error grows with the tiles a row has seen."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qs = (q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype,
                           device=q.device)).float()
    qs = qs.reshape(B, S, Hkv, Hq // Hkv, D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hkv, Hq // Hkv, S, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, S, D), device=q.device)
    with no_tf32():
        for k0 in range(0, S, block_k):
            k_pos = k0 + torch.arange(min(block_k, S - k0),
                                      device=q.device)[None, :]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs,
                             k[:, k0:k0 + block_k].float())
            s = torch.where(k_pos <= q_pos, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = (acc * corr + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                v[:, k0:k0 + block_k].float())).to(torch.bfloat16).float()
            m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def flash_served_shape(g) -> dict:
    """The kernel at granite-8b's served prefill shape, [4, 2048, 32, 128]
    bf16 causal, on randn inputs, against the Pallas kernel's arithmetic
    (flash_bf16_tiled_served) and the naive version (flash_bf16). Two
    controls err on late KV tiles only, which a causal row sees among ~1000
    others: the last K tile read stale (the one before it, as a cp.async
    race would leave it) and PV summed in bf16. Both must fail
    flash_bf16_tiled_served; their excess at flash_bf16 is reported, and
    the tiled version's own against its scores summed in f64 (the floor
    that two right kernels share) at flash_bf16_tiled and the served
    tolerance."""
    B, S, Hq, Hkv, D = 4, 2048, 32, 8, 128
    bk = fa.flash_plan(D, torch.bfloat16).block_k
    q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    tiled = flash_attention_tiled_ref(q, k, v, causal=True, block_k=bk)
    naive = flash_attention_ref(q, k, v, causal=True)
    stale = k.clone()
    stale[:, S - bk:] = k[:, S - 2 * bk:S - bk]
    controls = {
        "stale_last_k_tile": flash_attention_tiled_ref(q, stale, v,
                                                       causal=True,
                                                       block_k=bk),
        "pv_summed_in_bf16": pv_summed_in_bf16(q, k, v, bk)}
    other_order = flash_attention_tiled_ref(q, k, v, causal=True,
                                            block_k=bk,
                                            score_dtype=torch.float64)
    tight, loose = (TOLERANCES["flash_bf16_tiled_served"],
                    TOLERANCES["flash_bf16"])
    one_ulp = TOLERANCES["flash_bf16_tiled"]
    out = {"shape": [B, S, Hq, D],
           "excess_vs_tiled": tight.excess(got, tiled),
           "excess_vs_tiled_at_flash_bf16_tiled": one_ulp.excess(got, tiled),
           "plain_vs_itself_f64_scores": {
               "at_flash_bf16_tiled": one_ulp.excess(tiled, other_order),
               "at_flash_bf16_tiled_served": tight.excess(tiled,
                                                          other_order)},
           "excess_vs_naive": loose.excess(got, naive),
           "max_abs_err_vs_tiled": float((got.double() - tiled.double())
                                         .abs().max()),
           "controls": {n: {"excess_vs_tiled": tight.excess(c, tiled),
                            "excess_at_flash_bf16": loose.excess(c, naive)}
                        for n, c in controls.items()}}
    return out


def flash_rows_alone_and_bucketed(g) -> list[dict]:
    """A prompt's rows prefilled alone ([1, S], as the exact-length engine
    and the oracle do) and in lane 2 of a [4, 2S] bucket beside other
    lanes (as the bucketed engine does) must be bit-equal: the key tile
    comes from D alone, and a row's arithmetic from its own q row and
    keys. At granite-8b's heads (32 over 8) and dbrx-132b's (48 over 8),
    D 128, causal."""
    out = []
    for S, Hq, Hkv in ((957, 32, 8), (1277, 48, 8)):
        q, k, v = (torch.randn((SLOTS, 2 * S, h, 128), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        alone = fa.flash_attention_cuda(
            *(x[2:3, :S].contiguous() for x in (q, k, v)), causal=True)
        bucket = fa.flash_attention_cuda(q, k, v, causal=True)[2:3, :S]
        out.append({"S": S, "bucket": [SLOTS, 2 * S], "Hq": Hq, "Hkv": Hkv,
                    "mainloop": fa.flash_plan(128, q.dtype).mainloop,
                    "equal": bool(torch.equal(alone, bucket)),
                    "max_abs_diff": float((alone.float() - bucket.float())
                                          .abs().max())})
    return out


def plain_masked(q, k, v, ok, kv_head):
    """The plain version's arithmetic with a given [Sq, Skv] mask and
    q-head -> kv-head map; the planted controls take a wrong one of each."""
    qs = q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                          device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:, :, kv_head]).float()
    p = torch.softmax(torch.where(ok, s, -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v[:, :, kv_head]).to(q.dtype)


def phase_flash() -> dict:
    """Every case is read before any verdict. The kernel's `excess` must
    stay at or below 1 in each class; each control's must exceed 1 in every
    case where it differs from the right mask (causal cases for the
    off-by-one mask, G > 1 and Hkv > 1 for the head map) and, at the served
    shape, on late tiles."""
    g = torch.Generator("cuda").manual_seed(3)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, dict] = {}
    by_mainloop: dict[str, int] = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCES["flash_f32" if dtype == torch.float32
                         else "flash_bf16"]
        cls = str(dtype)[6:]
        for (B, Sq, Skv, Hq, Hkv, D, causal, window, kv_len) in FLASH_CASES:
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                 (B, Skv, Hkv, D)))
            plan = fa.flash_plan(D, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, kv_len=kv_len)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len)
            torch.cuda.synchronize()
            err = float((got.double() - ref.double()).abs().max())
            excess = tol.excess(got, ref)
            row = worst.setdefault(cls, {"max_abs_err": 0.0, "excess": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["excess"] = max(row["excess"], excess)
            by_mainloop[plan.mainloop] = by_mainloop.get(plan.mainloop, 0) + 1
            case = (f"{cls} q{(B, Sq, Hq, D)} kv{(Skv, Hkv)} causal={causal} "
                    f"window={window} kv_len={kv_len} {plan} "
                    f"max_abs_err={err} excess={excess} ({tol})")
            if not bool(torch.isfinite(got.float()).all()):
                failures.append("non-finite kernel output " + case)
            elif not excess <= 1.0:
                failures.append("kernel disagrees with plain " + case)
            if dtype == torch.bfloat16:
                tiled = flash_attention_tiled_ref(
                    q, k, v, causal=causal, window=window, kv_len=kv_len,
                    block_k=plan.block_k)
                te = TOLERANCES["flash_bf16_tiled_served"].excess(got,
                                                                  tiled)
                row = worst.setdefault(f"bfloat16 {plan.mainloop} vs tiled",
                                       {"excess": 0.0})
                row["excess"] = max(row["excess"], te)
                if not te <= 1.0:
                    failures.append(f"kernel disagrees with tiled plain "
                                    f"{case} excess_vs_tiled={te}")
            # planted controls, on the same inputs
            qp = torch.arange(Sq, device="cuda")[:, None]
            kp = torch.arange(Skv, device="cuda")[None, :]
            ok = kp < (Skv if kv_len is None else kv_len)
            if window is not None:
                ok = ok & (qp - kp < window)
            heads = torch.arange(Hq, device="cuda")
            planted = {}
            if causal:
                planted["causal_off_by_one"] = plain_masked(
                    q, k, v, ok & (kp < qp), heads // (Hq // Hkv))
            if Hq // Hkv > 1 and Hkv > 1:
                planted["gqa_h_mod_hkv"] = plain_masked(
                    q, k, v, ok & (kp <= qp) if causal else ok, heads % Hkv)
            for name, out in planted.items():
                c = tol.excess(out, ref)
                row = control.setdefault(f"{name} {cls}", {"min_excess": c})
                row["min_excess"] = min(row["min_excess"], c)
                if not c > 1.0:
                    failures.append(f"control {name} passes: {case} "
                                    f"control excess={c}")
            cases += 1
    served = flash_served_shape(g)
    if not served["excess_vs_tiled"] <= 1.0 or \
            not served["excess_vs_naive"] <= 1.0:
        failures.append(f"kernel disagrees at the served shape {served}")
    for name, c in served["controls"].items():
        if not c["excess_vs_tiled"] > 1.0:
            failures.append(f"late-tile control {name} passes "
                            f"flash_bf16_tiled_served: {c}")
    rows = flash_rows_alone_and_bucketed(g)
    failures += [f"rows differ alone and in a bucket: {r}" for r in rows
                 if not r["equal"]]
    # nemotron-4-340b's prefill heads (96 over 8, D 192) at a [4, 2048]
    # bucket: the mma mainloop, against both plain versions and SDPA
    nemotron = flash_row(SLOTS, 2048, 96, 8, 192, 5, g, torch.empty(
        64 * 2 ** 20, dtype=torch.int32, device="cuda"))
    if nemotron["mainloop"] != "mma":
        failures.append(f"nemotron's D = 192 ran {nemotron['mainloop']}")
    emit("flash", cases=cases + 2, by_mainloop=by_mainloop, worst=worst,
         control=control, served_shape=served, rows_alone_vs_bucket=rows,
         nemotron=nemotron,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("flash")}, failures=failures)
    check(not failures, f"{len(failures)} flash checks failed")
    return nemotron


# --------------------------------------------------------------------------
# 5. ssd vs plain
# --------------------------------------------------------------------------

# the long-chunk-decay case: mamba2's tiles at chunk 256 with dt and A as
# Mamba-2 initialises them (ssd_inputs, "mamba2_init"), where the state
# carried across a whole chunk survives in the slow heads
SSD_DECAY = (SLOTS, 1024, 32, 64, 1, 128, 256)
# hymba-1.5b's largest prefill: 50 heads of P 64, N 16, chunk 256 (serial)
SSD_HYBRID = (SLOTS, 2048, 50, 64, 1, 16, 256)
SSD_CASES = [
    # b, S, H, P, G, N, chunk, dt law: the four of tests/test_kernels.py
    (2, 64, 4, 16, 1, 32, 16, "softplus"),
    (1, 100, 2, 8, 2, 16, 32, "softplus"),
    (1, 32, 4, 16, 4, 8, 32, "softplus"),
    (2, 48, 8, 32, 1, 64, 16, "softplus"),
    # mamba2-370m's heads: a ragged S, and G > 1
    (2, 1000, 32, 64, 1, 128, 256, "softplus"),
    (2, 512, 32, 64, 4, 128, 256, "softplus"),
    SSD_DECAY + ("mamba2_init",),
    # hymba's, with the served model's dt and with Mamba-2's (where slow
    # heads carry their state across whole chunks)
    SSD_HYBRID + ("softplus",), SSD_HYBRID + ("mamba2_init",),
]
SSD_SERVED = (SLOTS, 2048, 32, 64, 1, 128)   # mamba2's largest prefill
SSD_FAULTS = ("state_not_carried", "mask_after_exp",
              "y_inter_from_updated_state")


def ssd_inputs(shape, dtype, g, device="cuda", dt_law: str = "softplus"):
    """x, B, C randn in dtype; D U(0, 1). dt and A (f32) by `dt_law`:

    * "softplus": dt = softplus(randn) and A = -exp(U(-0.5, 0.5)), as the
      served model's init gives them (dt ~ 0.8, A ~ -1): the exponent
      above a 256-token chunk's diagonal overflows f32, and exp(cum_end)
      of a whole chunk underflows to 0, so no state survives a chunk;
    * "mamba2_init": as Mamba-2's reference implementation initialises
      them by default (arXiv:2405.21060: A = -U(1, 16) per head, dt
      log-uniform in [0.001, 0.1] per head), with a per-token jitter
      exp(N(0, 1/16)) kept in that range. Slow heads (dt |A| well below 0.34) keep exp(cum_end) above 0
      and carry their state across whole chunks; fast ones overflow the
      masked exponent, as "softplus" does."""
    b, S, H, P, G, N = shape
    x = torch.randn((b, S, H, P), generator=g, device=device).to(dtype)
    if dt_law == "softplus":
        dt = F.softplus(torch.randn((b, S, H), generator=g, device=device))
        A = -torch.exp(torch.rand(H, generator=g, device=device) - 0.5)
    elif dt_law == "mamba2_init":
        lo, hi = math.log(1e-3), math.log(1e-1)
        rate = torch.exp(lo + (hi - lo) * torch.rand(
            (b, 1, H), generator=g, device=device))
        jitter = torch.exp(0.25 * torch.randn((b, S, H), generator=g,
                                              device=device))
        dt = (rate * jitter).clamp(1e-3, 1e-1)
        A = -(1 + 15 * torch.rand(H, generator=g, device=device))
    else:
        raise ValueError(f"unknown dt law {dt_law!r}")
    B = torch.randn((b, S, G, N), generator=g, device=device).to(dtype)
    C = torch.randn((b, S, G, N), generator=g, device=device).to(dtype)
    D = torch.rand(H, generator=g, device=device)
    return x, dt, A, B, C, D


def ssd_planted(x, dt, A, B, C, D, *, chunk: int, fault):
    """ssd_kernel_ref's arithmetic (the Pallas kernel's) with one planted
    fault of SSD_FAULTS, or none: the state reset at every chunk; the mask
    applied after exp (exp(seg) * 0 is NaN where exp overflows); y_inter
    taken from the state after this chunk's update instead of h_prev.
    Fault "state_in_bf16" rounds the state and y_inter to x's dtype, as
    ssd_ref does, and nothing else: a control at the served shape only
    (its excess is a max over rows, and a smaller input can pass)."""
    b, S, H, P = x.shape
    pad = (-S) % chunk
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt.float(), (0, 0, 0, pad))
    rep = H // B.shape[2]
    Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, dim=2)
              .float() for t in (B, C))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    h = torch.zeros((b, H, P, Bh.shape[-1]), device=x.device)
    ys = []
    with no_tf32():
        for c0 in range(0, x.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            xf, dtc, Bc, Cc = x[:, sl].float(), dt[:, sl], Bh[:, sl], Ch[:, sl]
            if fault == "state_not_carried":
                h = torch.zeros_like(h)
            cum = torch.cumsum(dtc * A.float(), dim=1)
            seg = cum[:, :, None, :] - cum[:, None, :, :]
            if fault == "mask_after_exp":
                decay = torch.exp(seg) * tri
            else:
                decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)),
                                    0.0)
            M = torch.einsum("bthn,bshn->btsh", Cc, Bc) * decay * \
                dtc[:, None, :, :]
            y = torch.einsum("btsh,bshp->bthp", M.to(x.dtype).float(), xf)
            w = torch.exp(cum[:, -1:, :] - cum) * dtc
            h_new = torch.exp(cum[:, -1, :])[..., None, None] * h + \
                torch.einsum("bshp,bshn->bhpn", xf * w[..., None], Bc)
            if fault == "state_in_bf16":
                h_new = h_new.to(x.dtype).float()
            h_read = h_new if fault == "y_inter_from_updated_state" else h
            y_inter = torch.exp(cum)[..., None] * torch.einsum(
                "bthn,bhpn->bthp", Cc, h_read)
            if fault == "state_in_bf16":
                y_inter = y_inter.to(x.dtype).float()
            y = y + y_inter
            h = h_new
            ys.append((y + D.float()[None, None, :, None] * xf).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h.to(x.dtype)


def ssd_f32_tol(chunk: int):
    """f32 at mamba2-sized chunks sums terms far larger than y's small
    entries: ssd_f32_rows there (its reason), ssd_f32 below."""
    return TOLERANCES["ssd_f32_rows" if chunk >= 128 else "ssd_f32"]


def phase_ssd() -> None:
    """Every case is read before any verdict. The kernel must stay within
    ssd_f32 / ssd_bf16_kernel of ssd_kernel_ref (y and the final state)
    and within ssd_bf16_reference of ssd_ref; at the served shape each
    planted control must exceed ssd_bf16_kernel."""
    g = torch.Generator("cuda").manual_seed(7)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    mainloops: dict[str, str] = {}
    tight_bf16, loose = (TOLERANCES["ssd_bf16_kernel"],
                         TOLERANCES["ssd_bf16_reference"])
    for dtype in (torch.float32, torch.bfloat16):
        cls = str(dtype)[6:]
        for (b, S, H, P, G, N, chunk, law) in SSD_CASES:
            x, dt, A, B, C, D = ssd_inputs((b, S, H, P, G, N), dtype, g,
                                           dt_law=law)
            plan = ssd_mod.ssd_plan(P, N, chunk, dtype)
            before = dict(ssd_mod.ssd_cuda.mainloop_launches)
            got = ssd_ops.ssd(x, dt, A, B, C, D, chunk=chunk)
            ran = [m for m, n in ssd_mod.ssd_cuda.mainloop_launches.items()
                   if n != before[m]]
            mainloops[f"{cls} {(b, S, H, P, G, N, chunk)} {law}"] = plan
            if ran != [plan]:
                failures.append(f"{cls} {(b, S, H, P, G, N, chunk)} {law} "
                                f"ran {ran}, its plan is {plan}")
            # the plain version at the chunk the kernel runs (in f32 at
            # mamba2's tiles: 128-token sub-chunks of the 256 asked for)
            ref = ssd_kernel_ref(x, dt, A, B, C, D, chunk=ssd_mod.run_chunk(
                chunk, P, N, dtype))
            refs = {"kernel_ref": (ref, ssd_f32_tol(chunk)
                                   if dtype == torch.float32 else tight_bf16)}
            if dtype == torch.bfloat16:
                refs["ssd_ref"] = (ssd_ref(x, dt, A, B, C, D, chunk), loose)
            torch.cuda.synchronize()
            for rname, ((ry, rh), tol) in refs.items():
                for out, r, got_t in (("y", ry, got[0]), ("h", rh, got[1])):
                    excess = tol.excess(got_t.float(), r.float())
                    row = worst.setdefault(f"{cls} {out} vs {rname}",
                                           {"excess": 0.0, "max_abs_err": 0.0})
                    row["excess"] = max(row["excess"], excess)
                    row["max_abs_err"] = max(row["max_abs_err"], float(
                        (got_t.double() - r.double()).abs().max()))
                    if not bool(torch.isfinite(got_t.float()).all()) or \
                            not excess <= 1.0:
                        failures.append(f"{cls} {(b, S, H, P, G, N, chunk)} "
                                        f"{law} {out} vs {rname}: excess "
                                        f"{excess}")
            cases += 1
    # mamba2's served prefill in f32: the kernel runs 128-token sub-chunks
    # and is held to the plain version at that chunk; beside it, how far
    # the plain version at 128 and at 256 drift apart in f32 (reported)
    args = ssd_inputs(SSD_SERVED, torch.float32, g)
    sub = ssd_mod.run_chunk(256, SSD_SERVED[3], SSD_SERVED[5], torch.float32)
    got = ssd_ops.ssd(*args, chunk=256)
    ref = ssd_kernel_ref(*args, chunk=sub)
    whole = ssd_kernel_ref(*args, chunk=256)
    torch.cuda.synchronize()
    tol = ssd_f32_tol(256)
    f32_served = {"run_chunk": sub, "tolerance": str(tol), "controls": {}}
    for out, i in (("y", 0), ("h", 1)):
        excess = tol.excess(got[i], ref[i])
        f32_served[out] = {
            "excess": excess, "max_abs_err": float(
                (got[i].double() - ref[i].double()).abs().max()),
            "plain_sub_vs_whole_chunk": tol.excess(ref[i], whole[i]),
            "excess_at_ssd_f32": TOLERANCES["ssd_f32"].excess(got[i], ref[i])}
        if not bool(torch.isfinite(got[i]).all()) or not excess <= 1.0:
            failures.append(f"float32 served {SSD_SERVED} {out}: excess "
                            f"{excess}")
    for fault in ("state_not_carried", "y_inter_from_updated_state"):
        py, _ = ssd_planted(*args, chunk=sub, fault=fault)
        f32_served["controls"][fault] = e = tol.excess(py, ref[0])
        if not e > 1.0:
            failures.append(f"f32 control {fault} passes {tol}: {e}")
    cases += 1
    del args, got, ref, whole
    served = ssd_controls(g, SSD_SERVED, "softplus")
    decay = ssd_controls(g, SSD_DECAY[:6], "mamba2_init")
    for label, case in (("served shape", served), ("decay case", decay)):
        for name, e in case["excess"].items():
            if not e <= 1.0:
                failures.append(f"{label} {name}: excess {e}")
        if case["mainloop"] != "chunked":
            failures.append(f"{label} ran {case['mainloop']}")
        for fault, e in case["controls"].items():
            # a control fails when y or h does; NaN (mask after exp) fails
            if all(v <= 1.0 for v in e.values()):
                failures.append(f"{label}: control {fault} passes "
                                f"ssd_bf16_kernel: {e}")
    # where exp(cum_end) stays above 0, cum carried across chunk
    # boundaries breaks the carried state itself, not only y_inter
    if not decay["controls"]["cum_across_chunks"]["h"] > 1.0:
        failures.append(f"decay case: cum_across_chunks passes on h: "
                        f"{decay['controls']['cum_across_chunks']}")
    same = ssd_rows_and_strides(g)
    failures += [f"{k} not bit-equal: {v}" for k, v in same.items()
                 if not all(v.values())]
    emit("ssd", cases=cases + 2, mainloop_by_case=mainloops, worst=worst,
         served_shape=served, decay_case=decay, bit_equal=same,
         f32_served_shape=f32_served,
         tolerances={k: [t.rtol, t.atol] for k, t in TOLERANCES.items()
                     if k.startswith("ssd")}, failures=failures)
    check(not failures, f"{len(failures)} ssd checks failed")


def ssd_controls(g, shape, dt_law: str) -> dict:
    """The kernel at mamba2's tiles (N = 128, chunk 256, bf16) on inputs
    of `shape` drawn by `dt_law`, against both plain versions, and the
    planted controls against ssd_kernel_ref. Two controls are ssd_ref
    itself and the state and y_inter rounded to bf16: neither may pass
    for the kernel's f32 state. The last two plant faults of the chunked
    mainloop's order (CHUNKED_FAULTS). At the served shape ("softplus")
    every control is gated; at the long-chunk-decay case ("mamba2_init")
    all but the bf16 state, which a small state can pass (ssd_planted):
    it is reported there, with the share of chunks whose exp(cum_end)
    stays above 0 and above 1e-3."""
    args = ssd_inputs(shape, torch.bfloat16, g, dt_law=dt_law)
    before = ssd_mod.ssd_cuda.mainloop_launches["chunked"]
    y, h = ssd_ops.ssd(*args, chunk=256)
    ran_chunked = ssd_mod.ssd_cuda.mainloop_launches["chunked"] == before + 1
    ky, kh = ssd_kernel_ref(*args, chunk=256)
    ry, rh = ssd_ref(*args, 256)
    # the noise floor: the same plain version on the CPU, whose f32 sums
    # (another order) round some M entries to bf16 the other way
    cy, ch = ssd_kernel_ref(*(t.cpu() for t in args), chunk=256)
    tight, loose = (TOLERANCES["ssd_bf16_kernel"],
                    TOLERANCES["ssd_bf16_reference"])
    b, S, H = shape[:3]
    cum_end = (args[1].reshape(b, S // 256, 256, H) * args[2]).sum(2)
    out = {"shape": list(shape) + [256], "dt_law": dt_law,
           "exp_cum_end_share": {
               "above_0": float((torch.exp(cum_end) > 0).float().mean()),
               "above_1e-3": float((torch.exp(cum_end) > 1e-3).float()
                                   .mean())},
           "mainloop": "chunked" if ran_chunked else "not chunked",
           "excess": {"y_vs_kernel_ref": tight.excess(y, ky),
                      "h_vs_kernel_ref": tight.excess(h, kh),
                      "y_vs_ssd_ref": loose.excess(y, ry),
                      "h_vs_ssd_ref": loose.excess(h, rh)},
           "max_abs_err_vs_kernel_ref": float((y.double() - ky.double())
                                              .abs().max()),
           "plain_card_vs_cpu": {"y": tight.excess(ky.cpu(), cy),
                                 "h": tight.excess(kh.cpu(), ch)},
           "controls": {}}
    for fault in SSD_FAULTS:
        py, ph = ssd_planted(*args, chunk=256, fault=fault)
        out["controls"][fault] = {"y": tight.excess(py, ky),
                                  "h": tight.excess(ph, kh)}
    out["controls"]["bf16_state_ssd_ref"] = {"y": tight.excess(ry, ky),
                                             "h": tight.excess(rh, kh)}
    # ssd_ref also rounds M x before D x cancels it: where it fails, and
    # the bf16 state and y_inter without that rounding
    out["bf16_state_ssd_ref_worst_y_row"] = worst_row(ry, ky, tight, 256)
    py, ph = ssd_planted(*args, chunk=256, fault="state_in_bf16")
    bf16_state = {"y": tight.excess(py, ky), "h": tight.excess(ph, kh)}
    if dt_law == "softplus":
        out["controls"]["state_in_bf16"] = bf16_state
    else:
        out["reported_controls"] = {"state_in_bf16": bf16_state}
    # the chunked mainloop's own order: the state pass without its decay,
    # cum carried across chunk boundaries
    for fault in CHUNKED_FAULTS:
        py, ph = ssd_chunked_ref(*args, chunk=256, fault=fault)
        out["controls"][fault] = {"y": tight.excess(py, ky),
                                  "h": tight.excess(ph, kh)}
    return out


SSD_PROMPT = 1277       # the longest prompt of the served mamba2 run


def ssd_rows_and_strides(g) -> dict:
    """Bit-equality at mamba2's served shape ([4, 2048, 32, 64], N 128,
    bf16): a prompt of SSD_PROMPT tokens alone as [1, SSD_PROMPT] and as
    lane 2 of a [4, 2048] launch (dt = 0 past it, random x, B and C
    there), y rows and final state; and x, B, C as the strided views
    apply_ssm hands over (split off one [4, 2048, d_inner + 2 N]
    projection) against contiguous copies of them."""
    b, S, H, P, G, N = SSD_SERVED
    x, dt, A, B, C, D = ssd_inputs(SSD_SERVED, torch.bfloat16, g)
    dt[2, SSD_PROMPT:] = 0.0
    y, h = ssd_ops.ssd(x, dt, A, B, C, D, chunk=256)
    xa, dta, Ba, Ca = (t[2:3, :SSD_PROMPT].contiguous()
                       for t in (x, dt, B, C))
    ya, ha = ssd_ops.ssd(xa, dta, A, Ba, Ca, D, chunk=256)
    proj = torch.randn((b, S, H * P + 2 * G * N), generator=g,
                       device="cuda").to(torch.bfloat16)
    xs, Bs, Cs = torch.split(proj, [H * P, G * N, G * N], dim=-1)
    views = (xs.reshape(b, S, H, P), Bs.reshape(b, S, G, N),
             Cs.reshape(b, S, G, N))
    yv, hv = ssd_mod.ssd_cuda(views[0], dt, A, views[1], views[2], D,
                              chunk=256)
    yc, hc = ssd_mod.ssd_cuda(views[0].contiguous(), dt, A,
                              views[1].contiguous(), views[2].contiguous(),
                              D, chunk=256)
    torch.cuda.synchronize()
    return {"alone_vs_bucket": {
                "prompt": SSD_PROMPT,
                "y_rows": torch.equal(y[2:3, :SSD_PROMPT], ya),
                "state": torch.equal(h[2:3], ha)},
            "strided_vs_contiguous": {
                "views_not_contiguous": not views[0].is_contiguous(),
                "y": torch.equal(yv, yc), "state": torch.equal(hv, hc)}}


def worst_row(got, ref, tol, chunk: int) -> dict:
    """The row (last axis) of y [b, S, H, P] where `got` misses `ref` most
    under a RowTol: its position in its chunk and its rms beside the
    median row's, and how many rows miss."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err),
                        err / (tol._atol(ref) + tol.rtol * ref.abs()))
    ratio = ratio.amax(dim=-1)
    rms = ref.square().mean(dim=-1).sqrt()
    i = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
    return {"t_in_chunk": int(i[1]) % chunk, "row_rms": float(rms[i]),
            "median_row_rms": float(rms.median()),
            "rows_over_1": int((ratio > 1).sum())}


# --------------------------------------------------------------------------
# 6. grouped pod GEMM vs plain
# --------------------------------------------------------------------------

# G, M, K, N: ragged, decode-like (M = 1); TMA-aligned G > 1 on wgmma at
# ragged M (one row past a 64-row half and a 128-row tile; N not a tile
# multiple, K = 1032 not a stage multiple); and G = 1: ragged (both
# launches on wmma), and TMA-aligned at M = 4 (grouped wmma, NN splitk)
# and 96 (both wgmma)
GROUPED_CASES = [(3, 37, 100, 130), (5, 1, 260, 70), (3, 65, 256, 136),
                 (4, 129, 1032, 264), (1, 33, 64, 65), (1, 4, 512, 136),
                 (1, 96, 256, 136)]
# dbrx-132b's expert GEMMs: decode (M = 1 row per expert), the down
# projection, a 1024-token prefill (8 groups x capacity 40 = 320 rows per
# expert) and the 1277-token prompt (prime: one group of capacity 399),
# up and down
GROUPED_SERVED = [(16, 1, 6144, 10752, "silu"), (16, 1, 10752, 6144, None),
                  (16, 320, 6144, 10752, "silu"), (16, 399, 6144, 10752,
                                                   None),
                  (16, 399, 10752, 6144, None),
                  # deepseek-v2-236b's 160 experts: decode (capacity 1 row
                  # per expert), up/gate and down, and the 1277-token
                  # prompt (one group of capacity int(1277 x 6 / 160 x
                  # 1.25) = 59)
                  (160, 1, 5120, 1536, "silu"), (160, 1, 1536, 5120, None),
                  (160, 59, 5120, 1536, "silu")]


def grouped_inputs(G, M, K, N, dtype, g):
    x, w = zip(*(gemm_inputs(M, K, N, dtype, g) for _ in range(G)))
    return torch.stack(x), torch.stack(w)


def wrong_group_stride(x, w, *args, **kw) -> torch.Tensor:
    """Planted control: group g + 1 reads group g's weights, as a kernel
    whose group stride is one group short would."""
    return grouped_systolic_gemm_ref(x, torch.cat([w[:1], w[:-1]]), *args,
                                     **kw)


def phase_grouped() -> None:
    """Every case is read before any verdict. The kernel's excess must stay
    at or below 1; both controls' must exceed it where they differ from the
    plain version (bf16 sums: every f32/bf16 case without an epilogue; the
    group stride: every case with G > 1). The middle group of each case
    with G > 1 is all zero with a zero bias and must come out exactly 0.
    G = 1 must equal the NN launch bit for bit where both run one mainloop
    (wmma, simt or wgmma: one order of summation)."""
    g = torch.Generator("cuda").manual_seed(11)
    cases, failures = 0, []
    worst: dict[str, dict] = {}
    control: dict[str, float] = {}

    def record(key, got, ref, tol, case):
        err = float((got.double() - ref.double()).abs().max())
        excess = tol.excess(got, ref)
        row = worst.setdefault(key, {"max_abs_err": 0.0, "excess": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["excess"] = max(row["excess"], excess)
        if not bool(torch.isfinite(got.float()).all()):
            failures.append(f"non-finite kernel output {case}")
        elif not excess <= 1.0:
            failures.append(f"kernel disagrees with plain {case} "
                            f"excess={excess} ({tol})")

    def planted(name, c, case):
        control[name] = min(control.get(name, math.inf), c)
        if not c > 1.0:
            failures.append(f"{name} control passes {case} excess={c}")

    mainloops = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for (G, M, K, N) in GROUPED_CASES:
            x, w = grouped_inputs(G, M, K, N, dtype, g)
            plan = sg.gemm_plan("grouped", M, N, K, dtype, True)
            mainloops[f"{str(dtype)[6:]} {G}x{M}x{K}x{N}"] = list(plan)
            scale = torch.rand((G, N), generator=g, device="cuda") + 0.5
            bias = torch.randn((G, N), generator=g, device="cuda")
            if G > 1:                            # an expert with no token
                x[G // 2] = 0
                bias[G // 2] = 0
            for act in sg.ACTIVATIONS:
                for out_dtype in (torch.float32, torch.bfloat16):
                    sb = (scale, bias) if act is not None else (None, None)
                    got = sg.grouped_systolic_gemm_cuda(
                        x, w, *sb, activation=act, out_dtype=out_dtype)
                    ref = grouped_systolic_gemm_ref(
                        x, w, *sb, activation=act, out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    tol = tolerance(dtype, out_dtype, act)
                    key = f"{str(dtype)[6:]}->{str(out_dtype)[6:]}"
                    case = f"{key} {G}x{M}x{K}x{N} act={act}"
                    record(key, got, ref, tol, case)
                    if G > 1 and not bool((got[G // 2] == 0).all()):
                        failures.append(f"empty group not exactly 0 {case}")
                    if G > 1:
                        planted("group_stride", tol.excess(
                            wrong_group_stride(x, w, *sb, activation=act,
                                               out_dtype=out_dtype), ref),
                            case)
                    if act is None and dtype != torch.int8:
                        summed = torch.stack([bf16_summed(x[i], w[i])
                                              for i in range(G)])
                        planted("bf16_summed",
                                tol.excess(summed.to(out_dtype), ref), case)
                    if G == 1:
                        # bit-equal where both launches run one mainloop
                        # (wmma, simt, or wgmma in NN's split ranges); the
                        # NN splitk sums in another order than grouped
                        # wmma, so there within the case's tolerance
                        one = sg.systolic_gemm_cuda(
                            x[0], w[0], *(t if t is None else t[0]
                                          for t in sb),
                            activation=act, out_dtype=out_dtype)
                        nn = sg.nn_plan(M, N, K, dtype, True).mainloop
                        if nn == plan.mainloop:
                            if not torch.equal(got[0], one):
                                failures.append(f"G = 1 differs from the "
                                                f"pod GEMM kernel ({nn}) "
                                                f"{case}")
                        elif not tol.ok(got[0], one):
                            failures.append(f"G = 1 beyond {tol} of the pod "
                                            f"GEMM kernel ({nn}) {case}")
                    cases += 1
    served = []
    for (G, M, K, N, act) in GROUPED_SERVED:
        x, w = grouped_inputs(G, M, K, N, torch.bfloat16, g)
        x[G // 2] = 0                            # an expert with no token
        got = sg.grouped_systolic_gemm_cuda(x, w, activation=act,
                                            out_dtype=torch.bfloat16)
        ref = grouped_systolic_gemm_ref(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        tol = TOLERANCES["gemm_bf16out"]
        case = f"served {G}x{M}x{K}x{N} act={act}"
        record("served bf16->bf16", got, ref, tol, case)
        if not bool((got[G // 2] == 0).all()):
            failures.append(f"empty group not exactly 0 {case}")
        planted("group_stride", tol.excess(wrong_group_stride(
            x, w, activation=act, out_dtype=torch.bfloat16), ref), case)
        if act is None:
            summed = torch.stack([bf16_summed(x[i], w[i]) for i in range(G)])
            planted("bf16_summed", tol.excess(summed.to(torch.bfloat16), ref),
                    case)
        served.append([G, M, K, N, act, list(sg.gemm_plan(
            "grouped", M, N, K, torch.bfloat16, True)), tol.excess(got, ref)])
        cases += 1
        del x, w, got, ref
    emit("grouped", cases=cases, worst=worst, control_min_excess=control,
         served=served, mainloops=mainloops, failures=failures)
    check(not failures, f"{len(failures)} grouped checks failed")


# --------------------------------------------------------------------------
# graphed against eager, in every serve phase
# --------------------------------------------------------------------------

def launch_table() -> dict:
    """Every kernel wrapper's launches and launches by mainloop."""
    return {name: {"launches": fn.launches,
                   "by_mainloop": dict(fn.mainloop_launches)}
            for name, fn in (("pod_gemm", sg.systolic_gemm_cuda),
                             ("gemm_nt", sg.systolic_gemm_nt_cuda),
                             ("grouped", sg.grouped_systolic_gemm_cuda),
                             ("flash", fa.flash_attention_cuda),
                             ("ssd", ssd_mod.ssd_cuda))}


def counted_serve(engine, reqs: list[Request], step_hook=None) -> dict:
    """Serve reqs on `engine` from zeroed launch counts, one step() a
    quantum (step_hook(engine) after each). Returns the wall seconds, the
    counted host syncs, every launch count (launch_table) and every host
    read the engine made: each prefill's first tokens and each packed
    decode chunk, copied."""
    reads = []
    real = engine_mod.to_host

    def recording(t):
        out = real(t)
        reads.append(out.copy())
        return out
    reset_launch_counts()
    syncs0 = HOST_SYNCS.count
    engine_mod.to_host = recording
    try:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        for _ in range(1000):
            if not engine.queue and not any(engine.active):
                break
            engine.step()
            if step_hook is not None:
                step_hook(engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod.to_host = real
    check(not engine.queue and not any(engine.active),
          "requests still pending after 1000 steps")
    return {"wall_s": wall, "syncs": HOST_SYNCS.count - syncs0,
            "launches": launch_table(), "reads": reads}


def pass_figures(engine, run: dict, reqs: list[Request], st0: dict) -> dict:
    """One pass's serve figures from the engine's stats since `st0`:
    prefill ms per call and decode ms per step over the calls that did not
    warm up and capture (those count in capture_s), tokens/s over the
    pass's whole wall."""
    st = {k: v - st0.get(k, 0) for k, v in engine.stats.items()
          if not isinstance(v, bool)}
    prefills = st["prefill_calls"] - st["capture_prefills"]
    steps = st["decode_steps"] - st["capture_steps"]
    generated = sum(len(r.out) for r in reqs)
    return {"wall_s": run["wall_s"], "tokens_per_s": generated / run["wall_s"],
            "host_syncs": run["syncs"], "prefill_calls": st["prefill_calls"],
            "prefill_ms_per_call": (1e3 * st["prefill_s"] / prefills
                                    if prefills else None),
            "decode_chunks": st["chunks"], "decode_steps": st["decode_steps"],
            "decode_ms_per_step": (1e3 * st["decode_s"] / steps
                                   if steps else None),
            "capture_s": st["capture_s"], "graphs": st["graphs"],
            "captured_prefills": st["capture_prefills"],
            "captured_decode_steps": st["capture_steps"]}


def profile_decode_chunk(engine, vocab: int, label: str,
                         extras: dict | None = None) -> dict:
    """One full decode chunk (decode_chunk steps, every slot live) under
    torch.profiler: the device's kernel, copy and set time summed from the
    trace, and the chunk's wall. A chunk before it
    admits and captures what is new; the chunk after it is timed without
    the profiler (its wall beside the profiled one: the profiler's own
    cost on the host). `extras` go with every request (whisper's
    frames)."""
    from torch.profiler import ProfilerActivity, profile
    n = engine.decode_chunk
    reqs = [Request(rid=10_000 + i, prompt=(np.arange(8) + 3 * i) % vocab,
                    max_new_tokens=3 * n + 1, extras=dict(extras or {}))
            for i in range(engine.slots)]
    for r in reqs:
        engine.submit(r)
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    engine.run_to_completion()
    check(all(r.done for r in reqs), f"{label}: profiled requests not done")
    path = _build.REPO_ROOT / "build" / "profiles" / f"{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    device = {"kernel": [0.0, 0], "gpu_memcpy": [0.0, 0],
              "gpu_memset": [0.0, 0]}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in device:
            device[e["cat"]][0] += float(e.get("dur", 0.0)) / 1e3
            device[e["cat"]][1] += 1
    return {"steps": n, "wall_ms": 1e3 * wall,
            "unprofiled_wall_ms": 1e3 * unprofiled,
            "kernel_ms": device["kernel"][0], "kernels": device["kernel"][1],
            "memcpy_ms": device["gpu_memcpy"][0],
            "memset_ms": device["gpu_memset"][0]}


def cache_tensors(cache: dict) -> list[torch.Tensor]:
    return [getattr(c, f.name) for node in cache.values()
            for c in node.values() for f in dataclasses.fields(c)]


def decode_logits_graphed_vs_eager(model, params, engine) -> dict:
    """One decode step over the engine's cache (as it is after serving),
    eager and as a graph replay from the same state: whether the logits
    are bit-equal (cuBLAS may pick another algorithm under capture, e.g.
    for dbrx's f32 router). The cache is restored afterwards."""
    cache = engine.cache
    tensors = cache_tensors(cache)
    saved = [t.clone() for t in tensors]

    def restore():
        for t, v in zip(tensors, saved):
            t.copy_(v)
    B = engine.slots
    toks = torch.arange(1, B + 1, device="cuda") % model.cfg.vocab
    pos = torch.arange(B, device="cuda") * 97 + 5

    def body(toks, pos):
        return model.decode_step(params, toks, cache, pos)[0]
    eager = body(toks, pos).clone()
    restore()
    runner = StepRunner(body, {"toks": toks, "pos": pos},
                        GraphPool(torch.device("cuda")))
    runner()                                    # warm-up and capture
    restore()
    graphed = runner().clone()
    torch.cuda.synchronize()
    restore()
    return {"bit_equal": torch.equal(eager, graphed),
            "max_abs_diff": float((eager.float() - graphed.float()).abs()
                                  .max()),
            "argmax_equal": torch.equal(eager.argmax(-1),
                                        graphed.argmax(-1))}


def graphed_vs_eager(phase: str, model, params, eng, run: dict,
                     reqs: list[Request], make_requests, engine_kw: dict,
                     extras: dict | None = None) -> dict:
    """The phase's graphed engine `eng` (first pass `run` over `reqs`,
    already gated on today's launch and sync formulas) against an eager
    engine on the same requests, in the same run:

    * gates: equal tokens; every host read (first tokens, packed decode
      chunks) equal bit for bit; equal host syncs; equal launch counts by
      kernel and mainloop; prefill graphs at most max_prefill_compiles,
      decode graphs at most log2(decode_chunk) + 1, none in the eager
      engine; a second pass of the graphed engine captures nothing and
      gives the same tokens and reads;
    * reported for both engines: the second pass's figures (every call a
      replay when graphed), the first pass's capture seconds and graph
      count, one profiled decode chunk's idle share; for the graphed one
      each runner's warm-up, capture and instantiation seconds, the graph
      pool's bytes and the static lane caches' bytes; and whether one
      decode step's logits are bit-equal graphed and eager. `extras` go
      with the profiled chunk's requests."""
    cfg = model.cfg
    eager = ServeEngine(model, params, eager=True, **engine_kw)
    e_reqs = make_requests(cfg.vocab)
    e_run = counted_serve(eager, e_reqs)
    tokens = [r.out for r in reqs]
    check(tokens == [r.out for r in e_reqs],
          f"{phase}: graphed tokens differ from eager: "
          f"{[r.rid for r, e in zip(reqs, e_reqs) if r.out != e.out]}")
    first_diff = next((i for i, (a, b) in enumerate(zip(run["reads"],
                                                        e_run["reads"]))
                       if not np.array_equal(a, b)), None)
    check(len(run["reads"]) == len(e_run["reads"]) and first_diff is None,
          f"{phase}: graphed host reads differ from eager at read "
          f"{first_diff} of {len(run['reads'])}")
    check(run["syncs"] == e_run["syncs"],
          f"{phase}: host syncs graphed {run['syncs']} != eager "
          f"{e_run['syncs']}")
    check(run["launches"] == e_run["launches"],
          f"{phase}: launches graphed {run['launches']} != eager "
          f"{e_run['launches']}")
    decode_bound = int(math.log2(eng.decode_chunk)) + 1
    prefill_graphs = eng.prefill_compiles if eng.bucketed else 0
    check(eng.decode_compiles <= decode_bound and
          (not eng.bucketed or eng.prefill_compiles
           <= eng.max_prefill_compiles),
          f"{phase}: {eng.prefill_compiles} prefill / "
          f"{eng.decode_compiles} decode graphs past the bounds "
          f"{eng.max_prefill_compiles} / {decode_bound}")
    check(eng.stats["graphs"] == prefill_graphs + eng.decode_compiles and
          eager.stats["graphs"] == 0,
          f"{phase}: graphs {eng.stats['graphs']} (eager "
          f"{eager.stats['graphs']}) for {prefill_graphs} prefill and "
          f"{eng.decode_compiles} decode runners")
    runner_seconds = {f"prefill {b}": r.seconds
                      for b, r in sorted(eng._prefill_runners.items())}
    runner_seconds.update({f"decode {n}": r.seconds
                           for n, r in sorted(eng._decode_runners.items())})
    out = {"graphed": {"first_pass": pass_figures(eng, run, reqs, {}),
                       "graph_pool_bytes": eng.graph_pool_bytes(),
                       "static_lane_cache_bytes": sum(
                           t.nbytes for lane in eng._lane_caches.values()
                           for t in cache_tensors(lane)),
                       "prefill_graphs": prefill_graphs,
                       "decode_graphs": eng.decode_compiles,
                       "runner_seconds": runner_seconds},
           "eager": {"first_pass": pass_figures(eager, e_run, e_reqs, {})}}
    for label, engine in (("graphed", eng), ("eager", eager)):
        st0 = dict(engine.stats)
        again = make_requests(cfg.vocab)
        run2 = counted_serve(engine, again)
        out[label]["second_pass"] = pass_figures(engine, run2, again, st0)
        check([r.out for r in again] == tokens and
              all(np.array_equal(a, b) for a, b in
                  zip(run2["reads"], run["reads"])),
              f"{phase}: {label} second pass differs from the first")
    check(out["graphed"]["second_pass"]["graphs"] == 0,
          f"{phase}: the graphed engine's second pass captured "
          f"{out['graphed']['second_pass']['graphs']} graphs")
    for label, engine in (("graphed", eng), ("eager", eager)):
        out[label]["decode_chunk_profile"] = profile_decode_chunk(
            engine, cfg.vocab, f"{phase}-{label}", extras)
    out["decode_logits"] = decode_logits_graphed_vs_eager(model, params,
                                                          eng)
    return out


# --------------------------------------------------------------------------
# 7. serve and 8. oracle
# --------------------------------------------------------------------------

def check_served(phase: str, cfg, reqs: list[Request]) -> None:
    """Every request done with MAX_NEW tokens inside the vocabulary."""
    for r in reqs:
        check(r.done and r.state == "done",
              f"{phase} request {r.rid} ended {r.state} ({r.reason})")
        check(len(r.out) == MAX_NEW,
              f"{phase} request {r.rid}: {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.out),
              f"{phase} request {r.rid}: token outside [0, {cfg.vocab})")


def param_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_tensors(v)
    else:
        yield tree


def make_requests(vocab: int) -> list[Request]:
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 201, N_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def serve(engine, reqs: list[Request]) -> float:
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_to_completion(max_steps=1000)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serve(model, params):
    cfg = model.cfg
    # warm-up request: lazy CUDA/cuBLAS set-up stays out of the timings
    serve(ServeEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                      decode_chunk=DECODE_CHUNK),
          [Request(rid=-1, prompt=np.arange(8), max_new_tokens=2)])
    reqs = make_requests(cfg.vocab)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    eng = ServeEngine(model, params, **kw)
    run = counted_serve(eng, reqs)
    wall, syncs = run["wall_s"], run["syncs"]
    launches = sg.systolic_gemm_cuda.launches
    by_mainloop = hopper_mainloops("serve")
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("dense", cfg, reqs)
    per_forward = len(GEMMS_PER_LAYER) * cfg.n_layers + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(launches == per_forward * forwards,
          f"pod-GEMM launches {launches} != {per_forward} x {forwards}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    # what the guard phase's guard="off" engine must equal (a first pass)
    base = {"tokens": [r.out for r in reqs], "reads": run["reads"],
            "syncs": syncs, "launches": run["launches"],
            "graphs": st["graphs"], "runners": (eng.prefill_compiles,
                                                eng.decode_compiles)}
    pair = graphed_vs_eager("serve", model, params, eng, run, reqs,
                            make_requests, kw)
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, pod_gemm_launches=launches,
         pod_gemm_by_mainloop=by_mainloop,
         launches_per_forward=per_forward)
    return reqs, launches, by_mainloop, base


def first_differences(served, oracle, ref: ReferenceEngine) -> list[dict]:
    """Per request whose tokens differ: the first differing step and the
    oracle's top-1 minus top-2 logit there."""
    diffs = []
    for a, b in zip(served, oracle):
        check(b.done, f"oracle request {b.rid} ended {b.state}")
        if a.out != b.out:
            j = next(i for i, (x, y) in enumerate(zip(a.out, b.out))
                     if x != y)
            margin, top = ref.margins[b.rid][j]
            diffs.append({"rid": b.rid, "step": j, "margin": margin,
                          "max_abs_logit": top})
    return diffs


def layer_slice(tree, start: int, stop: int):
    """Every stacked leaf of a segment's tree cut to layers [start, stop)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, start, stop) for k, v in tree.items()}
    return tree[start:stop]


def cut_depth(model, params, n_layers: int):
    """The same full-width weights, first n_layers layers only (views). A
    hybrid model keeps its global layers among them (the 2-layer cut of
    hymba is glob0 and the first layer of swa1, as glob0 | swa_tail);
    each segment of the cut takes its layers from the one segment of the
    full model that holds them. A vlm's segment counts groups, so its cut
    slices whole groups (`plain` [n, 4, ...] and `cross` [n, ...] alike),
    and a cut that is not whole groups raises ValueError (segments)."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, global_attn_layers=tuple(
            g for g in cfg.global_attn_layers if g < n_layers))
    cut_model = Model(cfg, attention_impl=model.impl, use_pallas=True,
                      ssd_impl=model.ssd_impl)
    where = [(seg, i) for seg in model.segs for i in range(seg.n)]
    cut = {k: v for k, v in params.items()
           if k not in {seg.name for seg in model.segs}}
    start = 0
    for seg in cut_model.segs:
        (full, i0), (last, i1) = where[start], where[start + seg.n - 1]
        check(full == last and (full.kind, full.window) ==
              (seg.kind, seg.window),
              f"cut segment {seg} is not a run of one full segment "
              f"({full}, {last})")
        cut[seg.name] = layer_slice(params[full.name], i0, i1 + 1)
        start += seg.n
    return cut_model, cut


def cut_oracle(model, params, label: str) -> list[dict]:
    """The margin rule at ORACLE_LAYERS: the first layers of the same
    full-width weights served by a ServeEngine and by the per-token
    ReferenceEngine on the serve requests; every request whose tokens
    differ must do so after a near tie of the oracle. Returns those
    first differences."""
    tol = TOLERANCES["token_margin"]
    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_requests(model.cfg.vocab)
    serve(ServeEngine(cut_model, cut_params, slots=SLOTS, max_len=MAX_LEN,
                      decode_chunk=DECODE_CHUNK), cut_served)
    cut_reqs = make_requests(model.cfg.vocab)
    cut_ref = ReferenceEngine(cut_model, cut_params, slots=SLOTS,
                              max_len=MAX_LEN)
    serve(cut_ref, cut_reqs)
    cut = first_differences(cut_served, cut_reqs, cut_ref)
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{label} {ORACLE_LAYERS}-layer cut: request {d['rid']} "
              f"differs at token {d['step']} with oracle margin "
              f"{d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")
    return cut


def phase_oracle(model, params, served: list[Request]) -> None:
    """Engine vs per-token oracle. With random weights, 36 layers amplify a
    last-bit difference into different logits (tests/test_torch_model.py
    shows the JAX reference doing the same), so at full depth the agreement
    is reported, and the margin rule is held at a depth cut to
    ORACLE_LAYERS on the same full-width weights."""
    tol = TOLERANCES["token_margin"]
    reqs = make_requests(model.cfg.vocab)
    ref = ReferenceEngine(model, params, slots=SLOTS, max_len=MAX_LEN)
    wall = serve(ref, reqs)
    full = first_differences(served, reqs, ref)
    cut = cut_oracle(model, params, "oracle")
    emit("oracle", requests=len(reqs), oracle_wall_s=wall,
         full_depth={"n_layers": model.cfg.n_layers,
                     "token_exact": len(reqs) - len(full),
                     "first_differences": full},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "token_exact": len(reqs) - len(cut),
                    "first_differences": cut},
         margin_tolerance=f"{tol.atol} x max|logit|")


# --------------------------------------------------------------------------
# 9. serve_paged and 10. paged_oracle
# --------------------------------------------------------------------------

def make_paged_requests(vocab: int) -> list[Request]:
    rng = np.random.default_rng(0)
    lens = rng.integers(5, PAGED_MAX_PROMPT + 1, N_PAGED_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(lens)]


def dense_of(paged: dict) -> dict:
    return {k: v for k, v in paged.items()
            if k not in ("paged", "page_size", "kv_pages")}


def phase_serve_paged(model, params):
    """granite-8b with flash prefill through the paged pool. The engine is
    stepped by hand so the page stats are read after every quantum."""
    cfg = model.cfg
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **PAGED),
          [Request(rid=-1, prompt=np.arange(PAGED["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **PAGED)
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peaks = []

    def page_stats(engine):
        stats = engine.paged_kv_stats()
        if not peaks or stats["mapped_bytes"] > peaks[-1]["mapped_bytes"]:
            peaks.append(stats)
    run = counted_serve(eng, reqs, step_hook=page_stats)
    wall, syncs, peak = run["wall_s"], run["syncs"], peaks[-1]
    gemm_launches = sg.systolic_gemm_cuda.launches
    by_mainloop = hopper_mainloops("serve_paged")
    flash_launches = fa.flash_attention_cuda.launches
    flash_by_mainloop = flash_mainloops("serve_paged")
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    # the prefill's dense transient lane cache at the largest bucket, and
    # the device's peak over the run above what the weights and the pool
    # already held (transient cache, activations, logits)
    ps = PAGED["page_size"]
    bucket = max(eng._bucket(len(r.prompt)) for r in reqs)
    transient = (PAGED["slots"] * -(-bucket // ps) * ps
                 * peak["kv_bytes_per_token"])
    peak_over_start = torch.cuda.max_memory_allocated() - start_bytes
    check_served("paged", cfg, reqs)
    eng._pool.assert_drained()
    check(eng.recycled >= 1, "no lane was recycled inside a chunk")
    per_forward = len(GEMMS_PER_LAYER) * cfg.n_layers + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(gemm_launches == per_forward * forwards,
          f"pod-GEMM launches {gemm_launches} != {per_forward} x {forwards}")
    check(flash_launches == cfg.n_layers * st["prefill_calls"],
          f"flash launches {flash_launches} != {cfg.n_layers} x "
          f"{st['prefill_calls']} prefill calls")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve_paged", model, params, eng, run, reqs,
                            make_paged_requests, PAGED)
    emit("serve_paged", arch=cfg.name, n_layers=cfg.n_layers,
         attention_impl=model.impl, **PAGED,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, pod_gemm_launches=gemm_launches,
         pod_gemm_by_mainloop=by_mainloop,
         flash_launches=flash_launches,
         flash_by_mainloop=flash_by_mainloop, recycled=eng.recycled,
         peak_paged_kv_stats=peak, largest_bucket=bucket,
         prefill_transient_kv_bytes=transient,
         device_peak_bytes_over_start=peak_over_start)
    return reqs, flash_by_mainloop


def layer0_qkv(cfg, params, tokens):
    """Layer 0's q, k, v (after RoPE) for a token batch: the real inputs
    the flash kernel meets first in a served prefill."""
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    h = apply_norm({k: v[0] for k, v in params["layers"]["ln_attn"].items()},
                   embed(params["embed"], tokens), cfg.norm)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    q, k, v = (pod_dense(h, p[n]) for n in ("q", "k", "v"))
    return (apply_rope(q, pos, cfg.rope_theta),
            apply_rope(k, pos, cfg.rope_theta), v)


def layer0_gate(cfg, params) -> dict:
    """The kernel on the real activations it meets first in a served
    prefill: layer 0's q, k, v of the first served prompts at bucket
    max_len. Random weights with the reference's fan-in (the [d, H, hd]
    projections scale by H) give scores in the hundreds, where the naive
    version's bf16 scores (ulp 2-4) pick other keys than f32 scores
    (PERF.md), so the kernel is held to the Pallas kernel's own arithmetic
    with its key tile, at flash_bf16_tiled_large_scores."""
    toks = np.zeros((PAGED["slots"], PAGED["max_len"]), np.int64)
    for g, r in enumerate(make_paged_requests(cfg.vocab)[:PAGED["slots"]]):
        toks[g, :len(r.prompt)] = r.prompt
    q, k, v = layer0_qkv(cfg, params, torch.from_numpy(toks).cuda())
    D = q.shape[-1]
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    tiled = flash_attention_tiled_ref(q, k, v, causal=True,
                                      block_k=fa.flash_plan(D, torch.bfloat16).block_k)
    # the score scale, over batch 0's first 256 rows (their causal pairs)
    qs = q[:1, :256].float() / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:1, :256].float()
                     .repeat_interleave(q.shape[2] // k.shape[2], dim=2))
    ok = torch.ones((256, 256), dtype=torch.bool, device=q.device).tril()
    return {"shape": list(q.shape),
            "score_std": float(s[:, :, ok].std()),
            "excess": TOLERANCES["flash_bf16_tiled_large_scores"].excess(
                got, tiled),
            "excess_at_flash_bf16_tiled":
                TOLERANCES["flash_bf16_tiled"].excess(got, tiled),
            "max_abs_err": float((got.double() - tiled.double())
                                 .abs().max())}


def phase_paged_oracle(model, params, served: list[Request]) -> None:
    """Paged against dense on the same flash model: the gathered page view
    is position-ordered and every lane's arithmetic is row-independent, so
    the tokens must be equal. On the first ORACLE_LAYERS layers, the paged
    flash engine against the per-token ReferenceEngine of the same model:
    the margin rule. Then the kernel on layer 0's real activations."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    dense = make_paged_requests(cfg.vocab)
    wall = serve(ServeEngine(model, params, **dense_of(PAGED)), dense)
    unequal = [r.rid for r, d in zip(served, dense) if r.out != d.out]

    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_paged_requests(cfg.vocab)
    eng = ServeEngine(cut_model, cut_params, **PAGED)
    serve(eng, cut_served)
    eng._pool.assert_drained()
    reqs = make_paged_requests(cfg.vocab)
    ref = ReferenceEngine(cut_model, cut_params, slots=PAGED["slots"],
                          max_len=PAGED["max_len"])
    serve(ref, reqs)
    cut = first_differences(cut_served, reqs, ref)

    real = layer0_gate(cfg, params)
    emit("paged_oracle", requests=len(served), dense_wall_s=wall,
         full_depth={"n_layers": cfg.n_layers,
                     "paged_equals_dense": len(served) - len(unequal),
                     "unequal_rids": unequal},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "token_exact_vs_oracle": len(cut_served) - len(cut),
                    "first_differences": cut},
         layer0_real_activations=real,
         margin_tolerance=f"{tol.atol} x max|logit|")
    check(not unequal, f"paged tokens differ from dense for requests "
                       f"{unequal} at full depth")
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer cut: paged flash engine differs from "
              f"its oracle for request {d['rid']} at token {d['step']} with "
              f"oracle margin {d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")
    check(real["excess"] <= 1.0, f"kernel disagrees with the tiled plain "
                                 f"version on layer 0's activations {real}")


# --------------------------------------------------------------------------
# 17. serve_controls and 18. launch_serve
# --------------------------------------------------------------------------

# tests/test_admission.py's overload case: 2 slots, virtual time
OVERLOAD = dict(slots=2, max_len=64, decode_chunk=8)
CHAOS = dict(seed=3, p_fault=0.3, p_slow=0.3)
EXHAUSTED_REQUESTS = 4      # the paged prompts of three buckets


class EarlyWriteEngine(ServeEngine):
    """Planted control: each attempt runs the call, which writes the
    runner's static buffers and the caches in place, before the injector
    may raise. A retried decode chunk then runs on caches the failed
    attempt already advanced, so the tokens must differ from a clean
    run's."""

    def _device_call(self, kind, fn):
        while True:
            out = fn()
            try:
                self._chaos.before(kind)
                return out
            except TransientDeviceError:
                continue


def overload_requests(vocab: int) -> list[Request]:
    """12 prompts of 5-8 tokens, 6 new tokens each, deadlines 0.8 and 7.0
    s alternating (tests/test_admission.py)."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(12):
        p = rng.integers(0, vocab, int(rng.integers(5, 9)))
        reqs.append(Request(rid=i, prompt=p, max_new_tokens=6,
                            deadline_s=0.8 if i % 2 else 7.0))
    return reqs


def check_drained(phase: str, engine, reqs: list[Request]) -> None:
    """Every request terminal, no slot held, and (paged) no page in use
    or reserved."""
    check(not engine.queue and not any(engine.active),
          f"{phase}: a slot is still held or a request still queued")
    check(all(r.finished for r in reqs),
          f"{phase}: requests not terminal: "
          f"{[(r.rid, r.state) for r in reqs if not r.finished]}")
    if engine._pool is not None:
        engine._pool.assert_drained()


def overload_attainment(model, params) -> dict:
    """fifo, edf and slo-aware on the overload case under a VirtualClock:
    edf and slo-aware must beat fifo in SLO attainment."""
    out = {}
    for policy in POLICIES:
        clock = VirtualClock()
        eng = ServeEngine(model, params, clock=clock,
                          admission=AdmissionConfig(policy=policy),
                          chaos=ChaosConfig(seed=0, service_seconds=0.05),
                          **OVERLOAD)
        reqs = overload_requests(model.cfg.vocab)
        wall = serve(eng, reqs)
        check_drained(f"overload {policy}", eng, reqs)
        out[policy] = {"slo_attainment": eng.admission.slo_attainment,
                       "counts": dict(eng.admission.counts),
                       "virtual_s": clock.t, "wall_s": wall,
                       "graphs": eng.stats["graphs"]}
    att = {p: out[p]["slo_attainment"] for p in POLICIES}
    check(att["edf"] > att["fifo"] and att["slo-aware"] > att["fifo"],
          f"overload: edf and slo-aware must beat fifo in attainment {att}")
    return out


PREDICTOR_TRIALS = 3


def predictor_host_cost(cfg, reqs: list[Request]) -> dict:
    """The slo-aware predictor's host milliseconds for each new (prompt
    bucket, tokens) key of the served requests at full width, one reading
    per trial (each trial a fresh predictor, so every key is new again),
    and the slowest hit. A pricing allocates enough to set off Python's
    garbage collector; `full_gc_ms` lists the full (generation 2)
    collections that fell inside a reading, by key."""
    new_key_ms, hit_ms, full_gc_ms = {}, [], []
    started, pauses = [0.0], []

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        elif info["generation"] == 2:
            pauses.append(1e3 * (time.perf_counter() - started[0]))

    gc.callbacks.append(on_gc)
    try:
        for _ in range(PREDICTOR_TRIALS):
            pred, seen = WaveLatencyPredictor(cfg), set()
            for r in reqs:
                key = f"{pred._bucket(len(r.prompt))}x{r.max_new_tokens}"
                n_pauses = len(pauses)
                t0 = time.perf_counter()
                pred.model_seconds(len(r.prompt), r.max_new_tokens)
                t1 = time.perf_counter()
                pred.model_seconds(len(r.prompt), r.max_new_tokens)
                hit_ms.append(1e3 * (time.perf_counter() - t1))
                if key not in seen:
                    seen.add(key)
                    new_key_ms.setdefault(key, []).append(1e3 * (t1 - t0))
                    full_gc_ms += [[key, ms] for ms in pauses[n_pauses:]]
    finally:
        gc.callbacks.remove(on_gc)
    every = [ms for readings in new_key_ms.values() for ms in readings]
    return {"new_key_ms": new_key_ms,
            "new_key_ms_range": [min(every), max(every)],
            "full_gc_ms": full_gc_ms, "hit_ms_max": max(hit_ms)}


def controls_off_and_on(model, params) -> tuple[dict, list]:
    """The serve phase's requests with the defaults and with metrics and
    a tracer on, real clock: equal tokens, host syncs, graphs and launches
    by kernel and mainloop. Steady passes in turns (off, on, on, off)
    time the instrumentation on the host; the two instrumented ones, with
    fresh sinks, give the effective TOPS per phase and the token wait.
    Planted: a metrics hook that reads a device tensor must fail the sync
    gate. Returns the figures and the default engine's tokens."""
    cfg = model.cfg
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    off = ServeEngine(model, params, **kw)
    off_reqs = make_requests(cfg.vocab)
    off_run = counted_serve(off, off_reqs)
    metrics, tracer = MetricsRegistry(), ServeTraceRecorder()
    on = ServeEngine(model, params, metrics=metrics, tracer=tracer, **kw)
    on_reqs = make_requests(cfg.vocab)
    on_run = counted_serve(on, on_reqs)
    by_mainloop = hopper_mainloops("serve_controls")
    tokens = [r.out for r in off_reqs]
    check([r.out for r in on_reqs] == tokens,
          "serve_controls: metrics and tracer changed the tokens")
    check(on_run["syncs"] == off_run["syncs"],
          f"serve_controls: host syncs with metrics and tracer "
          f"{on_run['syncs']} != {off_run['syncs']} without")
    check(on.stats["graphs"] == off.stats["graphs"],
          f"serve_controls: graphs {on.stats['graphs']} with controls != "
          f"{off.stats['graphs']} without")
    check(on_run["launches"] == off_run["launches"],
          f"serve_controls: launches {on_run['launches']} with controls != "
          f"{off_run['launches']} without")
    check(len(tracer.spans) == on_run["syncs"],
          f"serve_controls: {len(tracer.spans)} spans for "
          f"{on_run['syncs']} device calls")
    # steady passes (every call a replay) in turns off, on, on, off: the
    # instrumentation's host cost; the on engine's sinks start afresh
    metrics, tracer = MetricsRegistry(), ServeTraceRecorder()
    on.metrics = on.admission.metrics = metrics
    on.tracer = tracer
    graphs = (off.stats["graphs"], on.stats["graphs"])
    steady = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        engine = off if label == "off" else on
        st0 = dict(engine.stats)
        again = make_requests(cfg.vocab)
        run = counted_serve(engine, again)
        check([r.out for r in again] == tokens,
              f"serve_controls: a steady {label} pass changed the tokens")
        steady[label].append(pass_figures(engine, run, again, st0))
    check((off.stats["graphs"], on.stats["graphs"]) == graphs,
          "serve_controls: a steady pass captured a graph")
    syncs = steady["on"][0]["host_syncs"]
    check(len(tracer.spans) == 2 * syncs,
          f"serve_controls: {len(tracer.spans)} spans for two passes of "
          f"{syncs} device calls")
    tops = [dataclasses.asdict(r)
            for r in effective_tops_summary(tracer, cfg, metrics)]
    check({r["phase"] for r in tops} == {"prefill", "decode"},
          f"serve_controls: effective TOPS rows {tops}")
    wait = metrics.histogram("serve.decode.token_wait_us").summary()
    # planted: a metrics hook that reads the device costs a sync a chunk
    real = on._observe_decode

    def reading_hook(*args):
        real(*args)
        engine_mod.to_host(next(iter(on.cache.values()))["attn"].length)
    on._observe_decode = reading_hook
    try:
        planted = counted_serve(on, make_requests(cfg.vocab))
    finally:
        del on._observe_decode
    check(planted["syncs"] != syncs,
          "planted control (a metrics hook reading a device tensor) "
          "passed the sync gate")
    return {"host_syncs": off_run["syncs"],
            "graphs": off.stats["graphs"], "pod_gemm_by_mainloop":
            by_mainloop, "steady_passes": steady,
            "steady_decode_ms_per_step": {
                k: [f["decode_ms_per_step"] for f in v]
                for k, v in steady.items()},
            "effective_tops": tops,
            "token_wait_us": {k: wait[k] for k in ("count", "p50", "p99")},
            "decode_tok_s": metrics.value("serve.decode.tok_s"),
            "planted_metrics_read_syncs": [planted["syncs"], syncs]}, \
        tokens


def chaos_paged(model, params, clean_dense: list) -> dict:
    """The paged engine (flash prefill, a pool of half the dense pages),
    edf, real clock: clean, then with transient faults that heal (tokens,
    runners and graphs equal, nothing leaked), then with faults that
    exhaust the retries (requests rejected device-fault, nothing leaked).
    Planted: an engine whose call writes before the injector raises must
    fail token equality (dense, against the default engine's tokens)."""
    cfg = model.cfg
    kw = dict(PAGED, admission="edf")
    clean = ServeEngine(model, params, **kw)
    clean_reqs = make_paged_requests(cfg.vocab)
    serve(clean, clean_reqs)
    check_drained("chaos clean", clean, clean_reqs)
    eng = ServeEngine(model, params, chaos=ChaosConfig(**CHAOS),
                      max_retries=3, **kw)
    reqs = make_paged_requests(cfg.vocab)
    wall = serve(eng, reqs)
    check_drained("chaos", eng, reqs)
    injected = dict(eng._chaos.injected)
    check(injected["faults"] > 0, f"chaos: no fault injected {injected}")
    check(all(r.state == "done" for r in reqs),
          f"chaos: {[(r.rid, r.state, r.reason) for r in reqs]}")
    check([r.out for r in reqs] == [r.out for r in clean_reqs],
          "chaos: tokens differ from the chaos-free run")
    runners = (eng.prefill_compiles, eng.decode_compiles,
               eng.stats["graphs"])
    clean_runners = (clean.prefill_compiles, clean.decode_compiles,
                     clean.stats["graphs"])
    check(runners == clean_runners,
          f"chaos: runners and graphs {runners} != {clean_runners} clean")
    del clean, eng
    ex = ServeEngine(model, params, chaos=ChaosConfig(**CHAOS,
                                                      transient_tries=5),
                     max_retries=3, **kw)
    ex_reqs = make_paged_requests(cfg.vocab)[:EXHAUSTED_REQUESTS]
    serve(ex, ex_reqs)
    check_drained("chaos exhausted", ex, ex_reqs)
    rejected = [r for r in ex_reqs if r.state == "rejected"]
    check(rejected and all(r.reason == "device-fault" for r in rejected),
          f"chaos exhausted: {[(r.rid, r.state, r.reason) for r in ex_reqs]}")
    exhausted = {"states": [(r.rid, r.state, r.reason) for r in ex_reqs],
                 "injected": dict(ex._chaos.injected)}
    del ex
    planted = EarlyWriteEngine(model, params, chaos=ChaosConfig(**CHAOS),
                               slots=SLOTS, max_len=MAX_LEN,
                               decode_chunk=DECODE_CHUNK)
    planted_reqs = make_requests(cfg.vocab)
    serve(planted, planted_reqs)
    check(planted._chaos.injected["faults"] > 0,
          "planted early write: no fault injected")
    check([r.out for r in planted_reqs] != clean_dense,
          "planted control (writes before the injector raises) passed "
          "token equality after retry")
    return {"wall_s": wall, "injected": injected,
            "runners_prefill_decode_graphs": runners,
            "exhausted": exhausted,
            "planted_early_write_unequal": [
                r.rid for r, t in zip(planted_reqs, clean_dense)
                if r.out != t]}


def phase_serve_controls(model, flash_model, params) -> None:
    t0 = time.perf_counter()
    overload = overload_attainment(model, params)
    t1 = time.perf_counter()
    controls, tokens = controls_off_and_on(model, params)
    t2 = time.perf_counter()
    chaos = chaos_paged(flash_model, params, tokens)
    t3 = time.perf_counter()
    emit("serve_controls", gpu=gpu_name_and_power(),
         overload=overload, controls_off_and_on=controls, chaos=chaos,
         predictor_host_cost=predictor_host_cost(
             model.cfg, make_requests(model.cfg.vocab)),
         wall_s={"overload": t1 - t0, "controls": t2 - t1,
                 "chaos": t3 - t2, "total": time.perf_counter() - t0})


def phase_launch_serve() -> None:
    """repro_torch.launch.serve in-process at reduced granite-8b, edf,
    deadlines, chaos, metrics and a trace file: one span per device
    call, and the run through the pod GEMM and flash kernels; then at
    reduced deepseek-v2 with the defaults: every request done, through
    the pod and grouped GEMMs (MLA launches no flash kernel)."""
    from repro_torch.launch import serve as launch
    path = _build.REPO_ROOT / "build" / "serve_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "granite-8b", "--reduced", "--metrics",
                     "--trace-out", str(path), "--policy", "edf",
                     "--deadline", "5", "--chaos-seed", "1"])
    launches = {"pod_gemm": KERNELS["nn"].launches,
                "flash": fa.flash_attention_cuda.launches}
    wall = time.perf_counter() - t0
    check(launches["pod_gemm"] > 0 and launches["flash"] > 0,
          f"launch_serve: the launcher ran no pod-GEMM or no flash kernel "
          f"{launches}")
    lines = out.getvalue().splitlines()
    start = lines.index("metrics snapshot:") + 1
    end = lines.index("}", start)
    counters = json.loads("\n".join(lines[start:end + 1]))["counters"]
    calls = counters.get("serve.decode.chunks", 0) + sum(
        v for k, v in counters.items()
        if k.startswith("serve.prefill.calls"))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e["ph"] == "X"]
    check(calls > 0 and len(spans) == calls,
          f"launch_serve: {len(spans)} spans for {calls} device calls")
    # reduced deepseek-v2 (MLA, a dense first layer, routed and shared
    # experts): every request done, the pod and grouped kernels launched
    out = io.StringIO()
    t1 = time.perf_counter()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", MLA_ARCH, "--reduced"])
    mla = {"pod_gemm": KERNELS["nn"].launches,
           "grouped": sg.grouped_systolic_gemm_cuda.launches,
           "flash": fa.flash_attention_cuda.launches}
    mla_lines = out.getvalue().splitlines()
    served = [ln for ln in mla_lines if ln.startswith("req ")]
    # a request that did not end done prints its state after its tokens
    check(len(served) == 6 and not any("]  [" in ln for ln in served),
          f"launch_serve {MLA_ARCH}: requests not all done {served}")
    check(mla["pod_gemm"] > 0 and mla["grouped"] > 0 and mla["flash"] == 0,
          f"launch_serve {MLA_ARCH}: launches {mla}")
    emit("launch_serve", wall_s=wall, spans=len(spans), device_calls=calls,
         launches=launches, summary=lines[start - 3:start - 1],
         deepseek={"wall_s": time.perf_counter() - t1, "launches": mla,
                   "summary": mla_lines[len(served)]})


# --------------------------------------------------------------------------
# 11. serve_ssm and 12. ssm_oracle
# --------------------------------------------------------------------------

def reset_launch_counts() -> None:
    for fn in (sg.systolic_gemm_cuda, sg.systolic_gemm_nt_cuda,
               sg.grouped_systolic_gemm_cuda, fa.flash_attention_cuda,
               ssd_mod.ssd_cuda):
        fn.launches = 0
    for fn in KERNELS.values():
        fn.mainloop_launches = dict.fromkeys(sg.MAINLOOPS, 0)
    fa.flash_attention_cuda.mainloop_launches = dict.fromkeys(fa.MAINLOOPS, 0)
    ssd_mod.ssd_cuda.mainloop_launches = dict.fromkeys(ssd_mod.MAINLOOPS, 0)


def hopper_mainloops(phase: str, form: str = "nn") -> dict:
    """The NN (or NT) pod-GEMM launches of a served run by mainloop: every
    one on splitk or wgmma (bf16, TMA-aligned shapes), none on wmma or
    simt."""
    fn = KERNELS[form]
    by = dict(fn.mainloop_launches)
    check(by["wmma"] == 0 and by["simt"] == 0 and
          sum(by.values()) == fn.launches,
          f"{phase}: {form} pod-GEMM launches by mainloop {by}, total "
          f"{fn.launches}")
    return by


def flash_mainloops(phase: str) -> dict:
    """The flash launches of a served run by mainloop: every one on wgmma
    (bf16 at the served head dim, 128), none on mma or simt."""
    fn = fa.flash_attention_cuda
    by = dict(fn.mainloop_launches)
    check(by["wgmma"] == fn.launches and sum(by.values()) == fn.launches,
          f"{phase}: flash launches by mainloop {by}, total {fn.launches}")
    return by


def phase_serve_ssm(model, params):
    """mamba2-370m through bucketed prefill (SSD kernel) and fused decode
    (recurrent torch ops), every LM head on the NT kernel."""
    cfg = model.cfg
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **SSM_SERVE),
          [Request(rid=-1, prompt=np.arange(SSM_SERVE["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **SSM_SERVE)
    run = counted_serve(eng, reqs)
    wall, syncs = run["wall_s"], run["syncs"]
    launches = {"pod_gemm": sg.systolic_gemm_cuda.launches,
                "gemm_nt": sg.systolic_gemm_nt_cuda.launches,
                "flash": fa.flash_attention_cuda.launches,
                "ssd": ssd_mod.ssd_cuda.launches}
    # every head on splitk (decode) or wgmma (prefill over 4 x bucket rows)
    launches["gemm_nt_by_mainloop"] = hopper_mainloops("serve_ssm", "nt")
    # every SSD call on chunked (bf16 at mamba2's tiles)
    launches["ssd_by_mainloop"] = dict(ssd_mod.ssd_cuda.mainloop_launches)
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("ssm", cfg, reqs)
    forwards = st["prefill_calls"] + st["decode_steps"]
    check(launches["gemm_nt"] == forwards,
          f"NT-GEMM launches {launches['gemm_nt']} != 1 x {forwards} "
          f"forwards")
    check(launches["ssd"] == cfg.n_layers * st["prefill_calls"],
          f"SSD launches {launches['ssd']} != {cfg.n_layers} x "
          f"{st['prefill_calls']} prefill calls (none per decode step)")
    check(launches["ssd_by_mainloop"]["chunked"] == launches["ssd"],
          f"SSD launches by mainloop {launches['ssd_by_mainloop']}, total "
          f"{launches['ssd']}: every one must run chunked")
    check(launches["pod_gemm"] == 0 and launches["flash"] == 0,
          f"mamba2 launched another kernel: {launches}")
    check(syncs == st["prefill_calls"] + st["chunks"],
          f"host syncs {syncs} != prefill groups + decode chunks")
    generated = sum(len(r.out) for r in reqs)
    pair = graphed_vs_eager("serve_ssm", model, params, eng, run, reqs,
                            make_paged_requests, SSM_SERVE)
    emit("serve_ssm", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, ssd_impl=model.ssd_impl, **SSM_SERVE,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=generated,
         wall_s=wall, prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         graphed_vs_eager=pair,
         host_syncs=syncs, launches=launches,
         largest_bucket=max(eng._bucket(len(r.prompt)) for r in reqs),
         ssm_state_bytes_per_lane=eng.cache["layers"]["ssm"].lane_bytes())
    return reqs, launches


def phase_ssm_oracle(model, params, served: list[Request],
                     phase: str = "ssm_oracle") -> None:
    """Engine vs per-token oracle on mamba2 (and on hymba, as phase
    hybrid_oracle: the oracle's exact-length prefill takes the ring's
    roll, the engine's bucketed one its gather): agreement reported at
    full depth, the margin rule held on ORACLE_LAYERS layers of the same
    weights (as phase_oracle)."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    oracle_kw = dict(slots=SSM_SERVE["slots"], max_len=SSM_SERVE["max_len"])
    reqs = make_paged_requests(cfg.vocab)
    ref = ReferenceEngine(model, params, **oracle_kw)
    wall = serve(ref, reqs)
    full = first_differences(served, reqs, ref)
    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cut_served = make_paged_requests(cfg.vocab)
    serve(ServeEngine(cut_model, cut_params, **SSM_SERVE), cut_served)
    cut_reqs = make_paged_requests(cfg.vocab)
    cut_ref = ReferenceEngine(cut_model, cut_params, **oracle_kw)
    serve(cut_ref, cut_reqs)
    cut = first_differences(cut_served, cut_reqs, cut_ref)
    emit(phase, arch=cfg.name, requests=len(reqs), oracle_wall_s=wall,
         full_depth={"n_layers": cfg.n_layers,
                     "token_exact": len(reqs) - len(full),
                     "first_differences": full},
         cut_depth={"n_layers": ORACLE_LAYERS,
                    "segments": [(sg_.name, sg_.n, sg_.window)
                                 for sg_ in cut_model.segs],
                    "token_exact": len(reqs) - len(cut),
                    "first_differences": cut},
         margin_tolerance=f"{tol.atol} x max|logit|")
    for d in cut:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer {cfg.name} cut: request {d['rid']} "
              f"differs at token {d['step']} with oracle margin "
              f"{d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")


# --------------------------------------------------------------------------
# 13. serve_moe and 14. moe_oracle
# --------------------------------------------------------------------------

def exact_length_run(phase: str, model, params, serve_kw: dict,
                     make_requests=None, extras: dict | None = None) -> dict:
    """An exact-length model's served run (dbrx, deepseek-v2, whisper): a
    warm-up request (lazy set-up stays out of the timings; `extras` go
    with it), then make_requests(vocab) (the paged phase's requests by
    default) on a fresh engine from zeroed launch counts, each prefill's
    token shape recorded and the peak memory taken. Gates: every request
    done, the exact-length path, one [1, S] prefill a request, one host
    sync per prefill and decode chunk."""
    cfg = model.cfg
    make_requests = make_requests or make_paged_requests
    serve(ServeEngine(model, params, **serve_kw),
          [Request(rid=-1, prompt=np.arange(64), max_new_tokens=2,
                   extras=dict(extras or {}))])
    reqs = make_requests(cfg.vocab)
    eng = ServeEngine(model, params, **serve_kw)
    shapes = []
    real_prefill = model.prefill

    def prefill(params, batch, cache):
        shapes.append(list(batch["tokens"].shape))
        return real_prefill(params, batch, cache)
    model.prefill = prefill
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        run = counted_serve(eng, reqs)
    finally:
        del model.prefill
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served(phase, cfg, reqs)
    check(st["bucketed"] is False and eng.bucketed is False,
          f"{phase}: the engine took the bucketed prefill path")
    check(shapes == [[1, len(r.prompt)] for r in reqs],
          f"{phase}: prefills {shapes} are not one [1, S] per request")
    check(st["prefill_calls"] == len(reqs),
          f"{phase}: {st['prefill_calls']} prefill calls for {len(reqs)} "
          f"requests")
    check(run["syncs"] == st["prefill_calls"] + st["chunks"],
          f"{phase}: host syncs {run['syncs']} != prefills + decode chunks")
    return {"reqs": reqs, "eng": eng, "run": run, "st": st,
            "forwards": st["prefill_calls"] + st["decode_steps"],
            "launches": {k: v["launches"]
                         for k, v in run["launches"].items()},
            "figures": dict(
                prompt_lens=[len(r.prompt) for r in reqs],
                max_new_tokens=MAX_NEW, requests_done=len(reqs),
                tokens_generated=sum(len(r.out) for r in reqs),
                wall_s=run["wall_s"], bucketed=eng.bucketed,
                prefill_shapes=shapes, prefill_calls=st["prefill_calls"],
                decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
                host_syncs=run["syncs"],
                gib_allocated_at_start=start_bytes / 2 ** 30,
                gib_peak=peak / 2 ** 30)}


def check_per_forward(phase: str, launches: dict, per_forward: dict,
                      forwards: int) -> None:
    for name, n in per_forward.items():
        check(launches[name] == n * forwards,
              f"{phase}: {name} launches {launches[name]} != {n} x "
              f"{forwards} forwards")


def phase_serve_moe(model, params):
    """dbrx through exact-length prefill (flash, grouped and pod GEMMs) and
    fused decode; every MoE layer's experts on the grouped kernel."""
    cfg = model.cfg
    out = exact_length_run("serve_moe", model, params, MOE_SERVE)
    reqs, st, launches = out["reqs"], out["st"], out["launches"]
    launches["pod_gemm_by_mainloop"] = hopper_mainloops("serve_moe")
    launches["flash_by_mainloop"] = flash_mainloops("serve_moe")
    L = cfg.n_layers
    per_forward = {"grouped": 3 * L, "pod_gemm": 4 * L + 1}
    check_per_forward("serve_moe", launches, per_forward, out["forwards"])
    check(launches["flash"] == L * st["prefill_calls"],
          f"flash launches {launches['flash']} != {L} x "
          f"{st['prefill_calls']} prefill calls (none per decode step)")
    grouped = grouped_mainloop_gate("serve_moe", cfg, reqs,
                                    launches["grouped"], L)
    launches["grouped_by_mainloop"] = grouped["by_mainloop"]
    launches["grouped_rows_per_expert_at_prefill"] = \
        grouped["rows_per_expert_at_prefill"]
    check(launches["gemm_nt"] == 0 and launches["ssd"] == 0,
          f"dbrx launched an NT-GEMM or SSD kernel: {launches}")
    pair = graphed_vs_eager("serve_moe", model, params, out["eng"],
                            out["run"], reqs, make_paged_requests, MOE_SERVE)
    emit("serve_moe", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         attention_impl=model.impl, **MOE_SERVE, **out["figures"],
         graphed_vs_eager=pair, launches=launches,
         launches_per_forward=per_forward)
    return reqs, launches


def expert_rows(cfg, tokens: int) -> int:
    """Rows per expert of one MoE forward over `tokens` tokens: the
    routing's groups times its per-group capacity (models/moe.py)."""
    groups, per_group = moe._group_shape(tokens, cfg.moe.group_size)
    return groups * moe._capacity(per_group, cfg.moe)


def batch_first_differences(served, oracle, ref: ReferenceEngine):
    """first_differences, and those at the earliest differing step of the
    whole batch: at decode the batch is one routing group, so after one
    lane's token differs the others' expert capacity may differ too."""
    diffs = first_differences(served, oracle, ref)
    first = min((d["step"] for d in diffs), default=None)
    return diffs, [d for d in diffs if d["step"] == first]


def phase_moe_oracle(model, params, phase: str = "moe_oracle",
                     extra=None) -> dict:
    """ServeEngine vs the per-token oracle on MOE_ORACLE_REQUESTS = slots
    requests of equal budget, so every decode batch is fully live in both
    engines and no dead lane takes expert capacity. Agreement reported at
    the served depth; the margin rule held at the batch's first
    difference on ORACLE_LAYERS layers of the same weights. dbrx, and
    deepseek-v2 as phase mla_oracle (its cut: dense0 and one MoE layer).
    extra(), if given, adds its dict to the phase's line, which is
    printed before the gate; it is returned."""
    tol = TOLERANCES["token_margin"]
    cfg = model.cfg
    oracle_kw = dict(slots=MOE_SERVE["slots"], max_len=MOE_SERVE["max_len"])

    def requests():
        return make_paged_requests(cfg.vocab)[:MOE_ORACLE_REQUESTS]

    out = {}
    for label, (m, p) in (("full_depth", (model, params)),
                          ("cut_depth", cut_depth(model, params,
                                                  ORACLE_LAYERS))):
        served, oracle = requests(), requests()
        check(len({r.max_new_tokens for r in served}) == 1 and
              len(served) == MOE_SERVE["slots"],
              "the oracle batch must fill every slot with equal budgets")
        serve(ServeEngine(m, p, **MOE_SERVE), served)
        ref = ReferenceEngine(m, p, **oracle_kw)
        wall = serve(ref, oracle)
        diffs, earliest = batch_first_differences(served, oracle, ref)
        out[label] = {"n_layers": m.cfg.n_layers,
                      "segments": [(s_.name, s_.n) for s_ in m.segs],
                      "token_exact": len(served) - len(diffs),
                      "first_differences": diffs,
                      "earliest_in_batch": earliest, "oracle_wall_s": wall}
    more = extra() if extra is not None else {}
    emit(phase, requests=MOE_ORACLE_REQUESTS, **out, **more,
         margin_tolerance=f"{tol.atol} x max|logit| at the batch's first "
                          f"difference")
    for d in out["cut_depth"]["earliest_in_batch"]:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{ORACLE_LAYERS}-layer {cfg.name} cut: request {d['rid']} "
              f"differs at token {d['step']} (the batch's first "
              f"difference) with oracle margin {d['margin']} > {tol.atol} "
              f"x max|logit| {d['max_abs_logit']}")
    return more


# --------------------------------------------------------------------------
# 13b. serve_mla and 14b. mla_oracle
# --------------------------------------------------------------------------

def grouped_mainloop_gate(phase: str, cfg, reqs: list[Request],
                          launches: int, moe_layers: int) -> dict:
    """A served MoE run's grouped launches by mainloop: wgmma exactly for
    the prefills that give an expert more than 64 rows (the routing's
    groups x capacity), wmma for every other launch (every decode step)."""
    by = dict(sg.grouped_systolic_gemm_cuda.mainloop_launches)
    rows = [expert_rows(cfg, len(r.prompt)) for r in reqs]
    wide = 3 * moe_layers * sum(m > sg.SPLITK_MAX_M for m in rows)
    check(by["wgmma"] == wide and by["simt"] == 0 and
          by["wmma"] == launches - wide,
          f"{phase}: grouped launches by mainloop {by}: {wide} should be "
          f"wgmma (rows per expert at prefill {rows}), the rest wmma")
    return {"by_mainloop": by, "rows_per_expert_at_prefill": rows}


def mla_cache_bytes(cfg, cache: dict) -> dict:
    """The served latent caches' bytes (c_kv and k_rope of every layer,
    slot and position) against a GQA cache of the same heads: K at
    qk_nope + qk_rope and V at v_head_dim for each of n_heads, in the same
    dtype."""
    m = cfg.mla
    mla = sum(node["attn"].c_kv.nbytes + node["attn"].k_rope.nbytes
              for node in cache.values())
    per_mla = m.kv_lora_rank + m.qk_rope_head_dim
    per_gqa = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                             + m.v_head_dim)
    return {"mla_bytes": mla, "gqa_same_heads_bytes": mla * per_gqa // per_mla,
            "values_per_token_layer": per_mla,
            "gqa_values_per_token_layer": per_gqa}


def phase_serve_mla(model, params):
    """deepseek-v2 through exact-length prefill (MLA decompressed into
    chunked attention, torch ops; the experts on the grouped kernel at G =
    160; the first layer's MLP, the shared experts and the head on the pod
    GEMM) and fused decode (MLA absorbed over the latent cache), graphed
    and eager."""
    cfg = model.cfg
    out = exact_length_run("serve_mla", model, params, MLA_SERVE)
    reqs, launches = out["reqs"], out["launches"]
    launches["pod_gemm_by_mainloop"] = hopper_mainloops("serve_mla")
    L, fd = cfg.n_layers, cfg.moe.first_dense_layers
    # the dense layers' MLP and each MoE layer's shared experts (3 each)
    # and the head on the pod GEMM; the routed experts on the grouped one
    per_forward = {"pod_gemm": 3 * L + 1, "grouped": 3 * (L - fd)}
    check_per_forward("serve_mla", launches, per_forward, out["forwards"])
    check(launches["flash"] == 0 and launches["gemm_nt"] == 0 and
          launches["ssd"] == 0,
          f"deepseek launched a flash, NT-GEMM or SSD kernel: {launches}")
    grouped = grouped_mainloop_gate("serve_mla", cfg, reqs,
                                    launches["grouped"], L - fd)
    launches["grouped_by_mainloop"] = grouped["by_mainloop"]
    launches["grouped_rows_per_expert_at_prefill"] = \
        grouped["rows_per_expert_at_prefill"]
    pair = graphed_vs_eager("serve_mla", model, params, out["eng"],
                            out["run"], reqs, make_paged_requests, MLA_SERVE)
    for label in ("graphed", "eager"):
        pair[label]["decode_chunk_profile"]["top_kernels"] = top_kernels(
            f"serve_mla-{label}")
    weights = sum(t.nbytes for t in param_tensors(params))
    emit("serve_mla", arch=cfg.name, n_layers=L,
         of_layers=get_arch(MLA_ARCH).n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, mla=dataclasses.asdict(cfg.mla),
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         shared_experts=cfg.moe.num_shared_experts,
         segments=[(s_.name, s_.kind, s_.n) for s_ in model.segs],
         attention_impl=model.impl, **MLA_SERVE, **out["figures"],
         graphed_vs_eager=pair, launches=launches,
         launches_per_forward=per_forward,
         cache=mla_cache_bytes(cfg, out["eng"].cache), weight_bytes=weights,
         decode_floor_ms=(weights - params["embed"]["tok"].nbytes)
         / HBM_BYTES_PER_S * 1e3)
    return reqs, launches


def absorbed_vs_decompressed(model, params) -> dict:
    """At ORACLE_LAYERS (dense0 and one MoE layer), the last-position
    logits of a [1, S] prefill (MLA decompressed into chunked attention)
    against feeding the same S tokens through the absorbed decode one at
    a time: the two forms share no arithmetic past the latent. The cut's
    capacity factor is raised to E so that no assignment drops in either
    form (a prefill's tokens share expert capacity, a lone decode token
    never runs out of it); the routed experts and the rest are the served
    ones. Gated by the margin rule where the argmax differs."""
    tol = TOLERANCES["token_margin"]
    cut_model, cut_params = cut_depth(model, params, ORACLE_LAYERS)
    cfg = cut_model.cfg
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    cut_model = Model(cfg, attention_impl=model.impl, use_pallas=True)
    prompt = make_paged_requests(cfg.vocab)[1].prompt      # 957 tokens
    S = len(prompt)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        pre, _ = cut_model.prefill(cut_params, {"tokens": tokens[None]},
                                   cut_model.init_cache(1, MLA_SERVE[
                                       "max_len"]))
        cache = cut_model.init_cache(1, MLA_SERVE["max_len"])
        for t in range(S):
            dec, cache = cut_model.decode_step(cut_params, tokens[t:t + 1],
                                               cache, t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a, b = pre[0].float(), dec[0].float()
    top2 = torch.topk(a, 2).values
    out = {"S": S, "n_layers": cfg.n_layers,
           "capacity_factor": cfg.moe.capacity_factor,
           "max_abs_diff": float((a - b).abs().max()),
           "max_abs_logit": float(a.abs().max()),
           "argmax_equal": bool(a.argmax() == b.argmax()),
           "prefill_margin": float(top2[0] - top2[1]),
           "finite": bool(torch.isfinite(a).all() and
                          torch.isfinite(b).all()),
           "cache_length": int(cache["moe"]["attn"].length[0, 0]),
           "wall_s": wall,
           "margin_tolerance": f"{tol.atol} x max|logit|"}
    return out


def phase_mla_oracle(model, params) -> None:
    """deepseek-v2's engine against the per-token oracle (phase_moe_oracle:
    4 requests of equal budget, full depth reported, the margin rule at
    the batch's first difference on dense0 and one MoE layer), and the
    absorbed decode against the decompressed prefill, on the same margin
    rule."""
    tol = TOLERANCES["token_margin"]
    out = phase_moe_oracle(model, params, phase="mla_oracle", extra=lambda: {
        "absorbed_vs_decompressed": absorbed_vs_decompressed(model, params)})
    a = out["absorbed_vs_decompressed"]
    check(a["finite"], "absorbed vs decompressed: non-finite logits")
    check(a["cache_length"] == a["S"],
          f"absorbed decode left length {a['cache_length']} != {a['S']}")
    check(a["argmax_equal"] or
          a["prefill_margin"] <= tol.atol * a["max_abs_logit"],
          f"absorbed decode's argmax differs from the decompressed "
          f"prefill's with margin {a['prefill_margin']} > {tol.atol} x "
          f"max|logit| {a['max_abs_logit']}")


# --------------------------------------------------------------------------
# 14c. serve_audio and 14d. audio_oracle
# --------------------------------------------------------------------------

def request_embeddings(seed: int, rows: int, d_model: int) -> torch.Tensor:
    """One request's precomputed embeddings [1, rows, d_model] in bf16
    (whisper's frames, a vlm's image tokens), as a bf16 frontend would give
    them, drawn on the card from `seed`."""
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn((1, rows, d_model), generator=g,
                       device="cuda").to(torch.bfloat16)


def audio_frames(seed: int, d_model: int) -> torch.Tensor:
    return request_embeddings(seed, AUDIO_SERVE["src_len"], d_model)


def make_audio_requests(vocab: int) -> list[Request]:
    """N_AUDIO_REQUESTS prompts of 4-64 tokens (whisper's 4-token start of
    transcript, then text tokens; the last one 64 long), each with its own
    frames, MAX_NEW new tokens each."""
    rng = np.random.default_rng(6)
    d = get_arch(AUDIO_ARCH).d_model
    lens = rng.integers(4, 65, N_AUDIO_REQUESTS)
    lens[-1] = 64
    return [Request(rid=i, prompt=np.concatenate([
        np.asarray(AUDIO_PREFIX), rng.integers(0, AUDIO_PREFIX[0],
                                               int(n) - len(AUDIO_PREFIX))]),
        max_new_tokens=MAX_NEW, extras={"frames": audio_frames(500 + i, d)})
        for i, n in enumerate(lens)]


def cross_cache_bytes(node: dict) -> dict:
    """A served cache node's bytes by kind: the self-attention KV (every
    layer, slot and position to max_len) and the cross K/V (every cross
    layer, slot and source row); whisper's `dec`, a vlm's `blocks`."""
    return {"self_kv_bytes": node["attn"].k.nbytes + node["attn"].v.nbytes,
            "cross_kv_bytes": node["cross"].k.nbytes + node["cross"].v.nbytes}


def paged_refuses_extras(model, params, extras: dict,
                         serve_kw: dict) -> dict:
    """A paged engine refuses a request that carries `extras` (whisper's
    frames, a vlm's image embeddings) at submit (InvalidRequest, field
    "extras"): on reduced granite-8b on the card (a bucketed family:
    `model`'s family prefills exact-length and cannot page, which its
    engine refuses at construction, with serve_kw's slots and lengths)."""
    gm = Model(reduced(get_arch(ARCH)), use_pallas=True)
    gp = gm.init(torch.Generator("cuda").manual_seed(0))
    eng = ServeEngine(gm, gp, slots=2, max_len=32, paged=True, page_size=8)
    out = {"extras": sorted(extras)}
    try:
        eng.submit(Request(rid=0, prompt=np.arange(5), extras=dict(extras)))
        out["submit"] = "accepted"
    except InvalidRequest as err:
        out["submit"] = {"field": err.field, "message": str(err)}
    out["queued"] = len(eng.queue)
    try:
        ServeEngine(model, params, paged=True, page_size=8,
                    **{k: v for k, v in serve_kw.items()
                       if k != "decode_chunk"})
        out["own_paged"] = "built"
    except ValueError as err:
        out["own_paged"] = str(err)
    check(isinstance(out["submit"], dict) and
          out["submit"]["field"] == "extras" and out["queued"] == 0,
          f"a paged engine took a request with {sorted(extras)}: {out}")
    check(out["own_paged"] != "built",
          f"{model.cfg.name}'s engine was built paged")
    return out


def phase_serve_audio(model, params):
    """whisper-small through exact-length prefill (the encoder over each
    request's 1500 frames: non-causal flash and the pod GEMMs; the
    decoder's causal flash prefill; the cross K/V written into the static
    cache) and fused decode (no encoder: the cross attention reads the
    cache), graphed and eager. Gates: every request done, 8 prefills of
    [1, S], each encoder pass 72 pod GEMMs and 12 flash launches, each
    prefill's decoder 73 and 12, each decode step 73 and no flash (the
    encoder runs once a prefill and never at decode); by mainloop the
    encoder's GEMMs (M = 1500) on wgmma, the decoder's (M <= 64) on
    splitk, the head (N = 51865, odd) on wmma, every flash launch on
    wgmma; no NT, grouped or SSD launch; a paged engine refuses frames."""
    cfg = model.cfg
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    per_layer = len(AUDIO_GEMMS_PER_LAYER)
    encoder_calls = []
    real_encode = model._encode

    def encode(p, frames):
        g0, f0 = sg.systolic_gemm_cuda.launches, fa.flash_attention_cuda.launches
        out = real_encode(p, frames)
        encoder_calls.append((sg.systolic_gemm_cuda.launches - g0,
                              fa.flash_attention_cuda.launches - f0))
        return out
    model._encode = encode
    warm = {"frames": audio_frames(499, cfg.d_model)}
    try:
        out = exact_length_run("serve_audio", model, params, AUDIO_SERVE,
                               make_audio_requests, extras=warm)
    finally:
        del model._encode
    reqs, st, launches = out["reqs"], out["st"], out["launches"]
    prefills, steps = st["prefill_calls"], st["decode_steps"]
    check(encoder_calls == [(per_layer * Le, Le)] * (1 + prefills),
          f"serve_audio: encoder passes (pod GEMM, flash launches) "
          f"{encoder_calls}: one of ({per_layer * Le}, {Le}) per prefill "
          f"(and the warm-up's), none at decode")
    per_encoder = per_layer * Le
    per_decoder = per_layer * L + 1
    check(launches["pod_gemm"] == per_encoder * prefills
          + per_decoder * (prefills + steps),
          f"serve_audio: pod-GEMM launches {launches['pod_gemm']} != "
          f"{per_encoder} x {prefills} encoder passes + {per_decoder} x "
          f"{prefills + steps} decoder forwards")
    check(launches["flash"] == (Le + L) * prefills,
          f"serve_audio: flash launches {launches['flash']} != {Le + L} x "
          f"{prefills} prefills (none per decode step)")
    by = dict(sg.systolic_gemm_cuda.mainloop_launches)
    longest = max(len(r.prompt) for r in reqs)
    check(longest <= sg.SPLITK_MAX_M and
          by == {"wmma": prefills + steps, "splitk": per_layer * L
                 * (prefills + steps), "wgmma": per_encoder * prefills,
                 "simt": 0},
          f"serve_audio: pod-GEMM launches by mainloop {by}: the encoder's "
          f"on wgmma, the decoder's on splitk, the head on wmma")
    launches["pod_gemm_by_mainloop"] = by
    launches["flash_by_mainloop"] = flash_mainloops("serve_audio")
    check(launches["gemm_nt"] == 0 and launches["grouped"] == 0 and
          launches["ssd"] == 0,
          f"whisper launched an NT, grouped or SSD kernel: {launches}")
    pair = graphed_vs_eager("serve_audio", model, params, out["eng"],
                            out["run"], reqs, make_audio_requests,
                            AUDIO_SERVE, extras=warm)
    for label in ("graphed", "eager"):
        prof = pair[label]["decode_chunk_profile"]
        prof["kernels_per_decode_step"] = prof["kernels"] / prof["steps"]
        prof["top_kernels"] = top_kernels(f"serve_audio-{label}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    encoder_ms = time_ms(lambda: model._encode(params, warm["frames"]), 5,
                         flush)
    prefill_ms = pair["graphed"]["second_pass"]["prefill_ms_per_call"]
    weights = sum(t.nbytes for t in param_tensors(params))
    cache = cross_cache_bytes(out["eng"].cache["dec"])
    dec = params["dec"]
    # what a decode step reads: the decoder's weights but the cross k and
    # v projections, the head, every lane's cross K/V and self KV cache
    step_bytes = (sum(t.nbytes for t in param_tensors(dec))
                  - dec["cross"]["k"].nbytes - dec["cross"]["v"].nbytes
                  + params["embed"]["unembed"].nbytes
                  + cache["cross_kv_bytes"] + cache["self_kv_bytes"])
    emit("serve_audio", arch=cfg.name, n_layers=L, n_encoder_layers=Le,
         d_model=cfg.d_model, heads=cfg.n_heads, vocab=cfg.vocab,
         attention_impl=model.impl, **AUDIO_SERVE, **out["figures"],
         graphed_vs_eager=pair, launches=launches,
         launches_per_encoder_pass={"pod_gemm": per_encoder, "flash": Le},
         launches_per_decoder_prefill={"pod_gemm": per_decoder, "flash": L},
         launches_per_decode_step={"pod_gemm": per_decoder, "flash": 0},
         encoder_ms=encoder_ms, prefill_ms_per_call=prefill_ms,
         encoder_share_of_prefill=(encoder_ms / prefill_ms
                                   if prefill_ms else None),
         cache=cache, weight_bytes=weights, decode_step_bytes=step_bytes,
         decode_floor_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         paged=paged_refuses_extras(
             model, params, {"frames": audio_frames(7, cfg.d_model)},
             AUDIO_SERVE))
    return reqs, launches


def audio_cut(model, params, n_layers: int):
    """The same full-width weights, the first n_layers encoder and
    decoder layers only (views)."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers,
                              n_encoder_layers=n_layers)
    cut = {k: v for k, v in params.items() if k not in ("dec", "encoder")}
    cut["dec"] = layer_slice(params["dec"], 0, n_layers)
    cut["encoder"] = {"blocks": layer_slice(params["encoder"]["blocks"], 0,
                                            n_layers),
                      "ln_f": params["encoder"]["ln_f"]}
    return Model(cfg, attention_impl=model.impl, use_pallas=True), cut


def extras_oracle(phase: str, model, params, served: list[Request], cut,
                  make_requests, serve_kw: dict, **fields) -> None:
    """An exact-length engine whose requests carry extras (whisper's
    frames, a vlm's image embeddings) against the per-token
    ReferenceEngine on the same weights and extras: at full depth
    (`served`, the serve phase's tokens) agreement and the margin rule
    reported, and on `cut` (a smaller model and its weights, views of the
    same) the margin rule held: tokens agree, or differ first after a
    near tie of the oracle. `fields` join the emitted line."""
    tol = TOLERANCES["token_margin"]
    vocab = model.cfg.vocab
    oracle_kw = {k: v for k, v in serve_kw.items() if k != "decode_chunk"}
    out = {}
    for label, (m, p) in (("full_depth", (model, params)),
                          ("cut_depth", cut)):
        if label == "full_depth":
            got = served
        else:
            got = make_requests(vocab)
            serve(ServeEngine(m, p, **serve_kw), got)
        oracle = make_requests(vocab)
        ref = ReferenceEngine(m, p, **oracle_kw)
        wall = serve(ref, oracle)
        diffs = first_differences(got, oracle, ref)
        out[label] = {
            "n_layers": m.cfg.n_layers,
            "segments": [[seg.name, seg.n] for seg in m.segs],
            "token_exact": len(got) - len(diffs), "of": len(got),
            "first_differences": diffs, "oracle_wall_s": wall,
            "margin_rule_holds": all(
                d["margin"] <= tol.atol * d["max_abs_logit"] for d in diffs)}
        if m.cfg.encoder_decoder:
            out[label]["n_encoder_layers"] = m.cfg.n_encoder_layers
    emit(phase, requests=len(served), **out, **fields,
         margin_tolerance=f"{tol.atol} x max|logit| at the first "
                          f"difference")
    for d in out["cut_depth"]["first_differences"]:
        check(d["margin"] <= tol.atol * d["max_abs_logit"],
              f"{phase} cut to {out['cut_depth']['segments']}: request "
              f"{d['rid']} differs at token {d['step']} with oracle margin "
              f"{d['margin']} > {tol.atol} x max|logit| "
              f"{d['max_abs_logit']}")


def phase_audio_oracle(model, params, served: list[Request]) -> None:
    """whisper's engine against the per-token ReferenceEngine
    (extras_oracle), the cut on the first ORACLE_LAYERS encoder and
    decoder layers of the same weights."""
    extras_oracle("audio_oracle", model, params, served,
                  audio_cut(model, params, ORACLE_LAYERS),
                  make_audio_requests, AUDIO_SERVE)


# --------------------------------------------------------------------------
# 14e. serve_vlm and 14f. vlm_oracle
# --------------------------------------------------------------------------

def make_vlm_requests(vocab: int) -> list[Request]:
    """N_VLM_REQUESTS prompts of 16 to VLM_MAX_PROMPT tokens (the first
    16 long, the last VLM_MAX_PROMPT: prefills on both sides of splitk's
    M <= 64), each with its own image embeddings, MAX_NEW new tokens
    each."""
    rng = np.random.default_rng(9)
    cfg = get_arch(VLM_ARCH)
    lens = rng.integers(16, VLM_MAX_PROMPT + 1, N_VLM_REQUESTS)
    lens[0], lens[-1] = 16, VLM_MAX_PROMPT
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(n)),
                    max_new_tokens=MAX_NEW,
                    extras={"image_embeds": request_embeddings(
                        700 + i, cfg.n_image_tokens, cfg.d_model)})
            for i, n in enumerate(lens)]


def image_path_ms(model, params, images: torch.Tensor, flush) -> dict:
    """The image path of one prefill, timed with L2 flushed: img_adapter
    (image embeddings [1, 1601, d] x [d, d]) alone, and with the K/V
    projections of every cross layer; einsums, as in the reference."""
    cross = params["blocks"]["cross"]["cross"]
    groups = cross["k"].shape[0]

    def adapter():
        return model._cross_source(params, {"image_embeds": images})

    def path():
        src = adapter()
        for g in range(groups):
            cross_kv_precompute({k: v[g] for k, v in cross.items()}, src,
                                model.cfg)
    return {"img_adapter_ms": time_ms(adapter, 5, flush),
            "image_path_ms": time_ms(path, 5, flush),
            "image_path_projections": 2 * groups}


def phase_serve_vlm(model, params):
    """llama-3.2-vision-90b at VLM_LAYERS of its 100 layers through
    exact-length prefill (each request's image embeddings through
    img_adapter, every cross layer's K/V written into the static cache,
    causal flash in every dense layer) and fused decode (the cross layers
    read their K/V from the cache), graphed and eager. Gates: every
    request done, 8 prefills of [1, S], 7 pod GEMMs a dense layer, 3 a
    cross layer and the head a forward (187 at 30 layers), one flash
    launch a dense layer a prefill and none a decode step; by mainloop
    every GEMM of a forward at M <= 64 (decode, and a prompt of up to 64
    tokens) on splitk and at M > 64 on wgmma, the head (N = 128256, a
    multiple of 128) with them; every flash launch on wgmma; no NT,
    grouped or SSD launch; one decode step's logits bit-equal graphed and
    eager; a paged engine refuses image embeddings."""
    cfg = model.cfg
    groups = cfg.n_layers // cfg.cross_attn_every
    dense_layers = cfg.n_layers - groups
    warm = {"image_embeds": request_embeddings(699, cfg.n_image_tokens,
                                               cfg.d_model)}
    out = exact_length_run("serve_vlm", model, params, VLM_SERVE,
                           make_vlm_requests, extras=warm)
    reqs, st, launches = out["reqs"], out["st"], out["launches"]
    prefills, steps = st["prefill_calls"], st["decode_steps"]
    per_forward = (len(GEMMS_PER_LAYER) * dense_layers
                   + len(VLM_CROSS_GEMMS_PER_LAYER) * groups + 1)
    check_per_forward("serve_vlm", launches, {"pod_gemm": per_forward},
                      out["forwards"])
    check(launches["flash"] == dense_layers * prefills,
          f"serve_vlm: flash launches {launches['flash']} != "
          f"{dense_layers} x {prefills} prefills (none per decode step)")
    long = sum(len(r.prompt) > sg.SPLITK_MAX_M for r in reqs)
    head = {M: sg.nn_plan(M, cfg.vocab, cfg.d_model, torch.bfloat16,
                          True).mainloop
            for M in (SLOTS, VLM_MAX_PROMPT)}
    check(head == {SLOTS: "splitk", VLM_MAX_PROMPT: "wgmma"},
          f"serve_vlm: the head's plan {head} is not splitk at decode and "
          f"wgmma at the longest prompt")
    by = hopper_mainloops("serve_vlm")
    check(by == {"splitk": per_forward * (prefills - long + steps),
                 "wgmma": per_forward * long, "wmma": 0, "simt": 0},
          f"serve_vlm: pod-GEMM launches by mainloop {by}: {long} prefills "
          f"of more than {sg.SPLITK_MAX_M} tokens on wgmma, the rest and "
          f"every decode step on splitk, {per_forward} a forward")
    launches["pod_gemm_by_mainloop"] = by
    launches["flash_by_mainloop"] = flash_mainloops("serve_vlm")
    check(launches["gemm_nt"] == 0 and launches["grouped"] == 0 and
          launches["ssd"] == 0,
          f"the vlm launched an NT, grouped or SSD kernel: {launches}")
    pair = graphed_vs_eager("serve_vlm", model, params, out["eng"],
                            out["run"], reqs, make_vlm_requests, VLM_SERVE,
                            extras=warm)
    check(pair["decode_logits"]["bit_equal"],
          f"serve_vlm: one decode step's logits differ graphed and eager: "
          f"{pair['decode_logits']}")
    for label in ("graphed", "eager"):
        prof = pair[label]["decode_chunk_profile"]
        prof["kernels_per_decode_step"] = prof["kernels"] / prof["steps"]
        prof["top_kernels"] = top_kernels(f"serve_vlm-{label}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    image = image_path_ms(model, params, warm["image_embeds"], flush)
    prefill_ms = pair["graphed"]["second_pass"]["prefill_ms_per_call"]
    weights = sum(t.nbytes for t in param_tensors(params))
    cache = cross_cache_bytes(out["eng"].cache["blocks"])
    cross = params["blocks"]["cross"]["cross"]
    # what a decode step reads: the weights but the token table (4 rows
    # of it), the cross layers' k and v projections and img_adapter (a
    # prefill's), every lane's self KV to max_len and image K/V
    step_bytes = (weights - params["embed"]["tok"].nbytes
                  - cross["k"].nbytes - cross["v"].nbytes
                  - params["img_adapter"].nbytes
                  + cache["self_kv_bytes"] + cache["cross_kv_bytes"])
    emit("serve_vlm", arch=cfg.name, n_layers=cfg.n_layers,
         of_layers=get_arch(VLM_ARCH).n_layers, groups=groups,
         dense_layers=dense_layers, cross_layers=groups,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.vocab,
         image_tokens=cfg.n_image_tokens, attention_impl=model.impl,
         **VLM_SERVE, **out["figures"], graphed_vs_eager=pair,
         launches=launches,
         launches_per_forward={"pod_gemm": per_forward},
         launches_per_prefill={"flash": dense_layers},
         launches_per_decode_step={"pod_gemm": per_forward, "flash": 0},
         head_mainloop=head, prefill_ms_per_call=prefill_ms, **image,
         image_share_of_prefill=(image["image_path_ms"] / prefill_ms
                                 if prefill_ms else None),
         cache=cache, weight_bytes=weights, decode_step_bytes=step_bytes,
         decode_floor_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         paged=paged_refuses_extras(model, params, warm, VLM_SERVE))
    return reqs, launches


def phase_vlm_oracle(model, params, served: list[Request]) -> None:
    """The vlm's engine against the per-token ReferenceEngine
    (extras_oracle), the cut on the first group of the same weights
    (cut_depth: 4 dense layers and a cross layer). A cut that is not
    whole groups must be refused."""
    group = model.cfg.cross_attn_every
    try:
        cut_depth(model, params, group + 1)
        ragged = "built"
    except ValueError as err:
        ragged = str(err)
    check(ragged != "built", f"a {group + 1}-layer cut of the vlm was built")
    extras_oracle("vlm_oracle", model, params, served,
                  cut_depth(model, params, group), make_vlm_requests,
                  VLM_SERVE, ragged_cut=ragged)


# --------------------------------------------------------------------------
# 15. serve_hybrid and 16. hybrid_oracle
# --------------------------------------------------------------------------

def flash_windows_per_forward(model, params, S: int) -> list:
    """The window of each flash launch of one eager [1, S] forward, in
    layer order, as the model hands it to the kernel."""
    windows = []
    real = fl_ops.flash_attention_cuda

    def spy(q, k, v, **kw):
        windows.append(kw.get("window"))
        return real(q, k, v, **kw)
    fl_ops.flash_attention_cuda = spy
    try:
        tokens = torch.arange(S, device="cuda")[None] % model.cfg.vocab
        model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        fl_ops.flash_attention_cuda = real
    return windows


def hybrid_launches(phase: str, cfg, st: dict, table: dict) -> dict:
    """A served hymba run's launches (launch_table) against its counts per
    forward: 7 pod GEMMs a layer and the untied head (the head, N = 32001,
    on wmma; the rest on splitk or wgmma by M), flash and SSD once a layer
    per prefill and never at decode (flash on wgmma, SSD on serial), no
    NT or grouped launch. `st`: the run's engine stats."""
    L = cfg.n_layers
    forwards = st["prefill_calls"] + st["decode_steps"]
    per_forward = HYBRID_GEMMS_PER_LAYER * L + 1
    gemm = table["pod_gemm"]
    by = gemm["by_mainloop"]
    check(gemm["launches"] == per_forward * forwards,
          f"{phase}: pod-GEMM launches {gemm['launches']} != {per_forward} "
          f"x {forwards} forwards")
    check(by["wmma"] == forwards and by["simt"] == 0 and
          by["splitk"] + by["wgmma"] == (per_forward - 1) * forwards,
          f"{phase}: pod-GEMM launches by mainloop {by}: the head's "
          f"{forwards} on wmma, the rest on splitk or wgmma")
    for name, mainloop in (("flash", "wgmma"), ("ssd", "serial")):
        t = table[name]
        check(t["launches"] == L * st["prefill_calls"] and
              t["by_mainloop"][mainloop] == t["launches"],
              f"{phase}: {name} launches {t} != {L} x "
              f"{st['prefill_calls']} prefill calls, all on {mainloop}")
    check(table["gemm_nt"]["launches"] == 0 and
          table["grouped"]["launches"] == 0,
          f"{phase}: hymba launched an NT or grouped GEMM: {table}")
    return {"per_forward": {"pod_gemm": per_forward, "flash_per_prefill": L,
                            "ssd_per_prefill": L}, **table}


def cache_bytes(cache: dict) -> dict:
    """Device bytes of a served cache's k, v, conv and state by kind:
    sliding-window rings, global KV (dense, or the paged pool), SSM state
    (conv window and state); lengths and page tables left out."""
    out = {"rings": 0, "global_kv": 0, "ssm_state": 0}
    for node in cache.values():
        for c in node.values():
            kind = {"RingKVCache": "rings", "SSMCache": "ssm_state"}.get(
                type(c).__name__, "global_kv")
            out[kind] += sum(getattr(c, f.name).nbytes
                             for f in dataclasses.fields(c)
                             if getattr(c, f.name).is_floating_point())
    return out


def phase_serve_hybrid(model, params):
    """hymba through bucketed prefill (windowed and global flash, the SSD
    kernel on serial, the ring gather) and fused decode (rings and a
    recurrent SSM step in torch ops), every projection and the untied
    head on the pod GEMM; dense, then paged for the global layers."""
    cfg = model.cfg
    dense_kw = dense_of(PAGED)
    # warm-up at the largest bucket: lazy set-up stays out of the timings
    serve(ServeEngine(model, params, **dense_kw),
          [Request(rid=-1, prompt=np.arange(PAGED["max_len"] // 2 + 1)
                   % cfg.vocab, max_new_tokens=2)])
    windows = flash_windows_per_forward(model, params, 1100)
    expect = [seg.window for seg in model.segs for _ in range(seg.n)]
    check(windows == expect and len(windows) == cfg.n_layers and
          windows.count(None) == len(cfg.global_attn_layers),
          f"flash windows per forward {windows}, expected {expect}")
    reqs = make_paged_requests(cfg.vocab)
    eng = ServeEngine(model, params, **dense_kw)
    run = counted_serve(eng, reqs)
    st = dict(eng.stats)     # the first pass's (graphed_vs_eager serves more)
    check_served("hybrid", cfg, reqs)
    launches = hybrid_launches("serve_hybrid", cfg, st, run["launches"])
    check(run["syncs"] == st["prefill_calls"] + st["chunks"],
          f"host syncs {run['syncs']} != prefill groups + decode chunks")
    pair = graphed_vs_eager("serve_hybrid", model, params, eng, run, reqs,
                            make_paged_requests, dense_kw)
    tokens = [r.out for r in reqs]

    # paged for the global layers (rings and SSM state stay lane-resident):
    # two graphed passes, each equal to the dense tokens, the pool drained
    peng = ServeEngine(model, params, **PAGED)
    paged = []
    for _ in range(2):
        preqs = make_paged_requests(cfg.vocab)
        st0 = dict(peng.stats)
        prun = counted_serve(peng, preqs)
        check_served("hybrid paged", cfg, preqs)
        check([r.out for r in preqs] == tokens,
              f"hybrid paged tokens differ from dense: "
              f"{[r.rid for r, t in zip(preqs, tokens) if r.out != t]}")
        peng._pool.assert_drained()
        figures = pass_figures(peng, prun, preqs, st0)
        pst = {k: v - st0.get(k, 0) for k, v in peng.stats.items()
               if not isinstance(v, bool)}
        hybrid_launches("serve_hybrid paged", cfg, pst, prun["launches"])
        check(prun["syncs"] == pst["prefill_calls"] + pst["chunks"],
              f"paged host syncs {prun['syncs']} != prefill groups + "
              f"decode chunks")
        paged.append(figures)
    check(paged[1]["graphs"] == 0,
          f"the paged engine's second pass captured {paged[1]['graphs']}")
    weights = sum(t.nbytes for t in param_tensors(params))
    caches = cache_bytes(eng.cache)
    floor_bytes = weights + sum(caches.values())
    memory = {"weight_bytes": weights, "params": model.param_count(),
              "dense_cache_bytes": caches,
              "paged_cache_bytes": cache_bytes(peng.cache),
              "paged_kv_stats": peng.paged_kv_stats(),
              "graph_pool_bytes": {
                  "dense": pair["graphed"]["graph_pool_bytes"],
                  "paged": peng.graph_pool_bytes()},
              "static_lane_cache_bytes": {
                  "dense": pair["graphed"]["static_lane_cache_bytes"],
                  "paged": sum(t.nbytes for lane in
                               peng._lane_caches.values()
                               for t in cache_tensors(lane))},
              "decode_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
              "decode_floor_is": "weights and dense caches once at the "
                                 "HBM rate"}
    emit("serve_hybrid", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, window=cfg.sliding_window,
         global_layers=list(cfg.global_attn_layers),
         segments=[(seg.name, seg.n, seg.window) for seg in model.segs],
         attention_impl=model.impl, ssd_impl=model.ssd_impl, **PAGED,
         prompt_lens=[len(r.prompt) for r in reqs], max_new_tokens=MAX_NEW,
         requests_done=len(reqs), tokens_generated=sum(map(len, tokens)),
         wall_s=run["wall_s"], prefill_calls=st["prefill_calls"],
         decode_chunks=st["chunks"], decode_steps=st["decode_steps"],
         host_syncs=run["syncs"], launches=launches,
         flash_windows_per_forward=windows, graphed_vs_eager=pair,
         paged_passes=paged, paged_recycled=peng.recycled, memory=memory,
         largest_bucket=max(eng._bucket(len(r.prompt)) for r in reqs))
    return reqs, launches


# --------------------------------------------------------------------------
# 19. guard, 20. guard_ssm and 21. dense_archs
# --------------------------------------------------------------------------

GUARD_MODES = ("off", "probe", "abft")
# benchmarks/serving.py's SDC run: seed 7, one element a hit, a corrupt
# site replayed once, three retries; p_sdc per gate
GUARD_SDC = dict(seed=7, sdc_elems=1, transient_tries=1)
GUARD_EXHAUSTED = dict(seed=7, p_sdc=0.9, sdc_elems=2, transient_tries=10)
# The probe's tolerance (the reference's freivalds_detect) is rtol (max|c|
# + 1) sqrt(N), and a lone element moved by delta dominates max|c|: it is
# caught only where rtol sqrt(N) is under about 1, N < 4096 at rtol 1/64
# (tests/test_torch_guard.py). Granite's GEMM 0 (q, N = 4096) is past
# that, and a hit there passes unless its element was negative enough;
# GEMM 1 (k, N = 1024) is inside it.
PROBE_BLIND_TARGET, PROBE_TARGET = 0, 1


def guarded_call(mode: str, x, w, act):
    """One pod GEMM of the served model (bf16 out) under `mode`: the plain
    kernel call for off, the guarded GEMM otherwise."""
    if mode == "off":
        return sg.systolic_gemm_cuda(x, w, activation=act,
                                     out_dtype=torch.bfloat16)
    return guard_mod.guarded_gemm(x, w, guard=guard_mod.PodGuard(mode=mode),
                                  activation=act, out_dtype=torch.bfloat16)


def guard_gemm_rows(cfg, phases, seed: int) -> dict:
    """The pod GEMMs of one granite-8b forward at each (phase, M, iters)
    under off, probe and abft: each checked against the plain version
    (gemm_bf16out), timed with L2 flushed, its launches by mainloop, and
    torch.matmul on the same augmented operands beside abft; sums over a
    forward (each projection once a layer, the head once)."""
    shapes = forward_gemms(cfg)
    g = torch.Generator("cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows = []
    totals = {ph: {m: 0.0 for m in GUARD_MODES + ("library_aug",)}
              for ph, _, _ in phases}
    by_mainloop = {ph: {m: dict.fromkeys(sg.MAINLOOPS, 0)
                        for m in GUARD_MODES} for ph, _, _ in phases}
    for phase, M, iters in phases:
        for name, (K, N, act) in shapes.items():
            x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
            ref = systolic_gemm_ref(x, w, activation=act,
                                    out_dtype=torch.bfloat16)
            per_forward = 1 if name == "head" else cfg.n_layers
            row = {"gemm": name, "phase": phase, "M": M, "K": K, "N": N,
                   "activation": act}
            for mode in GUARD_MODES:
                before = dict(sg.systolic_gemm_cuda.mainloop_launches)
                got = guarded_call(mode, x, w, act)
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in
                            sg.systolic_gemm_cuda.mainloop_launches.items()
                            if v != before[k]}
                check(TOLERANCES["gemm_bf16out"].ok(got, ref),
                      f"guard {mode} {phase} {name}: disagrees with plain "
                      f"(max_abs_err "
                      f"{float((got.double() - ref.double()).abs().max())})")
                del got
                for k, v in launched.items():
                    by_mainloop[phase][mode][k] += per_forward * v
                row[mode] = {"ms": time_ms(lambda: guarded_call(
                    mode, x, w, act), iters, flush), "mainloops": launched}
                totals[phase][mode] += per_forward * row[mode]["ms"]
            xa, wa = guard_mod.augment_x(x), guard_mod.augment_w(w)
            row["library_aug_ms"] = time_ms(lambda: torch.matmul(xa, wa),
                                            iters, flush)
            totals[phase]["library_aug"] += per_forward * row[
                "library_aug_ms"]
            row["abft_bound_ms"], row["abft_bound_by"] = bound(
                2 * (M + 1) * (N + 1) * K,
                2 * ((M + 1) * K + K * (N + 1)) + 4 * (M + 1) * (N + 1))
            rows.append(row)
            del x, w, xa, wa, ref
    check(all(by_mainloop[ph]["abft"]["wmma"] > 0 for ph in by_mainloop),
          f"abft's augmented GEMMs did not run wmma: {by_mainloop}")
    return {"rows": rows, "forward_ms": totals, "by_mainloop": by_mainloop,
            "per_forward": (len(shapes) - 1) * cfg.n_layers + 1}


def guard_planted_element(seed: int) -> dict:
    """One guarded GEMM at granite's head (M = 4): an element planted at a
    known (row, col) of the raw augmented output is located there and
    repaired within gemm_bf16_f32out of the plain version; the same through
    the injection plan at the element its hash names."""
    M, K, N = SLOTS, 4096, 49152
    g = torch.Generator("cuda").manual_seed(seed)
    x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
    plain = systolic_gemm_ref(x, w)
    tol = TOLERANCES["gemm_bf16_f32out"]
    c_aug = sg.systolic_gemm_cuda(guard_mod.augment_x(x),
                                  guard_mod.augment_w(w))
    r, c = 2, 31337
    c_aug[r, c] += 1e4
    out, rep = guard_mod.abft_verify(c_aug, x, w, rtol=1.0 / 64)
    got = {k: int(v) for k, v in rep.items()}
    check(got == {"detected": 1, "corrected": 1, "uncorrected": 0,
                  "row": r, "col": c},
          f"guard: planted element at {(r, c)} reported {got}")
    element = tol.excess(out[r:r + 1, c:c + 1], plain[r:r + 1, c:c + 1])
    check(element <= 1.0 and tol.ok(out, plain),
          f"guard: repaired element excess {element}, block "
          f"{tol.excess(out, plain)}")
    plan = torch.tensor([0, 12345, 1], device="cuda")
    draws = guard_mod.sdc_draws(plan[1])
    r0, c0 = int(draws[0]) % M, int(draws[1]) % N
    guard = guard_mod.PodGuard(mode="abft")
    with guard_mod.GuardTape(guard, inject=plan) as tape:
        hit = guard_mod.guarded_gemm(x, w, guard=guard)
    totals = [int(t) for t in tape.totals()]
    check(totals == [1, 0] and tol.ok(hit, plain),
          f"guard: injected element at {(r0, c0)}: totals {totals}, excess "
          f"{tol.excess(hit, plain)}")
    return {"shape": [M, K, N], "planted_at": [r, c], "report": got,
            "repaired": float(out[r, c]), "plain": float(plain[r, c]),
            "element_excess": element,
            "max_abs_err": float((out - plain).abs().max()),
            "injected_at": [r0, c0], "injected_totals": totals,
            "injected_excess": tol.excess(hit, plain)}


def guard_margin(model, params, req: Request, step: int, guard) -> dict:
    """The top-1 minus top-2 logit of the guarded model before token
    `step` of req.out, teacher-forced at exact length (the margin rule
    for a differing token)."""
    seq = np.concatenate([req.prompt, np.asarray(req.out[:step])])
    toks = torch.as_tensor(seq, device="cuda")[None]
    with guard_mod.GuardTape(guard_mod.as_guard(guard)):
        logits, _ = model.forward(params, {"tokens": toks})
    last = logits[0, -1].float()
    top2 = torch.topk(last, 2).values
    return {"rid": req.rid, "step": step,
            "margin": float(top2[0] - top2[1]),
            "max_abs_logit": float(last.abs().max())}


def tokens_under_margin(label: str, model, params, got: list[Request],
                        clean: list[Request], guard) -> list[dict]:
    """Tokens equal to the clean run's, or differing only after a near tie
    of the clean run's guarded model; the differences are returned."""
    tol = TOLERANCES["token_margin"]
    diffs = []
    for a, b in zip(got, clean):
        if a.out != b.out:
            j = next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                      if x != y), min(len(a.out), len(b.out)))
            d = guard_margin(model, params, b, j, guard)
            diffs.append(d)
            check(d["margin"] <= tol.atol * d["max_abs_logit"],
                  f"{label}: request {a.rid} differs at token {j} with "
                  f"margin {d['margin']} > {tol.atol} x max|logit| "
                  f"{d['max_abs_logit']}")
    return diffs


def rearm(eng, chaos: dict | None = None, max_retries: int = 3,
          metrics=None):
    """`eng` restarted (ServeEngine.restart) on a fresh VirtualClock with
    ChaosConfig(**chaos): a new run on the runners and graphs it has, so
    a gate does not capture them again."""
    eng.restart(metrics=metrics, clock=VirtualClock(),
                chaos=ChaosConfig(**chaos) if chaos is not None else None,
                max_retries=max_retries)
    return eng


class IgnoresUncorrected(ServeEngine):
    """Planted control: a guarded call's uncorrected output is served as
    if it were clean."""

    def _verdict(self, kind, flags):
        return int(flags[0])


class NoRestore(ServeEngine):
    """Planted control: a retried decode chunk starts from the state the
    failed attempt left (the SSM state stepped, the lengths advanced)."""

    def _restore_decode_state(self):
        pass


def gate_run(out: dict, phase: str, label: str, eng, reqs) -> dict:
    """Serve reqs on eng (counted_serve); every request must end and
    nothing stay held. out[label] gets the run's figures: requests done,
    end states, syncs, graphs captured, chunks and prefill calls in this
    run, guard events, the injector's counts and the pod GEMM's launches
    by mainloop."""
    st0 = dict(eng.stats)
    run = counted_serve(eng, reqs)
    check_drained(f"{phase} {label}", eng, reqs)
    st = {k: eng.stats[k] - st0[k] for k in ("graphs", "chunks",
                                              "prefill_calls")}
    out[label] = {
        "requests_done": sum(r.state == "done" for r in reqs),
        "states": sorted({(r.state, r.reason) for r in reqs}),
        "syncs": run["syncs"], "graphs_captured": st["graphs"],
        "chunks": st["chunks"], "prefill_calls": st["prefill_calls"],
        "guard_events": dict(eng.guard_events),
        "injected": (dict(eng._chaos.injected)
                     if eng._chaos is not None else None),
        "pod_gemm_by_mainloop": run["launches"]["pod_gemm"]["by_mainloop"],
        "nt_by_mainloop": run["launches"]["gemm_nt"]["by_mainloop"]}
    return run


def guard_engines(model, params, base: dict) -> dict:
    """The engine gates on full-width granite-8b and the serve requests
    (benchmarks/serving.py's SDC parameters, VirtualClock), and the decode
    figures under each mode. One engine a mode; each gate restarts it
    (rearm), and a gate's graphs must be its clean run's (none captured).
    The planted control is an engine of its own (IgnoresUncorrected)."""
    cfg = model.cfg
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    out = {}

    def run_engine(label, eng):
        reqs = make_requests(cfg.vocab)
        return reqs, gate_run(out, f"guard {label}", label, eng, reqs)

    def retries(metrics):
        return sum(metrics.counter("serve.chaos.retries", kind=k).value
                   for k in ("prefill", "decode"))

    # 1. off equals the serve phase's engine
    off = ServeEngine(model, params, guard="off", **kw)
    off_reqs, off_run = run_engine("off", off)
    got = {"tokens": [r.out for r in off_reqs], "syncs": off_run["syncs"],
           "launches": off_run["launches"], "graphs": off.stats["graphs"],
           "runners": (off.prefill_compiles, off.decode_compiles)}
    for key, value in got.items():
        check(value == base[key],
              f"guard off: {key} {value} != the serve phase's {base[key]}")
    check(len(off_run["reads"]) == len(base["reads"]) and all(
        np.array_equal(a, b) for a, b in zip(off_run["reads"],
                                             base["reads"])),
          "guard off: host reads differ from the serve phase's")
    # the clean guarded runs every gate is held to
    clean = {}
    engines = {"off": off}
    for mode in ("abft", "probe"):
        eng = ServeEngine(model, params, guard=mode, clock=VirtualClock(),
                          **kw)
        reqs, run = run_engine(f"{mode}_clean", eng)
        check(run["syncs"] == off_run["syncs"] and
              eng.stats["chunks"] == off.stats["chunks"] and
              eng.stats["graphs"] == off.stats["graphs"],
              f"guard {mode}: syncs {run['syncs']}, chunks "
              f"{eng.stats['chunks']}, graphs {eng.stats['graphs']} != "
              f"off's {off_run['syncs']}, {off.stats['chunks']}, "
              f"{off.stats['graphs']}")
        out[f"{mode}_clean"].update(
            capture_s=eng.stats["capture_s"],
            graph_pool_bytes=eng.graph_pool_bytes(),
            syncs_per_call=run["syncs"] / (eng.stats["chunks"] +
                                           eng.stats["prefill_calls"]),
            tokens_equal_off=[r.out for r in reqs] == got["tokens"])
        clean[mode] = [r.out for r in reqs]
        engines[mode] = eng
    abft, probe = engines["abft"], engines["probe"]
    # 2. abft corrects single elements
    metrics = MetricsRegistry()
    reqs, _ = run_engine("abft_sdc", rearm(
        abft, dict(GUARD_SDC, p_sdc=0.5), metrics=metrics))
    ev, inj = abft.guard_events, abft._chaos.injected
    check(inj["sdc"] > 0 and ev["corrected"] > 0 and
          ev["uncorrectable"] == 0 and all(r.state == "done" for r in reqs),
          f"guard abft sdc: injected {inj}, events {ev}")
    clean_reqs = make_requests(cfg.vocab)
    for r, toks in zip(clean_reqs, clean["abft"]):
        r.out = toks
    out["abft_sdc"]["differences"] = tokens_under_margin(
        "guard abft sdc", model, params, reqs, clean_reqs, "abft")
    out["abft_sdc"]["serve.guard.corrected"] = metrics.counter(
        "serve.guard.corrected").value
    # 2b. two elements a hit heal by retry; the planted verdict that
    # ignores uncorrected output must not
    two = dict(GUARD_SDC, sdc_elems=2, p_sdc=0.5)
    planted = IgnoresUncorrected(model, params, guard="abft", **kw)
    for label, eng in (("abft_sdc2", abft),
                       ("planted_ignored_verdict", planted)):
        reqs, _ = run_engine(label, rearm(eng, two))
        out[label]["tokens_equal_clean"] = [r.out for r in reqs] == \
            clean["abft"]
    del planted, eng
    check(out["abft_sdc2"]["tokens_equal_clean"] and
          out["abft_sdc2"]["guard_events"]["uncorrectable"] == 0,
          f"guard abft two elements: {out['abft_sdc2']}")
    check(not out["planted_ignored_verdict"]["tokens_equal_clean"],
          "planted control (uncorrected verdicts ignored) passed token "
          "equality with the clean abft run")
    # 3. probe heals through retries where its tolerance lies under a
    # lone element (k); at q it lies above, so hits pass undetected, as
    # the reference's tolerance says: fewer retries than hits
    for label, target in (("probe_sdc", PROBE_TARGET),
                          ("probe_sdc_blind", PROBE_BLIND_TARGET)):
        metrics = MetricsRegistry()
        reqs, _ = run_engine(label, rearm(
            probe, dict(GUARD_SDC, p_sdc=0.6, sdc_target=target),
            metrics=metrics))
        out[label].update(sdc_target=target, retries=retries(metrics),
                          tokens_equal_clean=[r.out for r in reqs] ==
                          clean["probe"])
    check(out["probe_sdc"]["injected"]["sdc"] > 0 and
          out["probe_sdc"]["retries"] == out["probe_sdc"]["injected"]["sdc"]
          and out["probe_sdc"]["guard_events"]["uncorrectable"] == 0 and
          out["probe_sdc"]["tokens_equal_clean"],
          f"guard probe sdc: {out['probe_sdc']}")
    check(out["probe_sdc_blind"]["retries"] <
          out["probe_sdc_blind"]["injected"]["sdc"],
          f"guard probe at q (N = 4096): every hit detected, against the "
          f"reference's tolerance {out['probe_sdc_blind']}")
    # 4. retries exhausted, dense (the abft engine) and paged
    paged = ServeEngine(model, params, guard="abft", paged=True,
                        page_size=16, clock=VirtualClock(), **kw)
    for label, eng in (("exhausted_dense", abft),
                       ("exhausted_paged", paged)):
        metrics = MetricsRegistry()
        reqs, _ = run_engine(label, rearm(eng, GUARD_EXHAUSTED,
                                          max_retries=1, metrics=metrics))
        rejected = [r for r in reqs if r.reason == "sdc-uncorrectable"]
        check(rejected and eng.guard_events["uncorrectable"] > 0 and
              metrics.counter("serve.chaos.sdc_uncorrectable").value ==
              eng.guard_events["uncorrectable"],
              f"guard {label}: {out[label]}")
    del paged
    for label in out:
        if label not in ("off", "abft_clean", "probe_clean",
                         "planted_ignored_verdict", "exhausted_paged"):
            check(out[label]["graphs_captured"] == 0,
                  f"guard {label}: a re-armed engine captured "
                  f"{out[label]['graphs_captured']} graphs")
    # decode ms/step in turns, clean second passes: off, abft, abft, off;
    # probe; one profiled abft decode chunk
    turns = []
    for mode in ("off", "abft", "abft", "off", "probe"):
        eng = rearm(engines[mode])
        st0 = dict(eng.stats)
        again = make_requests(cfg.vocab)
        run2 = counted_serve(eng, again)
        fig = pass_figures(eng, run2, again, st0)
        check(fig["graphs"] == 0 and [r.out for r in again] == (
            clean[mode] if mode != "off" else got["tokens"]),
              f"guard {mode}: a second pass captured {fig['graphs']} graphs "
              f"or changed tokens")
        turns.append({"mode": mode, **{k: fig[k] for k in (
            "decode_ms_per_step", "prefill_ms_per_call", "tokens_per_s",
            "host_syncs", "decode_chunks", "prefill_calls")}})
    out["second_passes_in_turns"] = turns
    label = "guard-abft"
    out["abft_decode_chunk_profile"] = profile_decode_chunk(
        rearm(abft), cfg.vocab, label)
    out["abft_decode_chunk_profile"]["top_kernels"] = top_kernels(label)
    del engines, off, abft, probe
    return out


def top_kernels(label: str, n: int = 8) -> list[dict]:
    """The n kernels of a profile_decode_chunk trace with the most device
    time: name, launches and ms summed."""
    path = _build.REPO_ROOT / "build" / "profiles" / f"{label}.json"
    by: dict[str, list] = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            row = by.setdefault(e["name"][:120], [0, 0.0])
            row[0] += 1
            row[1] += float(e.get("dur", 0.0)) / 1e3
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"kernel": k, "launches": c, "ms": ms} for k, (c, ms) in rows]


def phase_guard(model, params, base: dict) -> dict:
    """granite-8b at full width under the SDC guard: kernel level (the 253
    GEMMs of a decode step and of a [4, 256] forward under off, probe and
    abft; a planted element), then the engine gates."""
    t0 = time.perf_counter()
    reset_launch_counts()
    kernel = guard_gemm_rows(model.cfg, (("decode", SLOTS, 10),
                                         ("prefill", SLOTS * 256, 3)),
                             seed=21)
    planted = guard_planted_element(seed=22)
    t1 = time.perf_counter()
    engines = guard_engines(model, params, base)
    emit("guard", gpu=gpu_name_and_power(), kernel=kernel,
         planted_element=planted, engines=engines,
         wall_s={"kernel": t1 - t0, "engines": time.perf_counter() - t1})
    return {"by_mainloop": kernel["by_mainloop"],
            "forward_ms": kernel["forward_ms"],
            "per_forward": kernel["per_forward"],
            "served_abft_by_mainloop": engines["abft_clean"][
                "pod_gemm_by_mainloop"],
            "served_probe_by_mainloop": engines["probe_clean"][
                "pod_gemm_by_mainloop"]}


def phase_guard_ssm(model, params) -> None:
    """mamba2-370m (the serve_ssm engine's configuration) with SDC on its
    one guarded GEMM, the tied head (N = 50280): decode chunks that fail
    the guard are retried after the restore of the SSM state, conv window
    and lengths they advanced, so the tokens are the clean run's; the
    planted engine without the restore must fail that. The probe's
    tolerance at N = 50280 lies above any lone element (PROBE_TARGET's
    comment), so the retries come from abft's uncorrectable two-element
    hits (replayed once); probe with single elements is run and
    reported: its hits pass undetected. One engine a mode, restarted; the
    planted control is an engine of its own (NoRestore)."""
    cfg = model.cfg
    two = dict(GUARD_SDC, p_sdc=0.6, sdc_elems=2)
    out, runs = {}, {}
    engines = {mode: cls(model, params, guard=guard, **SSM_SERVE)
               for mode, cls, guard in (("abft", ServeEngine, "abft"),
                                        ("probe", ServeEngine, "probe"),
                                        ("planted", NoRestore, "abft"))}
    for label, mode, chaos in (
            ("clean", "abft", None), ("sdc", "abft", two),
            ("planted_no_restore", "planted", two),
            ("probe_clean", "probe", None),
            ("probe_sdc_blind", "probe", dict(GUARD_SDC, p_sdc=0.6))):
        metrics = MetricsRegistry()
        reqs = make_paged_requests(cfg.vocab)
        gate_run(out, "guard_ssm", label,
                 rearm(engines[mode], chaos, metrics=metrics), reqs)
        runs[label] = [r.out for r in reqs]
        out[label]["decode_retries"] = metrics.counter(
            "serve.chaos.retries", kind="decode").value
    del engines
    check(out["sdc"]["decode_retries"] > 0 and
          out["sdc"]["guard_events"]["uncorrectable"] == 0 and
          runs["sdc"] == runs["clean"],
          f"guard_ssm: abft, two elements on decode {out['sdc']}, tokens "
          f"equal {runs['sdc'] == runs['clean']}")
    check(out["planted_no_restore"]["decode_retries"] > 0 and
          runs["planted_no_restore"] != runs["clean"],
          "planted control (no restore before a decode retry) passed token "
          "equality with the clean run")
    for label, ref in (("planted_no_restore", "clean"),
                       ("probe_sdc_blind", "probe_clean")):
        out[label]["requests_unequal"] = [
            i for i, (a, b) in enumerate(zip(runs[label], runs[ref]))
            if a != b]
    emit("guard_ssm", arch=cfg.name, **out)


# the dense archs beyond granite-8b: yi-6b and minitron-8b at full width
# and depth, nemotron-4-340b at full width cut to 4 of 96 layers (its
# untied embedding and head 18.9 GB, a layer 6.9 GB: 46.5 GB of weights)
DENSE_ARCHS = (("yi-6b", None), ("minitron-8b", None),
               ("nemotron-4-340b", 4))


def epilogue_activations(model, params) -> dict:
    """The activation of every pod-GEMM launch of one eager decode step:
    relu2 archs run it in up's epilogue, SiLU archs in gate's."""
    seen: dict[str, int] = {}
    real = sg_ops.systolic_gemm_cuda

    def recording(x, w, scale, bias, *, activation, out_dtype):
        seen[str(activation)] = seen.get(str(activation), 0) + 1
        return real(x, w, scale, bias, activation=activation,
                    out_dtype=out_dtype)
    cache = model.init_cache(1, 16)
    sg_ops.systolic_gemm_cuda = recording
    try:
        model.decode_step(params, torch.zeros(1, dtype=torch.int64,
                                              device="cuda"), cache, 0)
        torch.cuda.synchronize()
    finally:
        sg_ops.systolic_gemm_cuda = real
    return seen


def serve_dense_arch(arch: str, n_layers) -> dict:
    """One dense arch as Model(attention_impl="pallas", use_pallas=True):
    the serve requests through bucketed prefill and graphed decode, its
    launch gates, a second pass's figures, one profiled decode chunk, the
    activations of a step's launches and the oracle at ORACLE_LAYERS."""
    cfg = get_arch(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = Model(cfg, attention_impl="pallas", use_pallas=True)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kw = dict(slots=SLOTS, max_len=MAX_LEN, decode_chunk=DECODE_CHUNK)
    serve(ServeEngine(model, params, **kw),
          [Request(rid=-1, prompt=np.arange(8), max_new_tokens=2)])
    reqs = make_requests(cfg.vocab)
    eng = ServeEngine(model, params, **kw)
    run = counted_serve(eng, reqs)
    st = dict(eng.stats)
    check_served(arch, cfg, reqs)
    L = cfg.n_layers
    gated = cfg.activation == "silu"
    per_forward = (7 if gated else 6) * L + 1
    forwards = st["prefill_calls"] + st["decode_steps"]
    table = run["launches"]
    check(table["pod_gemm"]["launches"] == per_forward * forwards,
          f"{arch}: pod-GEMM launches {table['pod_gemm']['launches']} != "
          f"{per_forward} x {forwards}")
    by = hopper_mainloops(arch)
    D = cfg.resolved_head_dim
    flash_loop = fa.flash_plan(D, torch.bfloat16).mainloop
    check(table["flash"]["launches"] == L * st["prefill_calls"] and
          table["flash"]["by_mainloop"][flash_loop] ==
          table["flash"]["launches"],
          f"{arch}: flash launches {table['flash']} for "
          f"{st['prefill_calls']} prefills of {L} layers, all on "
          f"{flash_loop}")
    check(run["syncs"] == st["prefill_calls"] + st["chunks"],
          f"{arch}: host syncs {run['syncs']} != prefill groups + chunks")
    st0 = dict(eng.stats)
    again = make_requests(cfg.vocab)
    run2 = counted_serve(eng, again)
    second = pass_figures(eng, run2, again, st0)
    check([r.out for r in again] == [r.out for r in reqs],
          f"{arch}: the second pass's tokens differ from the first")
    profile = profile_decode_chunk(eng, cfg.vocab, f"dense_archs-{arch}")
    acts = epilogue_activations(model, params)
    expect = ({"silu": L, "None": 6 * L + 1} if gated
              else {cfg.activation: L, "None": 5 * L + 1})
    check(acts == expect, f"{arch}: epilogue activations {acts} != {expect}")
    cut = cut_oracle(model, params, arch)
    weights = sum(t.nbytes for t in param_tensors(params))
    out = {"arch": arch, "n_layers": L, "of_layers": full_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": D, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "activation": cfg.activation, "rope_theta": cfg.rope_theta,
           "params": model.param_count(), "weight_bytes": weights,
           "init_s": init_s, "first_pass": pass_figures(eng, run, reqs, {}),
           "second_pass": second, "graph_pool_bytes": eng.graph_pool_bytes(),
           "host_syncs": run["syncs"], "pod_gemm_per_forward": per_forward,
           "pod_gemm_by_mainloop": by, "flash_mainloop": flash_loop,
           "flash_by_mainloop": table["flash"]["by_mainloop"],
           "epilogue_activations": acts, "decode_chunk_profile": profile,
           "kernels_per_step": profile["kernels"] / profile["steps"],
           "decode_floor_ms": weights / HBM_BYTES_PER_S * 1e3,
           "oracle_cut": {"n_layers": ORACLE_LAYERS,
                          "token_exact": len(reqs) - len(cut),
                          "first_differences": cut}}
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_dense_archs() -> dict:
    out = {}
    for arch, n_layers in DENSE_ARCHS:
        t0 = time.perf_counter()
        row = serve_dense_arch(arch, n_layers)
        row["wall_s"] = time.perf_counter() - t0
        emit("dense_archs", gpu=gpu_name_and_power(), **row)
        out[arch] = {k: row[k] for k in (
            "n_layers", "pod_gemm_by_mainloop", "flash_by_mainloop",
            "flash_mainloop")}
    return out


# --------------------------------------------------------------------------
# 22. train_flash_vjp, 23. train and 24. launch_train
# --------------------------------------------------------------------------

# B, S, Hq, Hkv, D, Dv, kv_block: yi-6b's heads with the key blocks walked,
# a ragged S, deepseek-v2's MLA widths (q/k 192, v 128, 128 heads)
FLASH_VJP_CASES = [("yi", 2, 1024, 32, 4, 128, 128, 256),
                   ("ragged", 2, 1000, 32, 4, 128, 128, 256),
                   ("mla", 1, 1024, 128, 128, 192, 128, 256)]
# yi-6b at full width, depth cut to 8 of 32 layers: 1.91 G parameters,
# 26.7 GB of params and AdamW state (bf16 params, f32 master, m and v),
# 3.8 GB of bf16 gradients; all 32 layers need ~97 GB with the grads.
# Its attention projections are drawn at fan-in d_model (fan_in_attention)
TRAIN_ARCH, TRAIN_LAYERS = "yi-6b", 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 1024, 12, 6
TRAIN_OPT = dict(lr_peak=3e-4, warmup_steps=3, total_steps=TRAIN_STEPS)


def vjp_grads(q, k, v, w, kv_block: int, planted: bool = False):
    """dq, dk, dv of sum(chunked_attention(q, k, v) * w) through _FlashVJP
    (causal), or with the planted control: the backward without its delta
    term (delta = rowsum(dO O) with O zeroed)."""
    from repro_torch.models import attention as attn
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn.chunked_attention(q, k, v, causal=True, kv_block=kv_block)
    if not planted:
        return torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    L = attn._flash_fwd_pass(q.detach(), k.detach(), v.detach(), True,
                             kv_block, None)[1]
    dout = w.to(out.dtype)
    return attn._flash_bwd_pass(q.detach(), k.detach(), v.detach(),
                                torch.zeros_like(out), L, dout, True,
                                kv_block, None)


def naive_grads(q, k, v, w):
    """The same gradients by autograd through naive_attention in f32 (full
    f32 products, never TF32)."""
    from repro_torch.models.attention import naive_attention
    q, k, v = (t.detach().float().requires_grad_() for t in (q, k, v))
    with no_tf32():
        out = naive_attention(q, k, v, causal=True)
        return torch.autograd.grad((out * w).sum(), (q, k, v))


def phase_train_flash_vjp() -> None:
    """_FlashVJP's gradients on the card against autograd through
    naive_attention in f32, f32 and bf16 inputs, within flash_vjp_f32 and
    flash_vjp_bf16_card; the planted backward without delta must fail both.
    Also the forward-and-backward time beside SDPA's (a yardstick)."""
    from repro_torch.models import attention as attn
    rows = []
    for name, B, S, Hq, Hkv, D, Dv, kv_block in FLASH_VJP_CASES:
        g = torch.Generator("cuda").manual_seed(S + D)
        q = torch.randn((B, S, Hq, D), generator=g, device="cuda")
        k = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
        v = torch.randn((B, S, Hkv, Dv), generator=g, device="cuda")
        w = torch.randn((B, S, Hq, Dv), generator=g, device="cuda")
        for dtype, tol_name in ((torch.float32, "flash_vjp_f32"),
                                (torch.bfloat16, "flash_vjp_bf16_card")):
            tol = TOLERANCES[tol_name]
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            ref = naive_grads(qd, kd, vd, w)
            with no_tf32():
                got = vjp_grads(qd, kd, vd, w, kv_block)
                bad = vjp_grads(qd, kd, vd, w, kv_block, planted=True)
            ex = {n: tol.excess(a.float(), r) for n, a, r in
                  zip("qkv", got, ref)}
            ex_bad = max(tol.excess(a.float(), r) for a, r in
                         zip(bad[:2], ref[:2]))
            row = {"case": name, "shape": [B, S, Hq, Hkv, D, Dv],
                   "kv_block": kv_block, "dtype": str(dtype)[6:],
                   "excess": ex, "planted_excess": ex_bad}
            if name == "yi":
                flush = torch.empty(64 << 20, dtype=torch.int8,
                                    device="cuda")
                qs, ks, vs = (t.detach().requires_grad_()
                              for t in (qd, kd, vd))
                wd = w.to(dtype)

                def fwd_bwd():
                    o = attn.chunked_attention(qs, ks, vs, causal=True,
                                               kv_block=kv_block)
                    torch.autograd.grad(o, (qs, ks, vs), wd)

                def sdpa():
                    o = F.scaled_dot_product_attention(
                        qs.transpose(1, 2), ks.transpose(1, 2),
                        vs.transpose(1, 2), is_causal=True, enable_gqa=True)
                    torch.autograd.grad(o, (qs, ks, vs), wd.transpose(1, 2))
                row["ms"] = time_ms(fwd_bwd, 5, flush)
                row["sdpa_ms"] = time_ms(sdpa, 5, flush)
            rows.append(row)
            emit("train_flash_vjp", **row)
    for row in rows:
        check(max(row["excess"].values()) <= 1.0,
              f"train_flash_vjp {row['case']} {row['dtype']}: gradients off "
              f"the naive f32 autograd: {row['excess']}")
        check(row["planted_excess"] > 4.0,
              f"train_flash_vjp {row['case']} {row['dtype']}: the planted "
              f"backward without delta passes ({row['planted_excess']})")


def train_batch(stream) -> dict:
    return {k: torch.from_numpy(v).to("cuda") for k, v in
            next(stream).items()}


def grads_close(a, b, tol_name: str) -> float:
    """Largest excess of tree a against tree b under TOLERANCES[tol_name]
    (0 where every leaf is equal)."""
    tol = TOLERANCES[tol_name]
    return max(tol.excess(x.float(), y.float()) for x, y in
               zip(train_tree.tree_leaves(a), train_tree.tree_leaves(b)))


def phase_train():
    """yi-6b at full width, 8 of 32 layers, batch 8 x 1024 from the
    synthetic stream, AdamW with warmup, remat on. Gates: (a) every loss
    finite, the mean of the last 3 of 12 below the mean of the first 3;
    (b) a step's loss and gradients with remat off equal to remat on's on
    the same batch; (c) microbatches=4 against 1 within the reference's
    own test's bounds; (d) a checkpoint saved at step 6, restored into
    fresh state, gives steps 7-9's losses again. Reports step ms, tokens/s,
    achieved TFLOP/s against the bf16 floor, and peak memory with remat on
    and off."""
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    freed = torch.cuda.memory_allocated()
    model = Model(cfg, remat=True)
    params = fan_in_attention(model.init(
        torch.Generator("cuda").manual_seed(0)))
    opt = init_adamw(params)
    torch.cuda.synchronize()
    n_params = model.param_count()
    emit("init", arch=cfg.name, n_layers=TRAIN_LAYERS,
         of_layers=get_arch(TRAIN_ARCH).n_layers, params=n_params,
         seconds=time.perf_counter() - t0,
         gib_allocated_before=freed / 2 ** 30,
         gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
    tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
    step_fn = make_train_step(model, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    stream = batches(dcfg)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="train_ckpt_",
                                     dir=_build.REPO_ROOT / "build"))
    losses, times = [], []
    ckpt = {"disk_free_gb": shutil.disk_usage(ckpt_dir).free / 1e9}
    torch.cuda.reset_peak_memory_stats()
    try:
        for step in range(TRAIN_STEPS):
            batch = train_batch(stream)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            if step + 1 == TRAIN_SAVE_AT:
                t = time.perf_counter()
                save_checkpoint(str(ckpt_dir), step + 1, (params, opt))
                ckpt["save_s"] = time.perf_counter() - t
                ckpt["bytes"] = sum(f.stat().st_size for f in
                                    ckpt_dir.rglob("*") if f.is_file())
        peak_step = torch.cuda.max_memory_allocated()
        # the optimizer's share of a step, on the last batch's gradients
        grads = grads_fn(model, tcfg)(params, batch)[1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        adamw_update(tcfg.optimizer, opt, grads)
        torch.cuda.synchronize()
        adamw_s = time.perf_counter() - t
        del grads

        # (b) remat off against remat on, one step's loss and gradients;
        # each call's peak above what was allocated before it
        batch = train_batch(batches(dcfg, start_step=TRAIN_STEPS))
        peaks = {}

        def grads_peak(remat: bool):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = grads_fn(Model(cfg, remat=remat), tcfg)(params, batch)
            torch.cuda.synchronize()
            peaks[remat] = (torch.cuda.max_memory_allocated(),
                            torch.cuda.max_memory_allocated() - before)
            return out
        loss_on, g_on = grads_peak(True)
        loss_off, g_off = grads_peak(False)
        remat_equal = bool(torch.equal(loss_on, loss_off)) and all(
            torch.equal(a, b) for a, b in zip(
                train_tree.tree_leaves(g_on), train_tree.tree_leaves(g_off)))
        remat_excess = grads_close(g_off, g_on, "train_remat_card")
        del g_off
        # (c) microbatches=4 against 1 on the same batch
        loss_mb, g_mb = grads_fn(model, TrainConfig(
            microbatches=4, optimizer=tcfg.optimizer))(params, batch)
        mb_loss_diff = abs(float(loss_mb) - float(loss_on))
        mb_grad_diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(train_tree.tree_leaves(g_mb),
                                           train_tree.tree_leaves(g_on)))
        del g_mb, g_on
        # (d) restore step 6 into fresh state and take steps 7-9 again
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        like_p = model_like(model)
        like = (like_p, init_adamw_like(like_p))
        t = time.perf_counter()
        (params, opt), at = restore_checkpoint(str(ckpt_dir), like)
        torch.cuda.synchronize()
        ckpt["restore_s"] = time.perf_counter() - t
        resumed = batches(dcfg, start_step=at)
        again = []
        for _ in range(3):
            params, opt, m = step_fn(params, opt, train_batch(resumed))
            again.append(float(m["loss"]))
        del params, opt
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    layer_params = n_params - cfg.vocab * cfg.d_model * 2   # tok, unembed
    flops = 6 * n_params * tokens + 2 * layer_params * tokens
    step_s = sum(times[3:]) / len(times[3:])
    row = {"arch": cfg.name, "n_layers": TRAIN_LAYERS,
           "of_layers": get_arch(TRAIN_ARCH).n_layers, "params": n_params,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "losses": losses,
           "step_ms": step_s * 1e3,
           "step_ms_each": [x * 1e3 for x in times],
           "adamw_ms": adamw_s * 1e3, "tokens_per_s": tokens / step_s,
           "flop_per_step": flops, "tflop_per_s": flops / step_s / 1e12,
           "floor_ms": flops / BF16_FLOP_PER_S * 1e3,
           "gib_peak_step": peak_step / 2 ** 30,
           "gib_peak_grads_remat_on": peaks[True][0] / 2 ** 30,
           "gib_peak_grads_remat_off": peaks[False][0] / 2 ** 30,
           "gib_above_state_remat_on": peaks[True][1] / 2 ** 30,
           "gib_above_state_remat_off": peaks[False][1] / 2 ** 30,
           "remat_equal": remat_equal, "remat_excess": remat_excess,
           "microbatch_loss_diff": mb_loss_diff,
           "microbatch_grad_max_diff": mb_grad_diff,
           "checkpoint": {**ckpt, "losses_7_9": losses[6:9],
                          "resumed_7_9": again},
           "gpu": gpu_name_and_power()}
    emit("train", **row)
    check(all(math.isfinite(x) for x in losses),
          f"train: a loss is not finite {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]),
          f"train: the loss did not fall over {TRAIN_STEPS} steps {losses}")
    check(remat_excess <= 1.0,
          f"train: remat off differs from remat on ({remat_excess} under "
          f"train_remat_card)")
    check(mb_loss_diff <= TOLERANCES["microbatch_loss"].atol and
          mb_grad_diff <= TOLERANCES["microbatch_grads"].atol,
          f"train: microbatches=4 off 1 by {mb_loss_diff} (loss), "
          f"{mb_grad_diff} (grads)")
    check(TOLERANCES["train_resume_card"].ok(torch.tensor(again),
                                             torch.tensor(losses[6:9])),
          f"train: resumed losses {again} against {losses[6:9]}")
    return row


def fan_in_attention(params):
    """The attention projections redrawn at fan-in d_model, in place: q, k
    and v [L, d, H, hd] times sqrt(H / d), o [L, H, hd, d] times
    sqrt(1 / H). The init of both packages takes the fan-in of q, k and v
    over the head axis (32 and 4 at yi-6b, not 4096), which makes scores
    ~128 wide at full width; the backward then grows ~10**2.5 a layer
    (max |dq| 2.5, 120 and 6e5 at 1, 2 and 4 layers on the CPU), the
    global norm's f32 sum of squares overflows at 8 layers, the clip scale
    is 0 and no step moves a weight."""
    for node in (params[k] for k in params if k not in ("embed", "ln_f")):
        a = node["attn"]
        for n in ("q", "k", "v"):
            a[n].mul_(math.sqrt(a[n].shape[-2] / a[n].shape[-3]))
        a["o"].mul_(math.sqrt(1 / a["o"].shape[-3]))
    return params


def model_like(model):
    """The model's parameter tree as zero-stride views of one element each
    (shapes, dtypes and the device without the memory)."""
    return train_tree.tree_map(lambda sch: torch.empty(
        (), dtype=sch.dtype, device="cuda").expand(sch.shape), model.schema())


def init_adamw_like(params_like):
    """An AdamWState of `params_like`'s structure, as zero-stride views."""
    def f32():
        return train_tree.tree_map(lambda p: torch.empty(
            (), dtype=torch.float32, device="cuda").expand(p.shape),
            params_like)
    return AdamWState(torch.zeros((), dtype=torch.int32, device="cuda"),
                      f32(), f32(), f32())


def launch_train_run(argv) -> tuple[int, list[str]]:
    """repro_torch.launch.train in-process: (exit code, its step lines)."""
    from repro_torch.launch import train as launch
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            launch.main(argv)
        except SystemExit as e:
            code = e.code
    lines = out.getvalue().splitlines()
    return code, lines


def phase_launch_train() -> None:
    """The launcher on the card at reduced yi-6b: --kill-at 7 exits 42 after
    a checkpoint at step 5, --resume continues from it to step 12 and
    exits 0, and its steps print the losses, grad norms and learning
    rates of a run that was not killed."""
    root = Path(tempfile.mkdtemp(prefix="launch_train_",
                                 dir=_build.REPO_ROOT / "build"))
    base = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "12", "--seq",
            "128", "--ckpt-every", "5"]
    t0 = time.perf_counter()
    try:
        killed = launch_train_run(base + ["--ckpt-dir", str(root / "a"),
                                          "--kill-at", "7"])
        resumed = launch_train_run(base + ["--ckpt-dir", str(root / "a"),
                                           "--resume"])
        whole = launch_train_run(base + ["--ckpt-dir", str(root / "b")])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def steps(lines):
        # "step    5 loss=... gnorm=... lr=... (0.01s/it)" without the time
        return {ln.split()[1]: ln.rsplit(" (", 1)[0] for ln in lines
                if ln.startswith("step ")}
    emit("launch_train", wall_s=time.perf_counter() - t0,
         exit_codes=[killed[0], resumed[0], whole[0]],
         resumed=[ln for ln in resumed[1] if ln.startswith(("resumed",
                                                             "step"))],
         whole=[ln for ln in whole[1] if ln.startswith("step")])
    check(killed[0] == 42 and resumed[0] in (0, None) and
          whole[0] in (0, None),
          f"launch_train: exit codes {killed[0]}, {resumed[0]}, {whole[0]}")
    check("resumed from step 5" in resumed[1],
          f"launch_train: did not resume from step 5 {resumed[1]}")
    r, w = steps(resumed[1]), steps(whole[1])
    check(set(r) == {"5", "10", "11"} and all(r[s] == w[s] for s in r),
          f"launch_train: resumed {r} against {w}")


# --------------------------------------------------------------------------
# 25. parallel
# --------------------------------------------------------------------------

REDUCERS = ("psum", "butterfly", "butterfly2", "ring", "compressed")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def timed_ms(fn, *args):
    """(fn(*args), wall ms between two device syncs)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def compressed_gates(flat: torch.Tensor, group) -> dict:
    """compressed_psum on one rank: reduced + new_error against the input
    (at most one f32 ulp of it apart) and the largest error of `reduced`
    over its 256-block's maximum, chunk by chunk (6.6 GB in f32 at yi-6b's
    8 layers)."""
    red, err = compressed_psum(flat, group)
    ulps, block_rel = 0.0, 0.0
    step = BLOCK * (1 << 20)
    for i in range(0, flat.numel(), step):
        x, r, e = flat[i:i + step], red[i:i + step], err[i:i + step]
        ulp = torch.nextafter(x.abs(), torch.full_like(x, math.inf)) - \
            x.abs()
        ulps = max(ulps, float(((r + e - x).abs() / ulp).max()))
        pad = (-x.numel()) % BLOCK
        xb = F.pad(x, (0, pad)).view(-1, BLOCK)
        rb = F.pad(r, (0, pad)).view(-1, BLOCK)
        bmax = xb.abs().amax(dim=1)
        rel = (rb - xb).abs().amax(dim=1) / bmax
        block_rel = max(block_rel, float(rel[bmax > 0].max()))
    return {"ulps_of_input": ulps, "max_block_rel_err": block_rel,
            "error": err}


def phase_parallel() -> None:
    """The sharded step and the gradient reducers on one card (NCCL, one
    rank): see the module docstring's phase 25."""
    t0 = time.perf_counter()
    gpu = gpu_name_and_power()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl",
              f"parallel: backend {dist.get_backend()}, not nccl")
        mesh = make_host_mesh(model=1)
        check(mesh.device_type == "cuda", f"parallel: mesh on "
              f"{mesh.device_type}")
        cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                                  n_layers=TRAIN_LAYERS)
        model = Model(cfg, remat=True)
        params = fan_in_attention(model.init(
            torch.Generator("cuda").manual_seed(0)))
        tcfg = TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT))
        batch = train_batch(batches(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)))
        dparams = train_tree.tree_map(
            lambda p, s: DTensor.from_local(
                p, mesh, placements(pspec_for_axes(s.axes, s.shape, mesh),
                                    mesh), shape=p.shape, stride=p.stride()),
            params, model.schema())
        no_copy = all(
            d.to_local().data_ptr() == p.data_ptr() for d, p in zip(
                train_tree.tree_leaves(dparams),
                train_tree.tree_leaves(params)))
        dbatch = {k: DTensor.from_local(v, mesh, batch_sharding(mesh, v.ndim))
                  for k, v in batch.items()}
        smodel = Model(cfg, remat=True,
                       constrain=make_constrain(mesh, cfg.vocab))
        plain_fn = grads_fn(model, tcfg)
        dt_fn = sharded_step(grads_fn(smodel, tcfg))
        (loss_p, g_p), plain_first = timed_ms(plain_fn, params, batch)
        (loss_d, g_d), dt_first = timed_ms(dt_fn, dparams, dbatch)
        loss_equal = bool(torch.equal(loss_p, loss_d.full_tensor()))
        unequal = [k for (k, a), (_, b) in zip(
            train_tree.leaves_with_paths(g_p),
            train_tree.leaves_with_paths(g_d))
            if not torch.equal(a, b.full_tensor())]
        placements_seen = sorted({str(g.placements) for g in
                                  train_tree.tree_leaves(g_d)})
        del g_p, g_d
        _, plain_ms = timed_ms(plain_fn, params, batch)
        (loss_d, g_d), dt_ms = timed_ms(dt_fn, dparams, dbatch)
        vocab_parallel = vocab_parallel_check(model, params, batch,
                                              mesh.get_group("model"))
        del params, dparams
        gc.collect()
        torch.cuda.empty_cache()

        # the DTensor gradients' pending sum over data, by each reducer
        group = mesh.get_group("data")
        local = [g.to_local() for g in train_tree.tree_leaves(g_d)
                 if pending(g, "data")]
        flat = torch.cat([t.reshape(-1).float() for t in local])
        flat_bytes = flat.numel() * flat.element_size()
        gates = compressed_gates(flat, group)
        del flat
        torch.cuda.empty_cache()
        reducers = {}
        for impl in REDUCERS:
            sync = make_grad_sync(mesh, "data", impl)
            sync(g_d)                                  # warm
            (red, err), ms = timed_ms(sync, g_d)
            row = {"ms": ms, "gb_per_s": flat_bytes / ms / 1e6,
                   "placements": sorted({str(g.placements) for g in
                                         train_tree.tree_leaves(red)})}
            out = [g.to_local() for g in train_tree.tree_leaves(red)]
            inp = [g.to_local() for g in train_tree.tree_leaves(g_d)]
            if impl == "compressed":
                row["error_equal"] = bool(torch.equal(err, gates["error"]))
            else:
                row["bit_equal"] = all(torch.equal(a, b)
                                       for a, b in zip(out, inp))
            row["none_partial_over_data"] = not any(
                pending(g, "data") for g in train_tree.tree_leaves(red))
            reducers[impl] = row
            del red, err, out, inp
            torch.cuda.empty_cache()
        del gates["error"]
        row = {"nccl": ".".join(map(str, torch.cuda.nccl.version())),
               "backend": dist.get_backend(), "world_size":
               dist.get_world_size(), "mesh": mesh_shape_dict(mesh),
               "arch": cfg.name, "n_layers": TRAIN_LAYERS,
               "batch": [TRAIN_BATCH, TRAIN_SEQ], "no_copy": no_copy,
               "loss": float(loss_p), "loss_equal": loss_equal,
               "grads_unequal": unequal,
               "grad_placements": placements_seen,
               "plain_ms_first": plain_first, "dtensor_ms_first": dt_first,
               "plain_ms": plain_ms, "dtensor_ms": dt_ms,
               "dispatch_ms": dt_ms - plain_ms,
               "pending_leaves": len(local),
               "leaves": len(train_tree.tree_leaves(g_d)),
               "flat_bytes": flat_bytes, "reducers": reducers,
               "compressed": gates, "vocab_parallel": vocab_parallel,
               "gpu": gpu}
        del g_d, local
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    emit("parallel", **row)
    check(row["no_copy"], "parallel: from_local copied a parameter")
    check(loss_equal and not unequal,
          f"parallel: the DTensor step differs from the plain one (loss "
          f"equal {loss_equal}; leaves {unequal})")
    check(row["pending_leaves"] > 0, "parallel: no gradient is pending "
          "over data")
    for impl, r in reducers.items():
        check(r["none_partial_over_data"],
              f"parallel: {impl} left a sum over data pending")
        check(r.get("bit_equal", r.get("error_equal")),
              f"parallel: {impl} at one rank changed the gradients {r}")
    check(gates["ulps_of_input"] <= 1.0 and
          gates["max_block_rel_err"] < 0.05,
          f"parallel: compressed_psum {gates}")
    check(vocab_parallel["loss_excess"] <= 1.0 and
          vocab_parallel["grad_max_rel"] <=
          TOLERANCES["sharded_grads_f32"].atol,
          f"parallel: the vocabulary-parallel loss differs from the plain "
          f"one {vocab_parallel}")


def vocab_parallel_check(model, params, batch, group) -> dict:
    """The vocabulary-parallel sums over the one-rank `group` against the
    plain loss on the same bf16 logits of `batch` (see the module
    docstring's phase 25): each path's loss and gradient with respect to
    the logits, timed and its peak above the logits read on the second
    of two calls."""
    with torch.no_grad():
        logits = model.forward(params, batch)[0]
    labels = batch["labels"]

    def plain(x):
        return cross_entropy_loss(x, labels)

    def split(x):
        total, count = layers_mod._VocabParallelSums.apply(
            x, labels, -1, 0, [group])
        return total / torch.clamp_min(count, 1.0)

    out: dict = {"logits": list(logits.shape),
                 "dtype": str(logits.dtype).replace("torch.", "")}
    res = {}
    for name, fn in (("plain", plain), ("vocab_parallel", split)):
        x = logits.detach().requires_grad_()

        def run():
            loss = fn(x)
            return loss.detach(), torch.autograd.grad(loss, x)[0]
        run()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res[name], ms = timed_ms(run)
        out[name] = {"ms": ms, "gib_above_logits":
                     (torch.cuda.max_memory_allocated() - before) / 2 ** 30}
        del x
    (lp, gp), (lv, gv) = res["plain"], res["vocab_parallel"]
    out.update(loss=float(lp), loss_bit_equal=bool(torch.equal(lp, lv)),
               grad_bit_equal=bool(torch.equal(gp, gv)),
               loss_excess=TOLERANCES["sharded_loss_f32"].excess(lv, lp),
               grad_max_rel=float((gv.float() - gp.float()).abs().max()
                                  / gp.float().abs().max()))
    del logits, res, gp, gv
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 26. dryrun
# --------------------------------------------------------------------------

DRYRUN_SHAPE = "train_chip"          # phase 23's batch as a ShapeConfig
DRYRUN_PEAK_TOL = 0.15               # predicted peak against measured
DRYRUN_FLOP_RATIO = (1.00, 1.10)     # traced FLOPs over the analytic count
# (arch, shape, multi-pod): the reference's slow-test cell, and the pod
# mesh's yi-6b train_4k (the vocabulary-parallel loss and the split query
# heads at 256 ranks)
DRYRUN_CELLS = (("granite-8b", "decode_32k", True),
                ("yi-6b", "train_4k", False))
DRYRUN_CHILD_TIMEOUT = 600


def dryrun_children() -> list[subprocess.Popen]:
    """The DRYRUN_CELLS through the port's CLI, each started in a child
    process of its own (they run beside phases 22-25 and (a); main kills
    them if a phase fails)."""
    env = dict(os.environ, PYTHONPATH=str(_build.REPO_ROOT / "src"))
    children = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        child = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape] + (["--multi-pod"] if multi_pod
                                        else []),
            cwd=_build.REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        child.cell = (arch, shape, multi_pod)
        child.started = time.perf_counter()
        children.append(child)
    return children


def dryrun_cell(child: subprocess.Popen) -> dict:
    """A CLI cell's outcome: its exit code, [OK ] line, seconds and
    report's figures."""
    stdout, stderr = child.communicate(timeout=DRYRUN_CHILD_TIMEOUT)
    arch, shape, multi_pod = child.cell
    mesh = "multipod_2x16x16" if multi_pod else "pod_16x16"
    report = Path(dryrun.REPORT_DIR) / mesh / f"{arch}__{shape}.json"
    cell = json.loads(report.read_text()) if report.exists() else {}
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "rc": child.returncode, "seconds":
                time.perf_counter() - child.started,
            "line": [ln for ln in stdout.splitlines()
                     if ln.startswith("[OK ]")],
            "tail": f"{stdout[-2000:]} {stderr[-3000:]}",
            **{k: cell.get(k) for k in (
                "status", "error", "chips", "compute_s", "memory_s",
                "collective_s", "hbm_gb_per_chip", "hbm_fit", "bottleneck",
                "argument_size_in_bytes", "temp_size_in_bytes",
                "flops_per_device", "model_flops_ratio", "compile_s")}}


def dryrun_traces(cfg) -> dict:
    """Phase (a): phase 23's step traced on a one-rank fake group."""
    SHAPES[DRYRUN_SHAPE] = ShapeConfig(DRYRUN_SHAPE, TRAIN_SEQ, TRAIN_BATCH,
                                       "train")
    out = {}
    try:
        with dryrun.fake_world(1):
            mesh = make_host_mesh(model=1)
            check(mesh.device_type == "cuda",
                  f"dryrun: mesh on {mesh.device_type}")
            for label, kw in (
                    ("step", {}),
                    ("grads_remat_on", dict(include_optimizer=False)),
                    ("grads_remat_off", dict(include_optimizer=False,
                                             opts={"remat": False}))):
                t = time.perf_counter()
                r = dryrun._trace_cell(TRAIN_ARCH, DRYRUN_SHAPE, mesh,
                                       memory=True, cfg_override=cfg, **kw)
                c = r["counter"]
                out[label] = {
                    "gib_arguments": r["argument_size_in_bytes"] / 2 ** 30,
                    "gib_above_arguments": r["temp_size_in_bytes"] / 2 ** 30,
                    "gib_peak": (r["argument_size_in_bytes"] +
                                 r["temp_size_in_bytes"]) / 2 ** 30,
                    "flops": c.flops, "bytes": c.bytes,
                    "collective_bytes": c.collective_total,
                    "seconds": time.perf_counter() - t}
    finally:
        del SHAPES[DRYRUN_SHAPE]
    return out


def phase_dryrun(train: dict, children: list[subprocess.Popen]) -> None:
    """The dry-run against the card: see the module docstring's phase
    26. `train` is phase 23's row, measured in this run; `children` the
    CLI cells of dryrun_children, started before phase 22 so that their
    traces (CPU processes of their own) overlap phases 22-25."""
    t0 = time.perf_counter()
    gpu = gpu_name_and_power()
    total = torch.cuda.get_device_properties(0).total_memory
    check(not dist.is_initialized(), "dryrun: a process group is open")
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    traces = dryrun_traces(cfg)
    cells = [dryrun_cell(c) for c in children]
    check(not dist.is_initialized(), "dryrun: the fake group was left open")
    for c in cells:
        print(f"dryrun cell {c['arch']} {c['shape']} {c['mesh']}: "
              f"{c['status']}, {c['hbm_gb_per_chip']} GB a chip "
              f"(total_memory {total / 2 ** 30:.2f} GiB), "
              f"{c['seconds']:.1f} s; {gpu}", flush=True)

    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the analytic count without the two terms no op performs: the token
    # table's lookup priced as a product, and each layer's last product,
    # which checkpoint's early stop does not recompute
    lookup = 6 * cfg.vocab * cfg.d_model * tokens
    last = 2 * cfg.d_model * cfg.d_ff * cfg.n_layers * tokens
    performed = train["flop_per_step"] - lookup - last
    step_flops = traces["step"]["flops"]
    measured = {"step": train["gib_peak_step"],
                "grads_remat_on": train["gib_above_state_remat_on"],
                "grads_remat_off": train["gib_above_state_remat_off"]}
    predicted = {"step": traces["step"]["gib_peak"],
                 "grads_remat_on": traces["grads_remat_on"][
                     "gib_above_arguments"],
                 "grads_remat_off": traces["grads_remat_off"][
                     "gib_above_arguments"]}
    row = {"hbm_per_chip": HBM_PER_CHIP, "total_memory": total,
           "arch": cfg.name, "n_layers": TRAIN_LAYERS,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "traces": traces,
           "gib_predicted": predicted, "gib_measured": measured,
           "peak_rel_err": {k: predicted[k] / measured[k] - 1
                            for k in measured},
           "flops_traced": step_flops,
           "flop_per_step_analytic": train["flop_per_step"],
           "ratio_to_analytic": step_flops / train["flop_per_step"],
           "flop_per_step_performed": performed,
           "ratio_to_performed": step_flops / performed,
           "step_ms_measured": train["step_ms"],
           "roofline_fraction_measured":
               step_flops / (train["step_ms"] / 1e3) / BF16_FLOP_PER_S,
           "bound_ms_traced": step_flops / BF16_FLOP_PER_S * 1e3,
           "cells": [{k: v for k, v in c.items() if k != "tail"}
                     for c in cells],
           "gpu": gpu}
    row["seconds"] = time.perf_counter() - t0
    emit("dryrun", **row)
    check(HBM_PER_CHIP == total,
          f"dryrun: HBM_PER_CHIP {HBM_PER_CHIP} is not the card's "
          f"total_memory {total}")
    for k, err in row["peak_rel_err"].items():
        check(abs(err) <= DRYRUN_PEAK_TOL,
              f"dryrun: predicted {k} {predicted[k]:.3f} GiB against "
              f"measured {measured[k]:.3f} ({err:+.1%})")
    lo, hi = DRYRUN_FLOP_RATIO
    check(lo <= row["ratio_to_performed"] <= hi,
          f"dryrun: traced FLOPs {step_flops:.4g} are "
          f"{row['ratio_to_performed']:.4f} of the performed analytic count "
          f"{performed:.4g}")
    for c in cells:
        name = f"{c['arch']} {c['shape']} {c['mesh']}"
        check(c["rc"] == 0 and c["line"],
              f"dryrun: the CLI cell {name} failed (rc {c['rc']}): "
              f"{c['tail']}")
        check(c["status"] == "ok" and c["chips"] ==
              (512 if c["mesh"] == "multipod_2x16x16" else 256) and
              (c["compute_s"] or 0) > 0 and
              (c["collective_s"] if c["collective_s"] is not None
               else -1) >= 0,
              f"dryrun: the CLI cell {name}: {c}")
        if c["arch"] == "yi-6b":
            check(c["argument_size_in_bytes"] + c["temp_size_in_bytes"]
                  <= total and c["hbm_fit"],
                  f"dryrun: {name} does not fit the card's {total} bytes: "
                  f"{c['hbm_gb_per_chip']} GiB a chip")


# --------------------------------------------------------------------------
# 27. kernels line
# --------------------------------------------------------------------------

def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of fn over iters launches, each after an L2 flush
    (weights are cold in the served model: 16.5 GB pass through per step)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the HBM rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def forward_gemms(cfg) -> dict:
    """The pod GEMMs of one cfg layer and the head, name -> (K, N,
    activation): q, k, v, o, a SiLU arch's gate and up, down, the head. A
    MoE config's FFNs are the grouped kernel's, so it has none here."""
    d = cfg.d_model
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    q = cfg.n_heads * cfg.resolved_head_dim
    shapes = {"q": (d, q, None), "k": (d, kv, None), "v": (d, kv, None),
              "o": (q, d, None)}
    if cfg.moe is None:
        shapes.update(gate=(d, cfg.d_ff, "silu"), up=(d, cfg.d_ff, None),
                      down=(cfg.d_ff, d, None))
    shapes["head"] = (d, cfg.vocab, None)
    return shapes


def mla_forward_gemms(cfg) -> tuple[dict, dict]:
    """deepseek-v2's pod GEMMs of one forward, name -> (K, N, activation),
    and each one's launches a forward: the first dense layers' gate, up
    and down, every MoE layer's shared experts (gate, up, down), the
    untied head. MLA's projections are einsums, as in the reference."""
    d, L = cfg.d_model, cfg.n_layers
    fd = cfg.moe.first_dense_layers
    fs = cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
    shapes = {"dense_gate": (d, cfg.d_ff, "silu"),
              "dense_up": (d, cfg.d_ff, None),
              "dense_down": (cfg.d_ff, d, None),
              "shared_gate": (d, fs, "silu"), "shared_up": (d, fs, None),
              "shared_down": (fs, d, None), "head": (d, cfg.vocab, None)}
    counts = {name: (1 if name == "head" else
                     fd if name.startswith("dense") else L - fd)
              for name in shapes}
    return shapes, counts


def pod_gemm_rows(cfg, phases, seed: int, gemms=None):
    """The pod GEMMs of one cfg forward (bf16, bf16 out) at each (phase, M,
    iters): per-shape rows, and per phase the sums over one forward (each
    projection once per layer, the head once; or `gemms`: the shapes and
    their launches a forward, as mla_forward_gemms gives them)."""
    if gemms is None:
        shapes = forward_gemms(cfg)
        counts = {name: 1 if name == "head" else cfg.n_layers
                  for name in shapes}
    else:
        shapes, counts = gemms
    g = torch.Generator("cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    totals = {ph: dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"),
                                0.0) for ph, _, _ in phases}
    for phase, M, iters in phases:
        for name, (K, N, act) in shapes.items():
            x, w = gemm_inputs(M, K, N, torch.bfloat16, g)
            got = sg.systolic_gemm_cuda(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
            ref = systolic_gemm_ref(x, w, activation=act,
                                    out_dtype=torch.bfloat16)
            err = float((got.double() - ref.double()).abs().max())
            check(TOLERANCES["gemm_bf16out"].ok(got, ref),
                  f"{cfg.name} {phase} {name}: kernel disagrees "
                  f"(max_abs_err {err})")
            worst = max(worst, err)
            del got, ref

            def library(x=x, w=w, act=act):
                return torch_activation(torch.matmul(x, w), act)
            row = {
                "gemm": name, "phase": phase, "M": M, "K": K, "N": N,
                "plan": list(sg.nn_plan(M, N, K, torch.bfloat16, True)),
                "ms": time_ms(lambda: sg.systolic_gemm_cuda(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "plain_ms": time_ms(lambda: systolic_gemm_ref(
                    x, w, activation=act, out_dtype=torch.bfloat16),
                    iters, flush),
                "library_ms": time_ms(library, iters, flush),
                "max_abs_err": err,
            }
            row["bound_ms"], row["bound_by"] = bound(
                2 * M * N * K, 2 * (M * K + K * N + M * N))
            rows.append(row)
            for key in totals[phase]:
                totals[phase][key] += counts[name] * row[key]
            del x, w
    return rows, totals, worst, sum(counts.values())


def gemm_line(cfg, launches: int, by_mainloop: dict, moe_cfg,
              moe_launches: int, moe_by_mainloop: dict, hybrid_cfg,
              hybrid_table: dict, guard: dict, dense: dict,
              dense_served: dict, mla_cfg, mla_launches: dict,
              audio_cfg, audio_launches: dict, vlm_cfg,
              vlm_launches: dict) -> dict:
    """granite-8b's pod GEMMs at decode (M = SLOTS) and a [SLOTS, 256]
    prefill, the line's own numbers; dbrx-132b's q/k/v/o and untied head
    at decode and at its longest exact-length prefill (M = 1277) under
    "moe"; hymba-1.5b's seven projections and untied head at decode and
    at a [SLOTS, 2048] prefill (M = 8192) under "hybrid", the head
    (N = 32001) on wmma; granite's GEMMs under the SDC guard (phase
    guard: a forward's ms under off, probe and abft, the launches by
    mainloop of a forward and of the guarded served runs) under "guard";
    minitron-8b's and nemotron-4-340b's shapes (phase kernel) and the
    dense archs' served launches by mainloop under "dense_archs";
    deepseek-v2's 25 of a forward (the dense layer's MLP, the shared
    experts, the head; mla_forward_gemms) at decode and at its longest
    exact-length prefill (M = 1277) under "deepseek"; whisper-small's
    (phase kernel: the encoder's at M = 1500, the decoder's at decode, the
    51865-wide head at M = 4 and 64; an encoder pass and a decode step
    summed over 12 layers) with its served launches under "whisper";
    llama-3.2-vision-90b's (phase kernel: q, k, o, gate, down and the
    128256-row head at decode, up at M = 600; a decode step summed over
    the 30-layer cut's 24 dense and 6 cross layers) with its served
    launches under "vlm". Launches by mainloop are the served runs'."""
    rows, totals, worst, per_fwd = pod_gemm_rows(
        cfg, (("decode", SLOTS, 20), ("prefill", SLOTS * 256, 5)), seed=2)
    moe_rows, moe_totals, moe_worst, moe_per_fwd = pod_gemm_rows(
        moe_cfg, (("decode", SLOTS, 20), ("prefill", 1277, 3)), seed=13)
    h_rows, h_totals, h_worst, h_per_fwd = pod_gemm_rows(
        hybrid_cfg, (("decode", SLOTS, 20), ("prefill", SLOTS * 2048, 3)),
        seed=17)
    ds_rows, ds_totals, ds_worst, ds_per_fwd = pod_gemm_rows(
        mla_cfg, (("decode", SLOTS, 20), ("prefill", 1277, 3)), seed=29,
        gemms=mla_forward_gemms(mla_cfg))
    head = [r for r in h_rows if r["gemm"] == "head"]
    check(all(r["plan"][0] == "wmma" for r in head),
          f"hymba's head ran {[r['plan'] for r in head]}, not wmma")
    dec = totals["decode"]
    return {
        "name": "systolic_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:121",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": max(worst, moe_worst, h_worst, ds_worst,
                           *(r["max_abs_err"]
                             for r in dense["whisper"]["rows"]
                             + dense["vlm"]["rows"])),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": "bytes",
        "library_ms": dec["library_ms"],
        "ms_are": (f"sums over the {per_fwd} pod GEMMs of one {cfg.name} "
                   f"decode step at M={SLOTS} (per-shape rows below, L2 "
                   f"flushed); launches are its dense serve run's"),
        "prefill_forward": totals["prefill"],
        "shapes": rows,
        "moe": {"arch": moe_cfg.name, "n_layers": moe_cfg.n_layers,
                "launches": moe_launches,
                "launches_by_mainloop": moe_by_mainloop,
                "per_forward": moe_per_fwd,
                "decode_forward": moe_totals["decode"],
                "prefill_forward_1277": moe_totals["prefill"],
                "shapes": moe_rows},
        "hybrid": {"arch": hybrid_cfg.name, "n_layers": hybrid_cfg.n_layers,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "per_forward": h_per_fwd,
                   "decode_forward": h_totals["decode"],
                   "prefill_forward_8192": h_totals["prefill"],
                   "head": head, "shapes": h_rows},
        "guard": {"arch": cfg.name, "per_forward": guard["per_forward"],
                  "forward_ms": guard["forward_ms"],
                  "launches_by_mainloop_per_forward": guard["by_mainloop"],
                  "served_abft_by_mainloop": guard["served_abft_by_mainloop"],
                  "served_probe_by_mainloop":
                      guard["served_probe_by_mainloop"]},
        "deepseek": {"arch": mla_cfg.name, "n_layers": mla_cfg.n_layers,
                     "launches": mla_launches["pod_gemm"],
                     "launches_by_mainloop":
                         mla_launches["pod_gemm_by_mainloop"],
                     "per_forward": ds_per_fwd,
                     "decode_forward": ds_totals["decode"],
                     "prefill_forward_1277": ds_totals["prefill"],
                     "shapes": ds_rows},
        "dense_archs": {"shapes": dense["rows"],
                        "nemotron_decode_step": dense["nemotron_decode_step"],
                        "served": {a: {"n_layers": d["n_layers"],
                                       "launches_by_mainloop":
                                           d["pod_gemm_by_mainloop"]}
                                   for a, d in dense_served.items()}},
        "whisper": {"arch": audio_cfg.name, "n_layers": audio_cfg.n_layers,
                    "n_encoder_layers": audio_cfg.n_encoder_layers,
                    "launches": audio_launches["pod_gemm"],
                    "launches_by_mainloop":
                        audio_launches["pod_gemm_by_mainloop"],
                    "per_encoder_pass": len(AUDIO_GEMMS_PER_LAYER)
                    * audio_cfg.n_encoder_layers,
                    "per_decoder_forward": len(AUDIO_GEMMS_PER_LAYER)
                    * audio_cfg.n_layers + 1,
                    **dense["whisper"]},
        "vlm": {"arch": vlm_cfg.name, "n_layers": vlm_cfg.n_layers,
                "launches": vlm_launches["pod_gemm"],
                "launches_by_mainloop": vlm_launches["pod_gemm_by_mainloop"],
                **dense["vlm"]},
    }


FLASH_SEQS = (256, 2048)     # granite-8b prefill buckets, B = SLOTS


def flash_row(B, S, Hq, Hkv, D, iters: int, g, flush,
              window: int | None = None, causal: bool = True) -> dict:
    """One bf16 launch [B, S, Hq over Hkv, D], causal (over the last
    `window` keys, if given) or not, on randn inputs: checked against the
    naive and tiled plain versions, then timed beside both and SDPA (with
    the window as a boolean mask: whichever backend PyTorch picks for
    it), with its plan and its rate."""
    q, k, v = (torch.randn((B, S, h, D), generator=g,
                           device="cuda").to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    plan = fa.flash_plan(D, q.dtype)
    mask = dict(causal=causal, window=window)
    got = fa.flash_attention_cuda(q, k, v, **mask)
    ref = flash_attention_ref(q, k, v, **mask)
    tiled = flash_attention_tiled_ref(q, k, v, block_k=plan.block_k, **mask)
    err = float((got.double() - ref.double()).abs().max())
    check(TOLERANCES["flash_bf16"].ok(got, ref)
          and TOLERANCES["flash_bf16_tiled_served"].ok(got, tiled),
          f"flash {[B, S, Hq, Hkv, D]} window {window}: kernel disagrees "
          f"(max_abs_err {err})")
    del got, ref, tiled
    sdpa_mask = None
    if window is not None:
        pos = torch.arange(S, device="cuda")
        sdpa_mask = (pos[None, :] <= pos[:, None]) & \
            (pos[:, None] - pos[None, :] < window)

    def library(q=q, k=k, v=v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=sdpa_mask, is_causal=causal and sdpa_mask is None,
            enable_gqa=True)
    # 4 D operations per unmasked (q, k) pair (QK^T and PV): row i sees
    # min(i + 1, window) keys, or all S; q, k, v read once, o written once
    pairs = sum(min(i + 1, window or S) for i in range(S)) if causal \
        else S * S
    flops = 4 * B * Hq * D * pairs
    row = {
        "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": causal,
        "window": window, "mainloop": plan.mainloop,
        "block_k": plan.block_k,
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, **mask),
                      iters, flush),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **mask),
                            2, flush),
        "library_ms": time_ms(library, iters, flush),
        "max_abs_err": err,
    }
    row["tflop_s"] = flops / row["ms"] / 1e9
    row["library_tflop_s"] = flops / row["library_ms"] / 1e9
    row["bound_ms"], row["bound_by"] = bound(
        flops, 2 * B * S * D * (2 * Hq + 2 * Hkv))
    return row


def flash_line(cfg, by_mainloop: dict, moe_cfg, moe_by_mainloop: dict,
               hybrid_cfg, hybrid_table: dict, nemotron: dict,
               dense_served: dict, audio_cfg, audio_launches: dict,
               vlm_cfg, vlm_launches: dict) -> dict:
    """granite-8b's prefill attention at buckets 256 and 2048 (B = SLOTS),
    the line's own numbers (a forward's 36 launches at 2048), and dbrx-
    132b's longest exact-length prefill, [1, 1277, 48 over 8, 128]; under
    "hybrid", hymba-1.5b's [SLOTS, 2048, 25 over 5, 64] with its window
    and global, and their sum over a forward (29 windowed, 3 global).
    Launches by mainloop are the served runs' (granite paged; dbrx under
    "moe"; hymba dense under "hybrid"). Under "dense_archs", nemotron-4-
    340b's [SLOTS, 2048, 96 over 8, 192] on mma (phase flash) and the dense
    archs' served launches by mainloop. Under "whisper", whisper-small's
    encoder, [1, 1500, 12 over 12, 64] non-causal, and its decoder's
    prefill at the longest served prompt, [1, 64, 12 over 12, 64] causal,
    each summed over its 12 layers, with the served launches. Under
    "vlm", llama-3.2-vision-90b's longest served prefill, [1, 600, 64
    over 8, 128] causal, and its sum over the 30-layer cut's 24 dense
    layers, with the served launches."""
    g = torch.Generator("cuda").manual_seed(4)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    D = cfg.resolved_head_dim
    rows = [flash_row(SLOTS, S, cfg.n_heads, cfg.n_kv_heads, D, iters, g,
                      flush) for S, iters in zip(FLASH_SEQS, (20, 5))]
    rows.append(flash_row(1, 1277, moe_cfg.n_heads, moe_cfg.n_kv_heads,
                          moe_cfg.resolved_head_dim, 10, g, flush))
    hc = hybrid_cfg
    h_rows = [flash_row(SLOTS, 2048, hc.n_heads, hc.n_kv_heads,
                        hc.resolved_head_dim, 10, g, flush, window=w)
              for w in (hc.sliding_window, None)]
    n_global = len(hc.global_attn_layers)
    n_window = hc.n_layers - n_global
    h_forward = {k: n_window * h_rows[0][k] + n_global * h_rows[1][k]
                 for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    ac = audio_cfg
    w_rows = [flash_row(1, S, ac.n_heads, ac.n_kv_heads,
                        ac.resolved_head_dim, iters, g, flush, causal=causal)
              for S, iters, causal in ((AUDIO_SERVE["src_len"], 10, False),
                                       (64, 20, True))]
    vc = vlm_cfg
    v_row = flash_row(1, VLM_MAX_PROMPT, vc.n_heads, vc.n_kv_heads,
                      vc.resolved_head_dim, 10, g, flush)
    v_dense = vc.n_layers - vc.n_layers // vc.cross_attn_every
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    top, L = rows[1], cfg.n_layers
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:72",
        "launches": sum(by_mainloop.values()),
        "launches_by_mainloop": by_mainloop,
        "moe": {"arch": moe_cfg.name, "n_layers": moe_cfg.n_layers,
                "launches_by_mainloop": moe_by_mainloop},
        "hybrid": {"arch": hc.name, "n_layers": hc.n_layers,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "forward_2048": {**h_forward, "windowed": n_window,
                                    "global": n_global},
                   "shapes": h_rows},
        "dense_archs": {"nemotron": nemotron,
                        "served": {a: {"n_layers": d["n_layers"],
                                       "launches_by_mainloop":
                                           d["flash_by_mainloop"]}
                                   for a, d in dense_served.items()}},
        "whisper": {"arch": ac.name, "launches": audio_launches["flash"],
                    "launches_by_mainloop":
                        audio_launches["flash_by_mainloop"],
                    "encoder_pass": {k: ac.n_encoder_layers * w_rows[0][k]
                                     for k in keys},
                    "decoder_prefill_64": {k: ac.n_layers * w_rows[1][k]
                                           for k in keys},
                    "shapes": w_rows},
        "vlm": {"arch": vc.name, "n_layers": vc.n_layers,
                "launches": vlm_launches["flash"],
                "launches_by_mainloop": vlm_launches["flash_by_mainloop"],
                "prefill_600": {**{k: v_dense * v_row[k] for k in keys},
                                "launches": v_dense},
                "shapes": [v_row]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + h_rows +
                           w_rows + [nemotron, v_row]),
        "ms": L * top["ms"], "plain_ms": L * top["plain_ms"],
        "bound_ms": L * top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": L * top["library_ms"],
        "ms_are": (f"sums over the {L} launches of one {cfg.name} prefill "
                   f"forward at bucket {top['S']} (B={SLOTS}, bf16, causal; "
                   f"per-shape rows below, the last {moe_cfg.name}'s "
                   f"[1, 1277] prefill; L2 flushed)"),
        "shapes": rows,
    }


def gemm_nt_line(cfg, launches: int, by_mainloop: dict,
                 hybrid: dict) -> dict:
    """The tied LM head of cfg (x [M, d] @ tok [vocab, d]^T, bf16 out) at
    decode (M = SLOTS), at a [SLOTS, 256] prefill and at the largest
    bucketed prefill, [SLOTS, 2048] (M = 8192: the head runs over every
    position); one launch per forward. Launches by mainloop are the
    served run's."""
    K, N = cfg.d_model, cfg.vocab
    g = torch.Generator("cuda").manual_seed(8)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    for phase, M, iters in (("decode", SLOTS, 20), ("prefill", SLOTS * 256,
                                                     5),
                            ("prefill", SLOTS * 2048, 3)):
        x, w = gemm_inputs(M, K, N, torch.bfloat16, g, transposed=True)
        got = sg.systolic_gemm_nt_cuda(x, w, out_dtype=torch.bfloat16)
        ref = systolic_gemm_t_ref(x, w, out_dtype=torch.bfloat16)
        err = float((got.double() - ref.double()).abs().max())
        check(TOLERANCES["gemm_bf16out"].ok(got, ref),
              f"NT {phase}: kernel disagrees (max_abs_err {err})")
        worst = max(worst, err)
        row = {
            "phase": phase, "M": M, "K": K, "N": N,
            "plan": list(sg.gemm_plan("nt", M, N, K, torch.bfloat16, True)),
            "ms": time_ms(lambda: sg.systolic_gemm_nt_cuda(
                x, w, out_dtype=torch.bfloat16), iters, flush),
            "plain_ms": time_ms(lambda: systolic_gemm_t_ref(
                x, w, out_dtype=torch.bfloat16), iters, flush),
            "library_ms": time_ms(lambda: torch.matmul(x, w.t()), iters,
                                  flush),
            "max_abs_err": err,
        }
        row["bound_ms"], row["bound_by"] = bound(
            2 * M * N * K, 2 * (M * K + K * N + M * N))
        rows.append(row)
        del x, w, got, ref
    dec = rows[0]
    return {
        "name": "systolic_gemm_nt", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:249",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": worst,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "ms_are": (f"one {cfg.name} LM head at decode, M={SLOTS} (one "
                   f"launch per forward; per-shape rows below, L2 flushed)"),
        "shapes": rows, "hybrid": hybrid,
    }


def ssd_bound(b, S, H, P, G, N, chunk) -> tuple[float, str]:
    """The least time for one SSD call: x, dt, B, C read once and y and the
    final state written once (bf16, dt f32) at the HBM rate, against the
    operations this causal chunk scan needs at the rate of their type:
    C B^T and M x over the lower triangle of each chunk on the bf16 tensor
    cores, C h^T and x^T B in f32 (as the Pallas kernel's dots) on the
    CUDA cores. The larger of the three."""
    nc = -(-S // chunk)
    pairs = b * H * nc * chunk * (chunk + 1) // 2
    bf16_ops = 2 * (N + P) * pairs
    f32_ops = 4 * b * H * nc * chunk * N * P
    nbytes = (2 * 2 * b * S * H * P + 2 * 2 * b * S * G * N + 4 * b * S * H
              + 2 * 4 * H + 2 * b * H * P * N)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(bf16_ops / BF16_FLOP_PER_S,
                               f32_ops / F32_FLOP_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def ssd_split_ms(args, chunk: int, flush: torch.Tensor) -> dict:
    """Device ms of each kernel one SSD call launches (chunked: the chunk
    states, the state pass, the chunk scan), from torch.profiler over 5
    calls, each after an L2 flush."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            ssd_mod.ssd_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        name = re.search(r"ssd_\w+", e.key)
        if name and e.device_time_total > 0:
            split[name.group(0)] = e.device_time_total / e.count / 1e3
    return split


def ssd_row(cfg, S: int, iters: int, g, flush) -> dict:
    """cfg's SSD call at [SLOTS, S] (bf16) on the mainloop ssd_plan picks,
    checked against the Pallas kernel's arithmetic, then timed beside the
    serial mainloop and the plain version, with its bound and each
    launch's device ms."""
    s = cfg.ssm
    H, P, N, chunk = s.n_heads(cfg.d_model), s.head_dim, s.d_state, \
        s.chunk_size
    shape = (SLOTS, S, H, P, s.n_groups, N)
    args = ssd_inputs(shape, torch.bfloat16, g)
    y, h = ssd_mod.ssd_cuda(*args, chunk=chunk)
    ky, kh = ssd_kernel_ref(*args, chunk=chunk)
    tol = TOLERANCES["ssd_bf16_kernel"]
    err = float((y.double() - ky.double()).abs().max())
    check(tol.ok(y, ky) and tol.ok(h, kh),
          f"ssd {cfg.name} S={S}: kernel disagrees (max_abs_err {err})")
    row = {"b": SLOTS, "S": S, "H": H, "P": P, "G": s.n_groups, "N": N,
           "chunk": chunk,
           "mainloop": ssd_mod.ssd_plan(P, N, chunk, torch.bfloat16),
           "ms": time_ms(lambda: ssd_mod.ssd_cuda(*args, chunk=chunk),
                         iters, flush),
           "serial_ms": time_ms(lambda: ssd_mod.ssd_cuda(
               *args, chunk=chunk, mainloop="serial"), iters, flush),
           "plain_ms": time_ms(lambda: ssd_kernel_ref(*args, chunk=chunk),
                               2, flush),
           "library_ms": None, "max_abs_err": err}
    row["bound_ms"], row["bound_by"] = ssd_bound(*shape, chunk)
    row["split_ms"] = ssd_split_ms(args, chunk, flush)
    return row


def ssd_line(cfg, launches: int, by_mainloop: dict, hybrid_cfg,
             hybrid_table: dict) -> dict:
    """mamba2's SSD call at [SLOTS, 256] and [SLOTS, 2048] (bf16), on the
    mainloop ssd_plan picks, with the serial mainloop (the earlier design)
    timed beside it on the same inputs; under "hybrid", hymba-1.5b's at
    [SLOTS, 2048] (50 heads, N 16: serial) and its forward's 32 launches.
    Launches by mainloop are the served runs'."""
    g = torch.Generator("cuda").manual_seed(9)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows = [ssd_row(cfg, S, iters, g, flush)
            for S, iters in ((256, 20), (2048, 10))]
    h_row = ssd_row(hybrid_cfg, 2048, 10, g, flush)
    check(h_row["mainloop"] == "serial",
          f"hymba's SSD plan is {h_row['mainloop']}, not serial")
    worst = max(r["max_abs_err"] for r in rows + [h_row])
    hL = hybrid_cfg.n_layers
    top, L = rows[-1], cfg.n_layers
    return {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:70",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "mainloop": top["mainloop"], "max_abs_err": worst,
        "ms": L * top["ms"], "plain_ms": L * top["plain_ms"],
        "bound_ms": L * top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "serial_ms": L * top["serial_ms"],
        "ms_are": (f"sums over the {L} launches of one {cfg.name} prefill "
                   f"forward at bucket {top['S']} (b={SLOTS}, bf16, on "
                   f"{top['mainloop']}; serial_ms the serial mainloop on the "
                   f"same inputs; per-shape rows below, L2 flushed; no "
                   f"single PyTorch call computes the chunk scan)"),
        "shapes": rows,
        "hybrid": {"arch": hybrid_cfg.name, "n_layers": hL,
                   "launches": hybrid_table["launches"],
                   "launches_by_mainloop": hybrid_table["by_mainloop"],
                   "forward_2048": {k: hL * h_row[k] for k in
                                    ("ms", "plain_ms", "bound_ms")},
                   "shapes": [h_row]},
    }


def grouped_rows(G: int, shapes, seed: int):
    """The grouped kernel at each (phase, name, M, K, N, activation) with G
    groups (bf16, bf16 out) against its plain version, timed beside it
    and torch.bmm (plus SiLU for the gate), L2 flushed, with its bound."""
    g = torch.Generator("cuda").manual_seed(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0.0
    for phase, name, M, K, N, act in shapes:
        x, w = grouped_inputs(G, M, K, N, torch.bfloat16, g)
        got = sg.grouped_systolic_gemm_cuda(x, w, activation=act,
                                            out_dtype=torch.bfloat16)
        ref = grouped_systolic_gemm_ref(x, w, activation=act,
                                        out_dtype=torch.bfloat16)
        err = float((got.double() - ref.double()).abs().max())
        check(TOLERANCES["gemm_bf16out"].ok(got, ref),
              f"grouped G={G} {phase} {name}: kernel disagrees "
              f"(max_abs_err {err})")
        worst = max(worst, err)
        del got, ref

        def library(x=x, w=w, act=act):
            y = torch.bmm(x, w)
            return F.silu(y) if act == "silu" else y
        iters = 20 if phase == "decode" else 5
        row = {"gemm": name, "phase": phase, "G": G, "M": M, "K": K, "N": N,
               "plan": list(sg.gemm_plan("grouped", M, N, K, torch.bfloat16,
                                         True)),
               "ms": time_ms(lambda: sg.grouped_systolic_gemm_cuda(
                   x, w, activation=act, out_dtype=torch.bfloat16),
                   iters, flush),
               "plain_ms": time_ms(lambda: grouped_systolic_gemm_ref(
                   x, w, activation=act, out_dtype=torch.bfloat16), 3,
                   flush),
               "library_ms": time_ms(library, iters, flush),
               "max_abs_err": err}
        row["bound_ms"], row["bound_by"] = bound(
            2 * G * M * N * K, 2 * G * (M * K + K * N + M * N))
        rows.append(row)
        del x, w
    return rows, worst


def grouped_line(cfg, launches: int, by_mainloop: dict,
                 hybrid: dict, mla_cfg, mla_launches: dict) -> dict:
    """dbrx's expert GEMMs (bf16, bf16 out): one decode step's three
    projections at M = 1 row per expert (x MOE_LAYERS layers = 24
    launches), and the up and down projections of a 1024-token prefill at
    M = 320; up at M = 384 too, the same three 128-row tiles per expert
    without the padding, shows what padding 320 rows costs. The library
    yardstick is torch.bmm of the same G GEMMs, plus SiLU for the gate.
    Under "deepseek": deepseek-v2's 160 experts, a decode step's three
    projections at M = 1 (x 7 MoE layers = 21 launches) and the
    1277-token prompt's up and down at M = 59. Launches by mainloop are
    the served runs'."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    rows, worst = grouped_rows(E, [
        ("decode", "up", 1, d, f, None), ("decode", "gate", 1, d, f, "silu"),
        ("decode", "down", 1, f, d, None),
        ("prefill", "up", 320, d, f, None),
        ("prefill", "down", 320, f, d, None),
        ("prefill", "up", 384, d, f, None)], seed=12)
    L = cfg.n_layers
    dec = {k: L * sum(r[k] for r in rows if r["phase"] == "decode")
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    E, d, f = (mla_cfg.moe.num_experts, mla_cfg.d_model,
               mla_cfg.moe.d_ff_expert)
    moe_layers = mla_cfg.n_layers - mla_cfg.moe.first_dense_layers
    ds_rows, ds_worst = grouped_rows(E, [
        ("decode", "up", 1, d, f, None), ("decode", "gate", 1, d, f, "silu"),
        ("decode", "down", 1, f, d, None),
        ("prefill", "up", 59, d, f, None),
        ("prefill", "down", 59, f, d, None)], seed=31)
    ds_dec = {k: moe_layers * sum(r[k] for r in ds_rows
                                  if r["phase"] == "decode")
              for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {
        "name": "grouped_systolic_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/systolic_gemm/csrc/systolic_gemm.cu",
        "replaces": "src/repro/kernels/systolic_gemm/systolic_gemm.py:182",
        "launches": launches, "launches_by_mainloop": by_mainloop,
        "max_abs_err": max(worst, ds_worst),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": "bytes",
        "library_ms": dec["library_ms"],
        "ms_are": (f"sums over the {3 * L} grouped launches of one "
                   f"{cfg.name} ({L} layers) decode step, M = 1 row per "
                   f"expert (per-shape rows below, the prefill rows per "
                   f"launch; L2 flushed)"),
        "shapes": rows, "hybrid": hybrid,
        "deepseek": {"arch": mla_cfg.name, "n_layers": mla_cfg.n_layers,
                     "launches": mla_launches["grouped"],
                     "launches_by_mainloop":
                         mla_launches["grouped_by_mainloop"],
                     "per_forward": 3 * moe_layers,
                     "decode_step": ds_dec, "shapes": ds_rows},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        phase_build()
        dense_gemms = phase_kernel()
        torch.cuda.synchronize()
        phase_gemm_nt()
        torch.cuda.synchronize()
        nemotron_flash = phase_flash()
        torch.cuda.synchronize()
        phase_ssd()
        torch.cuda.synchronize()
        phase_grouped()
        torch.cuda.synchronize()

        cfg = get_arch(ARCH)
        t0 = time.perf_counter()
        model = Model(cfg, use_pallas=True)
        flash_model = Model(cfg, attention_impl="pallas", use_pallas=True)
        params = model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=cfg.name, params=model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)

        served, launches, by_mainloop, base = phase_serve(model, params)
        torch.cuda.synchronize()
        phase_oracle(model, params, served)
        torch.cuda.synchronize()
        paged, flash_by_mainloop = phase_serve_paged(flash_model, params)
        torch.cuda.synchronize()
        phase_paged_oracle(flash_model, params, paged)
        torch.cuda.synchronize()
        phase_serve_controls(model, flash_model, params)
        torch.cuda.synchronize()
        phase_launch_serve()
        torch.cuda.synchronize()
        guard = phase_guard(model, params, base)
        torch.cuda.synchronize()
        del params, base
        torch.cuda.empty_cache()

        ssm_cfg = get_arch(SSM_ARCH)
        t0 = time.perf_counter()
        ssm_model = Model(ssm_cfg, ssd_impl="pallas", use_pallas=True)
        ssm_params = ssm_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=ssm_cfg.name, params=ssm_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        ssm_served, ssm_launches = phase_serve_ssm(ssm_model, ssm_params)
        torch.cuda.synchronize()
        phase_ssm_oracle(ssm_model, ssm_params, ssm_served)
        torch.cuda.synchronize()
        phase_guard_ssm(ssm_model, ssm_params)
        torch.cuda.synchronize()
        del ssm_params
        torch.cuda.empty_cache()

        moe_cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_LAYERS)
        t0 = time.perf_counter()
        moe_model = Model(moe_cfg, attention_impl="pallas", use_pallas=True)
        moe_params = moe_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=moe_cfg.name, n_layers=MOE_LAYERS,
             of_layers=get_arch(MOE_ARCH).n_layers,
             params=moe_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        _, moe_launches = phase_serve_moe(moe_model, moe_params)
        torch.cuda.synchronize()
        phase_moe_oracle(moe_model, moe_params)
        torch.cuda.synchronize()
        emit("moe_memory",
             gib_peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del moe_params
        gc.collect()
        torch.cuda.empty_cache()

        mla_cfg = dataclasses.replace(get_arch(MLA_ARCH), n_layers=MLA_LAYERS)
        t0 = time.perf_counter()
        freed = torch.cuda.memory_allocated()
        mla_model = Model(mla_cfg, attention_impl="pallas", use_pallas=True)
        mla_params = mla_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=mla_cfg.name, n_layers=MLA_LAYERS,
             of_layers=get_arch(MLA_ARCH).n_layers,
             params=mla_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated_before=freed / 2 ** 30,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        _, mla_launches = phase_serve_mla(mla_model, mla_params)
        torch.cuda.synchronize()
        phase_mla_oracle(mla_model, mla_params)
        torch.cuda.synchronize()
        emit("mla_memory",
             gib_peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del mla_params
        gc.collect()
        torch.cuda.empty_cache()

        audio_cfg = get_arch(AUDIO_ARCH)
        t0 = time.perf_counter()
        audio_model = Model(audio_cfg, attention_impl="pallas",
                            use_pallas=True)
        audio_params = audio_model.init(
            torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=audio_cfg.name, params=audio_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        audio_served, audio_launches = phase_serve_audio(audio_model,
                                                         audio_params)
        torch.cuda.synchronize()
        phase_audio_oracle(audio_model, audio_params, audio_served)
        torch.cuda.synchronize()
        del audio_params, audio_served
        gc.collect()
        torch.cuda.empty_cache()

        vlm_cfg = dataclasses.replace(get_arch(VLM_ARCH), n_layers=VLM_LAYERS)
        t0 = time.perf_counter()
        freed = torch.cuda.memory_allocated()
        vlm_model = Model(vlm_cfg, attention_impl="pallas", use_pallas=True)
        vlm_params = vlm_model.init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=vlm_cfg.name, n_layers=VLM_LAYERS,
             of_layers=get_arch(VLM_ARCH).n_layers,
             params=vlm_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated_before=freed / 2 ** 30,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        vlm_served, vlm_launches = phase_serve_vlm(vlm_model, vlm_params)
        torch.cuda.synchronize()
        gc.collect()
        phase_vlm_oracle(vlm_model, vlm_params, vlm_served)
        torch.cuda.synchronize()
        emit("vlm_memory",
             gib_peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del vlm_params, vlm_served
        gc.collect()
        torch.cuda.empty_cache()

        hybrid_cfg = get_arch(HYBRID_ARCH)
        t0 = time.perf_counter()
        hybrid_model = Model(hybrid_cfg, attention_impl="pallas",
                             ssd_impl="pallas", use_pallas=True)
        hybrid_params = hybrid_model.init(
            torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        emit("init", arch=hybrid_cfg.name, params=hybrid_model.param_count(),
             seconds=time.perf_counter() - t0,
             gib_allocated=torch.cuda.memory_allocated() / 2 ** 30)
        hybrid_served, hybrid = phase_serve_hybrid(hybrid_model,
                                                   hybrid_params)
        torch.cuda.synchronize()
        phase_ssm_oracle(hybrid_model, hybrid_params, hybrid_served,
                         phase="hybrid_oracle")
        torch.cuda.synchronize()
        del hybrid_params
        gc.collect()
        torch.cuda.empty_cache()

        dense_served = phase_dense_archs()
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

        children = dryrun_children()
        try:
            phase_train_flash_vjp()
            torch.cuda.synchronize()
            train = phase_train()
            torch.cuda.synchronize()
            phase_launch_train()
            torch.cuda.synchronize()
            phase_parallel()
            torch.cuda.synchronize()
            phase_dryrun(train, children)
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.communicate()
        torch.cuda.synchronize()

        kernels = {"kernels": [gemm_line(
            cfg, launches, by_mainloop, moe_cfg, moe_launches["pod_gemm"],
            moe_launches["pod_gemm_by_mainloop"], hybrid_cfg,
            hybrid["pod_gemm"], guard, dense_gemms, dense_served, mla_cfg,
            mla_launches, audio_cfg, audio_launches, vlm_cfg, vlm_launches),
                               flash_line(cfg, flash_by_mainloop, moe_cfg,
                                          moe_launches["flash_by_mainloop"],
                                          hybrid_cfg, hybrid["flash"],
                                          nemotron_flash, dense_served,
                                          audio_cfg, audio_launches,
                                          vlm_cfg, vlm_launches),
                               gemm_nt_line(
                                   ssm_cfg, ssm_launches["gemm_nt"],
                                   ssm_launches["gemm_nt_by_mainloop"],
                                   hybrid["gemm_nt"]),
                               ssd_line(ssm_cfg, ssm_launches["ssd"],
                                        ssm_launches["ssd_by_mainloop"],
                                        hybrid_cfg, hybrid["ssd"]),
                               grouped_line(
                                   moe_cfg, moe_launches["grouped"],
                                   moe_launches["grouped_by_mainloop"],
                                   hybrid["grouped"], mla_cfg,
                                   mla_launches)]}
        torch.cuda.synchronize()
        gpu = gpu_name_and_power()
    except Exception:  # every phase failure ends the run non-zero
        traceback.print_exc()
        return 1
    print(gpu)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
