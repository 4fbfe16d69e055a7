#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi); TF32 off for
             matmuls and cuDNN, so float32 is float32; the card's key
             (``autotune.default_chip``: ``"H100"`` only for the H100 SXM,
             any other card its own name) and the catalog entry every
             bound is read from (the SXM's data sheet, said so on any
             other card).
2. build     compile every CUDA source of the port with nvcc, in parallel;
             registers, spills and shared memory of every instantiation of
             the decode kernel, the attention kernels (bf16 wgmma and
             CUDA-core, forward and backward), the RMSNorm and fused add +
             RMSNorm kernels and the SSD scan's passes.
3. kernels   hold each of the six kernels against its plain PyTorch version
             on the card (bf16 2e-2, fp32 2e-5; SSD y 4e-2 / 1e-4 and state
             1e-2 / 1e-4) at the main paths' shapes and the edge cases, and
             time kernel, plain version and, where one exists, the PyTorch
             library call computing the same function.  RMSNorm is timed
             at 4096 and 16384 x 960 bf16 beside ``F.rms_norm``, the fused
             add + RMSNorm at the same shapes; fp32 at the calibrate
             points (RMSNorm 4096 and 16384 x 960, the fused norm 4096 x
             960, add 4096 x 512, under ``f32``); each case of both checks
             which instantiation ran (16-byte or scalar loads, on widths
             and views that are not 16-byte multiples); the fused
             kernel's y must be its plain version's bit for bit.  The SSD
             scan is held against the composition of its four passes' plain
             versions, and each pass is timed alone (``passes_ms``).  Decode also runs
             at forced split counts (one split, one tile a split) and is
             timed at the serve shape beside the kernel line's case.
             Prefill attention is timed at the serve shape and at the
             calibrate path's (1, 2048, 120/120, 64), each beside the
             CUDA-core kernel run on the same bf16 inputs
             (``impl="cuda_core"``): the wgmma kernel must be faster at the
             byte-bound serve shape and 4x faster at the operation-bound
             calibrate shape.  fp32 is timed at the calibrate shape.
             Every shape the plan phase's fits launch (``plan_shapes``:
             attention at (1|2|4, 1024, 15/5, 64) bf16 and (1|2|4, 128)
             fp32, the norm at their mbs x seq rows, forward and backward)
             is held against the plain versions; the fp32 attention
             backward is timed at (4, 128).
4. models    a 2-layer fp32 model, kernel path vs plain path; the reduced
             smollm config (head_dim 16, ``attn_impl="auto"``) prefills
             through the attention kernel.
5. serve     smollm-360M at its published widths (32 layers, bf16, seeded
             random weights) through ``BatchedServer``, its prefills
             (``GraphedPrefill``, a graph per batch shape from that
             shape's second batch) and decode steps (``GraphedDecodeStep``)
             as CUDA graphs: 16 requests, prompts of 256-509 tokens, 32 new
             tokens each, batch 8.  The two prefill kernels must show 32
             launches per prefill and the other six none; an eager server
             (``graphed=False``) serves the same requests and must give the
             same tokens.  The first batch's prefill, graphed and eager in
             turns from the same state (each side its own copy, equal bit
             for bit after); its last-token logits held against the port's
             plain path.  Decode ms a step graphed and eager in turns from
             the same cache state (equal after); the graphs, their capture
             seconds and pool bytes; a graphed and an eager prefill and
             decode step profiled (device time by kernel group, busy share
             against each one's wall).
   serve continuous  ``ContinuousBatchingServer`` on the same weights:
             32 requests of 256-509-token prompts (bucket 512), 8-64 new
             tokens, 8 slots, max_ctx 576, 224 pages of 16 (so it must
             preempt), after a warm run that must capture every prefill
             and decode graph the timed run uses; graphed and eager must
             give the same tokens and ``ServerStats``, every request its
             own length, every page back, the prefill kernels 32 launches a
             prefill.  The (1, 512) prefill graphed and eager in turns into
             row 0 (equal bit for bit after), its last-token logits held
             against the port's plain path (phase 3 holds both prefill
             kernels at this shape: attention (1, 512, 15/5, 64), the fused
             norm 512 x 960), its share of the run.  ServerStats, tok/s,
             decode ms a step at each bucket (in turns, and back to back),
             a profiled prefill and decode replay.
6. calibrate ``calibrate_kernels("H100", bf16 and fp32)`` at smollm-360M's
             widths, the table scored on held-out shapes against the
             roofline (``bench.kernels_bench.cost_table_accuracy``), and
             ``JobProfile`` prices of one smollm-360M layer with and
             without the table beside the serve phase's device time.
7. fused     ``bench.kernels_bench.fused_vs_unfused``: the fused kernel
             against the add kernel + the RMSNorm kernel.
8. train     smollm-360M at its published widths and 32 layers, bf16,
             ``remat="full"``, through ``train_step.make_train_step`` on
             ``SyntheticDataset`` batches (seq 1024, global batch 8, 2
             microbatches): 8 AdamW steps on one repeated batch (the loss
             must fall), then 3 timed steps on fresh batches (device ms a
             step by CUDA events, host wall ms, tokens/s, peak memory) and
             one profiled.  Per step the attention forward must launch
             2 x 32 x 2 times (the forward runs again under remat) and each
             backward kernel 32 x 2 times.  Then one microbatch's loss and
             gradients through the kernels against the plain path
             (``attn_impl="naive"``), at full width in bf16 and on a
             2-layer fp32 model (1e-4 of max |g|).  Then the graphed step
             (``make_graphed_train_step``, one CUDA graph a step) against
             the eager one from two copies of the same seeded weights: 3
             steps each on the same batches, loss, grad_norm and every
             param compared after each (``TRAIN_LOSS_TOL``, params
             ``TRAIN_GRAD_TOL`` of max |p|; bit-identical or not), the
             same launches a step; 4 pairs timed in turns (wall, device
             ms, tokens/s, peak memory), the capture's seconds and the
             graph's nodes; both steps profiled, the "elementwise/other"
             group broken down by kernel name.
   pipeline  ``dist/pipeline.MPMDPipeline``, the runtime that executes
             Sailor's plans, on smollm-360M at its published widths and
             depth, bf16, untied (the reference's cut for the pipeline),
             ``remat="full"``: ``even_stages(cfg, [1, 1])``, two stages of
             16 layers on ``[cuda:0, cuda:0]``, on phase 8's data and
             optimizer.  Graphed (a CUDA graph a stage, program and input
             shape) and eager pipelines from the same weights must be bit
             for bit equal after 2 steps; the graphed first step's loss
             and per-stage gradients are held against the single-device
             ``loss_and_grads`` (phase 8's bounds); the loss must fall
             over 4 steps on one batch; 3 pairs of steps timed in turns
             (wall, device ms, ratio to phase 8's graphed step), one
             graphed step profiled; per step the attention forward must
             launch 3 x 32 x 2 times (the forward, and the backward's
             recompute under remat), its backward 32 x 2 and no other
             kernel; each stage's resident bytes and its programs' most
             allocated.  Then an fp32 2-layer pipeline against
             ``make_train_step`` (1e-4) and an ``AdaptiveDPGroup`` of two
             such pipelines, a 2:1 assignment against the uniform one (each
             step's loss within 1e-3).  Then mesh stages:
             ``even_stages(cfg, [2, 1])``, stage 0 on a (1, 2) ``fsdp_tp``
             mesh, three positions on ``cuda:0``, graphed (``graphed=
             True``: the mesh stage too) and eager from the same weights
             in turns, bit for bit after every step (losses, every
             stage's params and AdamW state): the first step's loss and
             gradients (gathered whole) against ``loss_and_grads`` and the
             ``[1, 1]`` pipeline's first step (phase 8's bounds), the loss
             falling over 4 steps, 3 pairs timed in turns beside the
             ``[1, 1]`` pipeline's eager step, each side profiled
             (``[profile] pipeline_mesh_step``, ``_graphed``), the launches
             a step (the attention forward 3 x 16 x 2 x 2 + 3 x 16 x 2 =
             288: 15 heads do not divide tp 2, so attention is replicated
             on stage 0's two positions; its backward 96; no fused norm)
             in a launch window of their own (``launches_pipeline_mesh``),
             each stage's resident bytes a position; fp32 2 layers on
             ``[2, 1]`` and on ``[1, 1]`` at dp 2 against
             ``make_train_step`` (1e-4).
   mesh      the sharded (data, model) train step
             (``train_step.jit_train_step`` over ``dist/spmd.py``: one
             process runs every mesh position in lockstep, each from its
             own blocks, with the collectives XLA inserts for the
             reference) on smollm-360M at its published widths and depth,
             bf16, full remat, on phase 8's data, optimizer and weights,
             on two meshes whose positions are all ``cuda:0``: (2, 2)
             ``fsdp_tp`` (FFN, vocab and 'embed' sharded, attention
             replicated) and (1, 5) ``tp`` (3/1 heads and d_ff 512 a
             position, vocab replicated).  For each: every position's
             elements and resident bytes beside the simulator's ``params
             / tp``; the first step's loss and gradients against the
             single-device ``loss_and_grads`` (phase 8's bounds); then
             the step graphed (``jit_train_step(..., graphed=True)``: a
             warm call, the capture, replays) and eager from the same
             weights on the same batches in turns, the graphed side's
             params, ``m``, ``v``, step, loss and grad_norm equal to the
             eager side's bit for bit after every step and a step's
             launches equal on both: the loss falling over 2 steps; 3
             pairs timed (each side's median) beside phase 8's eager step;
             the capture's seconds, launches and record entries; the
             launches a step (each position the attention forward and the
             fused norm 2 x 32 x 2 times, each backward 32 x 2); every
             replica of a block, of params, ``m`` and ``v``, equal bit for
             bit; a step of each side profiled (``[profile] mesh_step_*``,
             ``mesh_step_graphed_*``).  Then an fp32 2-layer model on
             (2, 2) against ``make_train_step`` (1e-4).  Phase 3 holds
             each position's attention and norm shapes (``mesh_*``).
   dryrun    ``launch/dryrun``'s fake-tensor trace of [mesh]'s (2, 2)
             ``fsdp_tp`` cell (the train cell's tokens, devices
             ``[cuda:0] * 4``) twice, every iteration of its loops and
             replayed (each loop one trip of its count,
             ``program_cost.replay``): both host seconds, and the two
             must be one program (``dryrun.trace_differences``: FLOPs
             and bytes within 1e-9, peak, ``FAKE_CALLS`` and record
             equal); the replayed trace's FLOPs, bytes, peak live bytes
             and roofline seconds; then one real step of the cell with
             the collective record on (``placement.
             record_collectives``), whose record must equal the
             replayed one entry for entry and whose launches must equal
             its ``FAKE_CALLS``; the fake peak over
             ``max_memory_allocated``, the roofline beside a profiled
             step's device ms (``launches_dryrun``: three steps); then
             [mesh]'s graphed (2, 2) step, the same cell: its profiled
             replay's record and launches, and its capture's record,
             must equal the replayed trace's.  Then
             the chunked loss on the mesh: the cell at ``logits_chunk``
             DRYRUN_CHUNK, its loss and gradients against the one-device
             chunked step on the same weights (within twice one
             device's own bf16-vs-fp32 distance), and one real step whose
             launches and record must equal its replayed trace's, its
             ``max_memory_allocated`` beside the unchunked step's and the
             fake peak (``launches_dryrun_chunked``).
   audit     the real step's record audited against ``predicted_comm``
             (tp 2, dp 2; advisory: findings by kind, ``rel_diff``); the
             collective-audit demo (``analysis/demo``) on ``[cuda:0] * 8``,
             whose clean variant must audit clean and seeded one fail;
             ``plan_for`` with ``audit="warn"`` on the [plan] fleets.
   serve mesh  the sharded prefill and decode step (``serve_step.
             make_prefill(cfg, mesh)``, ``make_decode(cfg, mesh)``),
             every position on ``cuda:0``, eager, bf16: smollm-360M at
             32 layers on (2, 2) ``fsdp_tp`` (the cache split over the
             sequence) and (1, 5) ``tp`` (3 query heads and 1 K/V head a
             position), 8 prompts of 512, ``grow_cache`` to 576, 32
             decode steps; dbrx and mixtral (past its window) at 2 layers
             on (1, 2), mamba2-130m at 24 on (1, 4), zamba2-2.7b at 12 on
             (1, 2).  Each against the one-device steps fed the same
             tokens (first tokens equal; every step's logits within the
             larger of ``LOGITS_TOL`` and twice the one-device bf16 run's
             distance from fp32), the first prefill's launches equal to
             the dry run's ``FAKE_CALLS`` and its collective record to the
             fake one, no launch in the decode steps; the second prefill's
             and the median step's wall beside one device's
             (``launches_serve_mesh``).
   mesh families  whisper-tiny (4 + 4 layers, 1500 frames) on (2, 2)
             ``fsdp_tp`` and (1, 4) ``tp`` and internvl2-26b at 2 layers
             (256 patches) on (2, 2) ``fsdp_tp`` and (1, 2) ``tp``
             (``dist/spmd_encdec.py``, the patches in ``spmd.forward``),
             every position on ``cuda:0``, eager, bf16, full remat: the
             train step (the first step's gradients against one device's,
             3 steps, the first one's launches and collective record equal
             to the dry run's, the eager walls beside one device's; on
             (2, 2) 5 steps, a graphed side beside them in turns, its 3
             replays bit for bit with eager and timed) and
             serving as [serve mesh]'s cases, on seeded stub frames or
             patches (``launches_mesh_families``).
   elastic   ``train/elastic.ElasticTrainer`` (kill-free reshards and
             rollbacks to ``train/checkpoint.CheckpointManager``'s async
             checkpoints) on phase 8's model, data and optimizer (tied,
             full remat), ``devices=[cuda:0] * 4``, the default all-data-
             parallel plan, a checkpoint every 3 steps in a temporary
             directory: ``build(1)``, then 8 steps with a kill-free resize
             to 4 positions at step 3 and a failure down to 2 at step 7
             (rollback to step 6): the state after the reshard and after
             the restore equal, gathered whole, to the state before and to
             the saved one, bit for bit; the step graphed
             (``jit_train_step(..., graphed=None)`` on the one card), a
             capture after the build and after each reconfiguration, its
             seconds beside ``reconfig_s``; 9 log rows; step 6's replay
             within phase 8's loss bound of its first run; the loss
             falling.  Prints each reconfiguration's seconds, the
             checkpoint's bytes, a save's snapshot and write seconds, the
             median step wall at 1, 4 and 2 positions.  Then
             ``launch.train.main`` (``--plan --cluster H100:8``, 3 steps at
             the train cell's shape): a valid plan and finite losses.
             Every step's launches counted (``launches_elastic``); phase 3
             holds the local shapes (``elastic_*``, ``pipe_*``).
   manager   Sailor's control plane (``manager/``, ``telemetry/``) driving
             the runtime.  (a) ``manager.Controller`` (availability
             monitor, incremental replanner, transition model,
             ``hysteresis_s`` 120) over an ``ElasticTrainer`` as the
             ``elastic_reconfig`` example builds it at its defaults
             (``controller`` and ``report``, what its ``main`` runs):
             smollm-360M at its published widths and depth on
             ``[cuda:0] * 8``, the example's seeded availability trace
             over an 8-device zone, a step every 60 trace seconds, 60
             steps of 8 x 32 tokens, a checkpoint every 8, with an audit
             file and a telemetry bus.  The decisions (without the rows
             the wall clock decides: straggler flags and the bus's
             detector events) and the reconfigurations (kind, devices, step,
             resumed at) must be the reference controller's on this trace
             (``MANAGER_OUTCOMES``, ``MANAGER_RECONFIGS``, pinned on the
             CPU by ``tests/test_torch_examples_run.py``), every loss is
             finite, one ``step_time`` a step on the sim clock, the audit
             file equals the decision log, and every runtime plan is one
             of phase 3's ``examples_elastic_*`` shapes.  Prints the
             example's report, each decision (event, action, reason,
             search ms, cache), each priced transition beside the
             measured ``reconfig_s`` and its new step's capture (a
             rollback's priced restore, setup and lost work beside its
             measured replay), ``_state_bytes()`` beside the checkpoint's
             bytes, and the step wall at each position
             count.  (b) telemetry on the pipeline phase's graphed ``[1,
             1]`` pipeline: with a bus and without, from the same weights,
             4 pairs of steps in turns after warm-up and capture (losses,
             graphs and launches a step equal; the walls are the cost of
             the synchronizations); then a ``DetectorBank``, a
             ``RootCauseAnalyzer`` and a 2x compute delay on stage 1 from
             step 14, 20 steps: no anomaly before it, a ``Straggler`` on a
             stage-1 stream within 4 steps, verdict ``slow-chip`` at (1,
             0), the reference's sample counts.  Launches counted over (a)
             and (b) apart (``launches_manager``,
             ``launches_pipeline_telemetry``).
   examples  the user entry points (``repro_torch.examples``), each
             through its ``main`` as ``python -m`` runs it, at its
             defaults on the card: ``geo_cost_planning`` (Sailor against
             DTFM, the budget sweep, spot replans); ``quickstart`` (the
             two plans and the simulator's breakdown, then ``opt-350m``
             at its published widths and depth, untied, bf16, through a
             2-stage ``MPMDPipeline`` at tps ``[4, 2]`` on ``[cuda:0] *
             8``, 3 steps on 2 microbatches of 4 x 2048 tokens, graphed;
             then its ``execute`` eager from the same weights: losses bit
             for bit and falling, the step walls side by side);
             ``train_e2e`` (``demo-100m``, 106.5 M fp32 params, 200
             graphed steps of 8 x 256 tokens through ``ElasticTrainer``,
             a checkpoint every 50, tok/s, then a fresh trainer resumes
             at the latest checkpoint and its 3 losses equal the first
             trainer's bit for bit); ``serve_batched`` (the serving plan,
             then ``ContinuousBatchingServer`` at its decode batch on
             qwen1.5-0.5B at published widths, graphed; then its
             ``serve_locally`` on an eager server: tokens and
             ``ServerStats`` equal).  ``elastic_reconfig``'s control loop
             runs once, in [manager] (a).  Each example's figures, host
             seconds and launches; the launches over the phase against
             the count their figures give (``launches_examples``); phase
             3 holds every shape they launch (``examples_*``).
   autotune  the block autotuner (``kernels/autotune.py``): each of its
             four tuners at the calibrate grid's held-out shapes
             (``AUTOTUNE_SHAPES``), bf16 and fp32, from an empty cache and
             again from a second one (the same winner or not), every
             candidate's ms, the winner's output against its plain
             version at that tile, its time against the default tile's
             (``vs_default``); then ``calibrate_kernels(autotune_blocks=
             True)`` into a temporary cache directory and that table's
             held-out error (tuned kernels measured) beside phase 6's
             untuned table's (``launches_autotune``).
   moe serve the MoE family at published widths, 2 layers, bf16, seeded
             weights, through ``BatchedServer`` graphed (after two warm
             runs of the same requests, so the timed run replays every
             graph) and eager, tokens equal: dbrx-132b (16 experts, top-4) on
             phase 5's requests; mixtral-8x22b (8 experts, top-2, window
             4096) on 2 prompts of 4608 tokens and 32 new (the prefill
             runs ``attn_window_linear``, the cache the 4096-slot ring),
             its prefill logits against ``attention(impl="naive",
             window=4096)`` with the plain norm (``LOGITS_TOL``).  tok/s
             and the prefill kernels' launches of each run
             (``launches_moe_serve``: the servers' alone, not the logit
             checks').
   moe train dbrx-132b at published widths, 1 layer, bf16, full remat, 4 x
             1024 tokens in one microbatch, AdamW: 3 eager steps, then
             the graphed step from the same seeded weights on the same
             batches (one model at a time), losses bit for bit; the loss
             falling over 8 graphed steps on one batch; 3 timed (wall,
             device ms, tokens/s), peaks, one profiled
             (``[profile] moe_train_step``; ``launches_moe_train``).
   moe pipeline  ``MPMDPipeline(family="moe")`` at dbrx's widths with 2
             layers, 4 experts, top-2 (``MOE_PIPE_CUT``), untied, 2
             microbatches of 2 x 1024 tokens: ``[1, 1]`` eager then
             graphed (losses bit for bit), ``[2, 1]`` eager (stage 0 a (1, 2) mesh: 2 experts a
             position, expert parallel); each first loss against the
             one-device ``loss_and_grads``, step walls, resident bytes a
             position (``launches_moe_pipeline``: the pipelines' alone,
             not the one-device check's).  Phase 3 holds the
             MoE paths' attention and norm shapes (``moe_*``).
   ssm serve mamba2-130m at published widths and all 24 layers, bf16,
             seeded weights: ``BatchedServer`` on [serve]'s 16 requests,
             graphed and eager after a warm run, equal tokens,
             ``steady_tok_s``; the SSD kernel (the prefill's ``"kernel"``
             route) 24 launches a prefill, nothing else.  Then an fp32
             copy of the weights prefills (2, 2048) through the
             ``"kernel"`` and the ``"chunked"`` route: last-position
             logits within ``ROUTE_TOL``, final SSM states within
             ``ROUTE_STATE_TOL``.
   hybrid serve  zamba2-2.7b at published widths and all 54 layers
             (2.42 B params, bf16): the same 16 requests, graphed and
             eager, equal tokens; the SSD kernel 54 and the attention
             kernel 9 (the shared block's applications) launches a
             prefill.  An fp32 (1, 1024) prefill at 12 layers (two
             groups) through both SSD routes, logits within ``ROUTE_TOL``.
   ssm train mamba2-130m at 24 layers on 8 x 1024 tokens in 2
             microbatches, then zamba2-2.7b at 12 layers on 4 x 1024:
             eager and graphed steps from the same weights on the same
             batches (losses equal bit for bit), finite loss
             and gradient norm over 3 steps at the published init,
             ``step_wall_ms``, ``step_device_ms``, ``tokens_per_s`` and
             peak memory.  The train path takes the differentiable
             ``"chunked"`` SSD: the SSD kernel launches 0 times, by
             design; zamba2's shared block runs the attention kernel
             forward and backward at head dim 80.  Phase 3 holds the
             SSD kernel at both families' prefill shapes and the
             attention kernel at the hybrid's (``ssm_*``, ``hybrid_*``),
             timed at (2, 1024, 80, 64, 64) and (2, 1024, 32/32, 80)
             (``more``), and checks that ``ops.ssd_scan``, ``ops.rmsnorm``
             and ``ops.add`` raise on the card where a gradient would be
             taken.
   ssm mesh  the sharded (data, model) train step of the state-space
             families (``dist/spmd_ssm.py``), eager, bf16, full remat, on
             [ssm train]'s data, optimizer and seed-0 weights, every
             position on ``cuda:0``: mamba2-130m (24 layers) on (2, 2)
             ``fsdp_tp`` and (1, 4) ``tp``, zamba2-2.7b (12 layers) on
             (1, 2) ``tp``.  For each: every position's resident bytes
             beside ``params / tp``; the first step's loss and gradients
             against the one-device ``loss_and_grads`` ([mesh]'s bounds,
             or twice the one-device bf16 step's own distance from fp32
             where that is larger); the forward without a gradient, whose
             SSD kernel launches once a layer on every position (96 for
             mamba2, 24 and 4 attention launches for zamba2), its logits
             against one device's; 3 eager steps timed (median wall and
             device ms), replicas bit for bit, one profiled
             (``[profile] ssm_mesh_step_*``); mamba2 on (2, 2) and zamba2
             5 steps, a graphed side beside them in turns (a warm call,
             the capture, 3 replays bit for bit with eager, timed,
             profiled: ``ssm_mesh_step_graphed_*``); the launches on a
             ``launches_ssm_mesh`` line.  Then both families in fp32 at 2
             layers on (2, 2) against ``make_train_step`` (loss, gradients
             and one step within 1e-3).  Phase 3 holds the positions'
             and the one-device references' SSD and attention shapes
             (``ssm_mesh_*``) and times the SSD at mamba2's tp-4 position,
             (4, 1024, 6, 64, 128).
   vlm serve internvl2-26b at published widths and all 48 layers (19.86
             B params, bf16), 256 zero patches before each prompt as the
             reference's server gives them: [serve]'s 16 requests,
             graphed and eager after a warm run, equal tokens,
             ``steady_tok_s``; the attention kernel and the fused norm
             48 launches each a prefill, nothing else; the first batch's
             prefill and decode steps in turns.  An fp32 prefill at 2
             layers (``VLM_ROUTE_SHAPE`` after the patches): the kernel
             route against chunked attention and the plain norm, logits
             within ``VLM_F32_TOL``.
   encdec serve  whisper-tiny at its published size (4 + 4 layers,
             1500 frames, bf16), zero frames: the same requests graphed
             and eager, equal tokens, 0 kernel launches (its attention is
             naive or chunked by length, as the reference's); the
             first batch in turns; fp32 on the card against the port's
             CPU forward of the same weights (seeded frames): logits, the
             prefill cache and 3 decode steps within ``ENCDEC_F32_TOL``.
   vlm train internvl2-26b at 2 layers (1.92 B params), 4 x 1024
             positions (256 patches, labels masked) in 2 microbatches,
             full remat; whisper-tiny (``encdec train``) at all layers,
             8 x 448 tokens over 1500 frames in 2 microbatches: the
             graphed step against the eager one from the same weights on
             the same batches, losses bit for bit and finite over 3
             steps, step wall and device ms, tokens/s, peaks; internvl2's
             graph launches the attention and fused-norm kernels forward
             2 and backward 1 a layer a microbatch, whisper none.  Phase
             3 holds the attention and norm kernels at the vlm paths'
             shapes (``vlm_*``).
9. plan      Sailor's planner and simulator priced by the card: the
             ``"H100"`` entry fitted as ``measured.calibrate_cpu_host``
             fits it (``measure_block``'s one-layer forward and gradient
             on the reference's all-zero batch as CUDA graphs, their
             replays timed by CUDA events, then ``fit_rate``) at the train
             path's bf16 and seq 1024, then at the reference's own call
             (fp32, seq 128): each point's ms and effective TFLOP/s, the
             fitted rate and its share of the datasheet's, and every
             program's launches of the attention and fused-norm kernels,
             forward and backward.  ``simulate`` of the graphed train
             step's shape on one H100 (``homogeneous_plan``, 2
             microbatches of 4) with the datasheet entry, with it and the
             kernel table (``build/kernel-costs-H100.json`` from phase 6),
             and with the fitted entry (also with the table), each beside
             phase 8's graphed step (relative error), and the simulated
             worker peak bytes beside phase 8's peak memory.  ``plan_for``
             (both objectives, global batch 256 of 1024 tokens) on a zone
             of H100 + A100-40 + V100-16 and on H100s and A100s in two
             regions, with the datasheet and then the fitted entry (plan,
             t_iter, $/iteration, search seconds, whether the plan
             changed), and one serving plan (``plan_serving``) on the
             first fleet with the kernel table.  Then, under the bf16 fit:
             ``calibrate_memory`` on the untied model at seq 1024, mbs 1,
             2, 4 (graphed train steps, and the pipeline's two stage
             programs at mbs 4): its coefficients, each point's raw and
             fitted error, and ``simulate``'s worker peak of phase 8's
             step under the fitted and the default memory model; the 7
             baseline planners on the first fleet beside Sailor's plan
             (first valid plan, t_iter, $/iteration); last
             ``calibrate_engine`` at the reference's defaults on the
             untied model in fp32 (its a, b and points, and one of its
             pipeline steps profiled), after which the bf16 fit is
             registered again.  The datasheet entry is
             restored at the end.
10. result   one JSON line of kernel figures, the card line, then
             ``{"ok": true, "device": {...}}`` as the last line.  The
             attention entry also carries its share of the bound, its
             TFLOP/s, the CUDA-core kernel's time on the same inputs
             (``earlier_ms``) and the same four figures at the calibrate
             shape (``calibrate``); the norm entries their plan, share of
             the bound and the 16384-row case (``rows16384``).

Each of phases 5-9 (serve continuous, pipeline, its mesh stages, mesh,
dryrun's real steps, serve mesh, mesh families, elastic, manager's two paths, examples, autotune, the three MoE, the four
state-space and the four stubbed-frontend phases too) is
a main path: the launch
counts are set to 0 just before it and read just after, and each kernel
must have launched on the path that runs it.  Phase 3 also holds the two backward kernels
(attention, fused add + RMSNorm) against their plain versions on the
train path's shapes and edge cases, each run twice and compared bit for
bit, timed beside the backward of ``F.scaled_dot_product_attention`` for
attention.  The bf16 attention backward runs the tensor-core kernels and
is timed beside the CUDA-core ones on the same inputs (``earlier_ms``,
also held against their plain version) and at each pair of blocks
(``blocks_ms``); the fp32 one (CUDA-core kernels) at each pair of blocks
too, at the train shape and at the plan phase's (4, 128) fit shape, and,
where the parent commit's tree is unpacked at ``build/parent``
(``git archive``), beside that tree's fp32 backward on the same inputs
(``earlier_ms``: ``bench/attention_ablations.py --f32-bwd-default-only``
run with the parent's ``src`` first on ``PYTHONPATH``; null without it).

Without a CUDA device, or run outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.bench import kernels_bench  # noqa: E402
from repro_torch.bench.serve_runs import DecodeClock  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster import (heterogeneous_zone,  # noqa: E402
                                      multi_zone, single_zone)
from repro_torch.core.planner.objectives import (MAX_THROUGHPUT,  # noqa: E402
                                                 MIN_COST, Objective,
                                                 ServingObjective)
from repro_torch.core.planner.plan import homogeneous_plan  # noqa: E402
from repro_torch.core.planner.search import SailorPlanner, plan_for  # noqa: E402
from repro_torch.core.planner.serving import plan_serving  # noqa: E402
from repro_torch.core.profiler import kernel_costs  # noqa: E402
from repro_torch.core.profiler import measured  # noqa: E402
from repro_torch.core.profiler.analytic import (JobProfile, ServeJob,  # noqa: E402
                                                TrainJob)
from repro_torch.core.profiler.hw_specs import (ACCELERATORS,  # noqa: E402
                                                get_accelerator)
from repro_torch.core.simulator.simulate import simulate  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import add as add_mod  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused as fused_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve import kv_cache, serve_step  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatchingServer,  # noqa: E402
                                         ServerStats, _next_pow2)
from repro_torch.serve.serve_step import BatchedServer, Request  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as train_lib  # noqa: E402

# the card's HBM rate and dense bf16 tensor-core rate from the port's
# catalog; float32 outside the tensor cores from the H100 SXM data sheet.
# Every bound is the SXM's, the card this script is run on; phase_card
# says so where the card is another.
H100 = get_accelerator("H100")
PEAK_FLOPS = {torch.bfloat16: H100.peak_flops, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py
SOURCES = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:51"),
    "fused_add_rmsnorm": dict(
        source="src/repro_torch/csrc/fused_add_rmsnorm.cu",
        replaces="src/repro/kernels/fused.py:31"),
    "flash_attention_decode": dict(
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:164"),
    "rmsnorm": dict(
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:34"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd.py:33"),
    "add": dict(
        source="src/repro_torch/csrc/add.cu",
        replaces="benchmarks/kernels_bench.py:116"),
    # the backward of the Pallas kernel named (the reference has none)
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:51"),
    "fused_add_rmsnorm_bwd": dict(
        source="src/repro_torch/csrc/fused_add_rmsnorm_bwd.cu",
        replaces="src/repro/kernels/fused.py:31"),
}
SERVE_KERNELS = ("flash_attention", "fused_add_rmsnorm")
CALIBRATE_KERNELS = ("flash_attention", "fused_add_rmsnorm",
                     "flash_attention_decode", "rmsnorm", "ssd_scan")
FUSED_KERNELS = ("fused_add_rmsnorm", "rmsnorm", "add")
SSD_TOL = {torch.bfloat16: (4e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
# backward kernels vs their plain versions: max |kernel - plain| over max
# |plain| (both sum in fp32 in other orders; bf16 outputs round once)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
TRAIN_KERNELS = ("flash_attention", "fused_add_rmsnorm",
                 "flash_attention_bwd", "fused_add_rmsnorm_bwd")
# calibration grids at smollm-360M's widths: 120 = 8 rows x 15 heads,
# d_model 960; SSD at mamba2-130m's (24 heads, P 64, N 128)
CAL_GRID = dict(
    attn_shapes=((120, 256, 64), (120, 512, 64), (120, 1024, 64),
                 (120, 2048, 64)),
    decode_shapes=((120, 256, 64), (120, 1024, 64), (120, 4096, 64)),
    norm_shapes=((8, 960), (512, 960), (4096, 960), (16384, 960)),
    ssd_shapes=((1, 512, 24, 64, 128), (4, 2048, 24, 64, 128)))
HELD_OUT = [("flash_attention", (120, 384, 384, 64, 1)),
            ("flash_attention", (120, 768, 768, 64, 1)),
            ("flash_decode", (120, 549, 64)), ("flash_decode", (120, 2048, 64)),
            ("rmsnorm", (1024, 960)), ("rmsnorm", (8192, 960)),
            ("ssd_scan", (2, 1024, 24, 64, 128))]
# serve phase (smollm-360M, published widths)
ARCH = "smollm_360m"
N_REQUESTS, BATCH, MAX_NEW = 16, 8, 32
PROMPT_MIN, PROMPT_MAX = 256, 509
# Last-token logits, kernel path vs plain path (naive attention + unfused
# norm), bf16 through 32 layers.  The two paths round at different places
# (the kernel keeps P to ~16 bits, two bf16 parts, for P V and normalises
# the fp32 sum; the plain path casts P and y to bf16 first), each a
# relative 2^-9 per rounding, compounding through the residual stream.  Logits of these
# random weights have a spread of ~0.6; 0.1 allows ~1/6 of that and is
# what a real indexing or masking fault (O(1) errors) cannot pass.
LOGITS_TOL = 0.1
DECODE_PAIRS = 16       # single decode steps timed in turns, graphed and eager
PREFILL_PAIRS = 5       # prefills timed in turns, graphed and eager
# continuous phase (smollm-360M, published widths and depth): every prompt
# buckets to 512, so max_ctx 512 + 64; 224 pages of 16 tokens hold fewer
# than eight full rows (36 pages each), so the policy must preempt
CB_REQUESTS, CB_SLOTS, CB_CTX, CB_PAGE, CB_PAGES = 32, 8, 576, 16, 224
CB_NEW = (8, 64)        # max_new_tokens spread over this range
DECODE_PROFILED = 8     # decode steps in each decode profile window
SMALL_FP32_TOL = 1e-4   # fp32, 2 layers: kernel path vs plain path
# train phase (smollm-360M, published widths and depth, bf16)
TRAIN_DATA = dict(seq_len=1024, global_batch=8, num_microbatches=2)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)
TRAIN_STEPS, TRAIN_TIMED = 8, 3
# graphed vs eager: steps compared one by one (warm-up, capture, replay),
# then pairs of steps timed in turns
TRAIN_GRAPH_STEPS, TRAIN_PAIRS = 3, 4
# One microbatch's loss and gradients, kernel path vs plain path, full width
# in bf16 through 32 layers.  The paths round at different places (the
# kernels keep P to ~16 bits and take every backward sum in fp32 with one
# cast; the plain path's autograd rounds each op's output to bf16), a
# relative 2^-9 a rounding, compounding through 32 layers of the backward.
# A gradient leaf must agree to 10% of its max |g| and in direction
# (cosine >= 0.99): a wrong index, mask or missing term gives O(1) errors
# and cosines far below that.  The fp32 2-layer check holds 1e-4 of max |g|.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_COSINE = 2e-2, 0.1, 0.99
# [dryrun]'s chunked loss on the (2, 2) mesh: sequence positions a chunk
DRYRUN_CHUNK = 256
# plan phase: calibrate_cpu_host at the train path's dtype and length, then
# at the reference's own call (fp32, seq 128); each measure_block program
# runs once eagerly, then as a graph: one warm-up and 3 timed replays
# (measured._replay_time's defaults)
PLAN_FITS = (("bf16_seq1024", dict(seq_len=TRAIN_DATA["seq_len"],
                                   dtype="bfloat16")),
             ("fp32_seq128", dict(seq_len=128, dtype="float32")))
BLOCK_MBS, BLOCK_CALLS = (1, 2, 4), 1 + 1 + 3
PLAN_BWD_TIMED = "plan_float32_s128_b4"   # plan_shapes()' label
PLAN_ZONE = "us-central1-a"
PLAN_GLOBAL_BATCH = 256     # sequences of TRAIN_DATA["seq_len"] a step
PLAN_FLEETS = {
    "hetero_zone": heterogeneous_zone({"H100": 8, "A100-40": 8,
                                       "V100-16": 16}, zone=PLAN_ZONE),
    "geo": multi_zone({PLAN_ZONE: ("us-central1", {"H100": 8}),
                       "europe-west4-a": ("europe-west4", {"A100-40": 8})}),
}
PLAN_SERVE = dict(prompt_len=512, max_new_tokens=64, decode_batch=BATCH,
                  arrival_rps=4.0)
PLAN_SLO = dict(slo_ttft_p99_s=2.0, slo_tpot_p99_s=0.2)
# plan phase, after the comparisons above: the memory fit over the train
# cell's shape (graphed train steps at mbs 1, 2, 4 of 2 microbatches, the
# pipeline's two stage programs at mbs 4); the 7 baselines on the one-zone
# fleet under the fitted H100 (metis capped at PLAN_METIS_CAP_S); then the
# engine fit at the reference's defaults on the untied model in fp32 (the
# dtype its rate is fitted in), which re-registers "H100": run last
PLAN_MEM_MBS = (1, 2, 4)
PLAN_ENGINE_SEQ = 32        # calibrate_engine's default seq_len
PLAN_METIS_CAP_S = 5.0
# pipeline phase: smollm-360M at its published widths and depth, bf16,
# untied (the reference's own cut for the pipeline), two stages of 16
# layers on the one card, [train]'s data and optimizer
PIPE_STEPS = 2          # graphed vs eager from the same weights, compared
PIPE_LEARN = 4          # steps on one repeated batch: the loss must fall
PIPE_PAIRS = 3          # pairs of steps timed in turns, graphed and eager
PIPE_GROUP_STEPS = 4    # AdaptiveDPGroup, fp32 2 layers: 2:1 vs uniform
PIPE_GROUP_TOL = 1e-3
# mesh phase: smollm-360M at its published widths and depth, bf16, full
# remat, [train]'s data, optimizer and weights (seed 0); each mesh's
# positions all on cuda:0, driven by one process in lockstep
MESH_CASES = (("fsdp_tp", (2, 2)), ("tp", (1, 5)))
MESH_LEARN = 2          # steps on one repeated batch: the loss must fall
MESH_TIMED = 3          # pairs of steps timed in turns, graphed and eager
MESH_SMALL_STEPS = 3    # fp32 2 layers on (2, 2) against make_train_step
# pipeline phase, mesh stages: even_stages(cfg, [2, 1]), stage 0 on a
# (1, 2) fsdp_tp mesh, three positions all on cuda:0, graphed and eager
# from the same weights in turns; fp32 2-layer
# checks on [2, 1] and on [1, 1] at dp 2
PIPE_MESH_TPS, PIPE_MESH_POLICY = (2, 1), "fsdp_tp"
PIPE_MESH_TIMED = 3     # pairs timed in turns, graphed and eager; then
#                         the [1, 1]'s eager steps
PIPE_MESH_SMALL = (((2, 1), 1), ((1, 1), 2))      # (tps, dp)
# their params after the first AdamW step (lr 1e-3), of max(1, |p|): that
# step moves element i by lr g_i / (|g_i| + eps), so a gradient that sits
# near eps (1e-8) moves by up to ~2 lr whatever the summation order did
# to it; the mesh stages sum over positions in another order (their
# gradients are held at SMALL_FP32_TOL of max |g|)
PIPE_MESH_PARAMS_TOL = 2e-3
# elastic phase: the train cell (tied, bf16, full remat) through
# ElasticTrainer on [cuda:0] * 4: build(1), then 8 steps with a kill-free
# resize to 4 positions at step 3 and a failure down to 2 at step 7 that
# rolls back to the step-6 checkpoint
ELASTIC_DEVICES = (1, 4, 2)
ELASTIC_STEPS, ELASTIC_EVERY = 8, 3
ELASTIC_EVENTS = ((3, 4, False), (7, 2, True))
ELASTIC_LAUNCH_STEPS = 3    # launch.train --plan on the one card
# manager phase (a): Sailor's controller over an ElasticTrainer as the
# elastic_reconfig example builds it at its defaults: smollm-360M at its
# published widths on [cuda:0] * 8, the example's seeded availability
# trace, 60 steps of 8 x 32 tokens, a checkpoint every 8.  The decisions
# (without straggler rows) and the reconfigurations (kind, devices, step,
# resumed at) are the reference Controller's on that trace
# (tests/test_torch_examples_run.py pins them on a stub trainer).
MANAGER_OUTCOMES = (
    "start", "rollback", "defer", "defer", "reshard", "defer", "defer",
    "defer", "defer", "rollback", "defer", "defer", "rollback", "defer",
    "defer", "reshard", "defer", "defer", "reshard", "reshard", "defer",
    "reshard", "rollback", "defer", "defer", "reshard", "defer", "defer",
    "reshard", "rollback", "defer", "defer", "defer", "defer", "defer",
    "defer", "defer", "defer")
MANAGER_RECONFIGS = (
    ("rollback", 2, 2, 0), ("kill-free", 4, 4, 4), ("rollback", 2, 10, 8),
    ("rollback", 1, 15, 8), ("kill-free", 2, 11, 11),
    ("kill-free", 4, 16, 16), ("kill-free", 2, 17, 17),
    ("kill-free", 4, 21, 21), ("rollback", 1, 23, 16),
    ("kill-free", 2, 19, 19), ("kill-free", 4, 23, 23),
    ("rollback", 1, 26, 24))
MANAGER_DP = (1, 2, 4, 8)   # runtime plans' dp; phase 3's examples_elastic_*
# manager phase (b): [pipeline]'s graphed [1, 1] pipeline, pairs of steps
# detached and attached (no fault) in turns; then the bus with the
# detectors and RCA, a compute delay on stage 1 from step 14 (after the
# detectors' warm-up of 12), 20 steps
TEL_STEPS, TEL_FAULT_STEP, TEL_FAULT_FACTOR = 20, 14, 2.0
TEL_DETECT_WITHIN = 4       # steps from the fault to its Straggler
TEL_PAIRS = 4

# [examples]: the five user entry points at their defaults; quickstart's
# stages at the reference's rule on 8 positions (the plan's pp 2): tp 4, 2
EXAMPLES_TPS = [4, 2]
EXAMPLES_KERNELS = ("flash_attention", "fused_add_rmsnorm",
                    "flash_attention_bwd", "fused_add_rmsnorm_bwd")


# [autotune]: each tuner at the [calibrate] grid's held-out shapes (HELD_OUT;
# the fused norm at the RMSNorm's rows), bf16 and fp32
AUTOTUNE_SHAPES = [(op, shape) for op, shape in HELD_OUT
                   if op != "flash_decode"] + [
    ("fused_add_rmsnorm", shape) for op, shape in HELD_OUT
    if op == "rmsnorm"]
AUTOTUNE_ITERS = 10
# the MoE family at published widths (dbrx-132b: hf:databricks/dbrx-base;
# mixtral-8x22b: arXiv:2401.04088), cut in depth only
MOE_SERVE_LAYERS = 2
MIXTRAL_PROMPT, MIXTRAL_ROWS, MIXTRAL_NEW = 4608, 2, 32
# mixtral's fp32 prefill logits (spread ~1), window-linear + fused kernel vs
# naive + plain norm: the same fp32 terms summed in other orders through 2
# layers of width 6144 (~1e-6 relative each); a masking or indexing fault
# gives O(1) errors
MIXTRAL_F32_TOL = 1e-3
MOE_TRAIN_LAYERS = 1
# one microbatch of 4 x 1024: its bf16 gradients feed AdamW with no fp32
# sum beside them (train_step.loss_and_grads_on_device); two microbatches'
# 18 GB of fp32 sums do not fit beside 4.49 B params' AdamW state
MOE_TRAIN_DATA = dict(seq_len=1024, global_batch=4, num_microbatches=1)
MOE_PIPE_DATA = dict(seq_len=1024, global_batch=4, num_microbatches=2)
MOE_GRAPH_STEPS, MOE_FALL_STEPS, MOE_TIMED = 3, 8, 3
# [moe pipeline]: dbrx's widths with the reference's reduced() expert counts
MOE_PIPE_CUT = dict(n_layers=2, n_experts=4, top_k=2)
MOE_PIPE_STEPS, MOE_PIPE_TIMED = 3, 3
# the state-space phases ([ssm serve], [hybrid serve], [ssm train])
SSM_ARCH, HYBRID_ARCH = "mamba2_130m", "zamba2_2_7b"
# fp32 prefills through the SSD kernel and through ssd_chunked: the same
# fp32 terms summed in other orders through every layer; a chunking or
# indexing fault gives O(1) errors
ROUTE_TOL, ROUTE_STATE_TOL = 1e-3, 1e-4
SSM_ROUTE_SHAPE = (2, 2048)
HYBRID_ROUTE_SHAPE, HYBRID_ROUTE_LAYERS = (1, 1024), 12
SSM_TRAIN_DATA = dict(seq_len=1024, global_batch=8, num_microbatches=2)
HYBRID_TRAIN_DATA = dict(seq_len=1024, global_batch=4, num_microbatches=2)
HYBRID_TRAIN_LAYERS = 12     # two applications of the shared block
SSM_TRAIN_STEPS = 3
SSM_TIMED = 3           # graphed replays timed after the compared steps
# [ssm mesh]: the sharded (data, model) train step of the state-space
# families (dist/spmd_ssm.py), eager, full remat, bf16, each mesh's
# positions all on cuda:0, on [ssm train]'s data, optimizer and seed-0
# weights: mamba2-130m at all 24 layers, zamba2-2.7b at HYBRID_TRAIN_LAYERS
SSM_MESH_CASES = ((SSM_ARCH, "fsdp_tp", (2, 2)), (SSM_ARCH, "tp", (1, 4)),
                  (HYBRID_ARCH, "tp", (1, 2)))
SSM_MESH_TIMED = 3      # eager steps timed (median)
# the family meshes whose step also runs graphed beside eager
# (jit_train_step(graphed=True)), in turns from the same weights on the
# same batches: a warm call, the capture, then GRAPHED_REPLAYS replays,
# each step held bit for bit (in [ssm mesh] and [mesh families])
GRAPHED_REPLAYS = 3
GRAPHED_STEPS = 2 + GRAPHED_REPLAYS
# the first step's gradients and the forward's logits against one device:
# the mesh sums 'model' partial products in bf16 (as GSPMD's all-reduce of
# a bf16 product does), one device rounds the whole product once, and the
# SSD's bf16 rounding compounds over 24 layers; so beside [mesh]'s bounds
# (TRAIN_GRAD_TOL and TRAIN_COSINE, LOGITS_TOL) each is also allowed twice
# the one-device bf16 step's own distance from the same step in fp32 (the
# same weights cast up)
# then fp32, 2 layers at published widths (zamba2's shared block every 2,
# as in its reduced config), on (2, 2) fsdp_tp against make_train_step:
# the loss, the gradients (of max |g|) and the params after one step (of
# max(1, |p|)) within SSM_MESH_F32_TOL, but a param whose gradient is near
# zero (at most 1e-4 of its leaf's max), which AdamW's first step moves by
# lr g / (|g| + eps) in (-lr, lr) whatever the summation order: 2 lr
SSM_MESH_SMALL_DATA = dict(seq_len=256, global_batch=4, num_microbatches=2)
SSM_MESH_F32_TOL = 1e-3
# [serve mesh]: the sharded prefill and decode step (serve_step.make_prefill
# and make_decode with a mesh; dist/spmd_serve.py), eager, bf16, every
# position on cuda:0, seed-0 weights at published widths: smollm-360M at
# all 32 layers on MESH_CASES' meshes (8 prompts of 512, grow_cache to 576,
# 32 greedy steps), then (arch, layers, policy, mesh, rows, prompt, steps)
# at the depth each serve phase uses (mixtral's prompt past its window)
SERVE_MESH_ROWS, SERVE_MESH_PROMPT, SERVE_MESH_LEN = 8, 512, 576
SERVE_MESH_STEPS = 32
SERVE_MESH_OTHERS = (
    ("dbrx_132b", MOE_SERVE_LAYERS, "tp", (1, 2), 4, 512, 8),
    ("mixtral_8x22b", MOE_SERVE_LAYERS, "tp", (1, 2), MIXTRAL_ROWS,
     MIXTRAL_PROMPT, 8),
    (SSM_ARCH, 24, "tp", (1, 4), 4, 512, 8),
    (HYBRID_ARCH, HYBRID_TRAIN_LAYERS, "tp", (1, 2), 4, 512, 8))
# each step's logits against one device's: the mesh sums 'model' partial
# products in bf16 and splits the decode's softmax by slots, one device
# rounds each product once; so beside LOGITS_TOL each is allowed twice
# the one-device bf16 run's own largest distance from the same run in
# fp32 (the same weights cast up, fed the same tokens)
# the stubbed-frontend phases ([vlm serve], [encdec serve], [vlm train],
# [encdec train]): internvl2-26b (arXiv:2404.16821) and whisper-tiny
# (arXiv:2212.04356) at published widths, zero patches or frames served
VLM_ARCH, ENCDEC_ARCH = "internvl2_26b", "whisper_tiny"
# internvl2's fp32 prefill logits, the kernel route (attention kernel and
# fused norm) against the chunked attention and plain norm, 2 layers
VLM_ROUTE_LAYERS, VLM_ROUTE_SHAPE = 2, (2, 512)
VLM_F32_TOL = MIXTRAL_F32_TOL
# whisper fp32 on the card against the port's CPU forward of the same
# weights: logits, the prefill cache and 3 decode steps
ENCDEC_F32_TOL, ENCDEC_CHECK_SHAPE, ENCDEC_CHECK_STEPS = 1e-4, (2, 64), 3
VLM_TRAIN_LAYERS = 2    # 1.92 B params: their AdamW state fits beside them
VLM_TRAIN_DATA = dict(seq_len=1024, global_batch=4, num_microbatches=2)
ENCDEC_TRAIN_DATA = dict(seq_len=448, global_batch=8, num_microbatches=2)
# [mesh families]: the stubbed-frontend families through the sharded train
# step and serving on a mesh (dist/spmd_encdec.py, the vlm's patches in
# dist/spmd.forward), eager, bf16, full remat, every position on cuda:0,
# seed-0 weights at published widths: (arch, layers (None: all), policy,
# mesh, train, serve).  whisper-tiny whole (4 + 4 layers, 1500 frames):
# on (1, 4) its 6 heads do not divide, so attention is replicated and
# only 'ff' splits; internvl2-26b at VLM_TRAIN_LAYERS (256 patches)
FAMILY_MESH_CASES = (
    (ENCDEC_ARCH, None, "fsdp_tp", (2, 2), True, True),
    (ENCDEC_ARCH, None, "tp", (1, 4), True, True),
    (VLM_ARCH, VLM_TRAIN_LAYERS, "fsdp_tp", (2, 2), True, False),
    (VLM_ARCH, VLM_TRAIN_LAYERS, "tp", (1, 2), False, True))
FAMILY_MESH_STEPS = 3   # eager steps after the first compared (one recorded)
# the family meshes graphed beside eager: (arch, mesh) of [ssm mesh] and
# [mesh families]
GRAPHED_FAMILY_MESHES = {(SSM_ARCH, (2, 2)), (HYBRID_ARCH, (1, 2)),
                         (ENCDEC_ARCH, (2, 2)), (VLM_ARCH, (2, 2))}
# families whose graphed side runs after the eager one, not in turns:
# internvl2 at 2 layers holds 31.3 GB of params and AdamW state on (2, 2)
# (7.83 GB a position), and two copies with their fp32 gradient sums and
# the graph's pool do not fit in 80 GB
GRAPHED_APART = ("vlm",)
# serving: (rows, text tokens, decode steps); the train data are [encdec
# train]'s and [vlm train]'s; the first step's gradients and each served
# step's logits are held to one device's as [ssm mesh] and [serve mesh]
# hold theirs (TRAIN_GRAD_TOL, TRAIN_COSINE, LOGITS_TOL, or twice the
# one-device bf16 run's own distance from the same run in fp32)
FAMILY_MESH_SERVE = {ENCDEC_ARCH: (8, 448, 8), VLM_ARCH: (4, 512, 8)}


def log(msg: str) -> None:
    print(msg, flush=True)


# --- timing ------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Median device ms of one call, each from a cold L2: the timer the
    cost table is built with (``kernels.autotune.bench_time``), so the
    kernel line and the table read the same clock."""
    return at.bench_time(fn, iters=iters, device="cuda") * 1e3


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / H100.mem_bw
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                dtype: torch.dtype, tol: float = None) -> float:
    tol = TOL[dtype] if tol is None else tol
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{err.max().item():.3e} exceeds {tol}")
    return err.max().item()


# --- phases ------------------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] nvidia-smi name, power.limit:")
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    chip = at.default_chip("cuda")
    log("[card] " + json.dumps(dict(
        name=torch.cuda.get_device_name(0), default_chip=chip,
        bounds_from=dict(entry=H100.name, card=at.H100_SXM_NAME,
                         mem_bw=H100.mem_bw, bf16_flops=H100.peak_flops,
                         fp32_flops=PEAK_FLOPS[torch.float32]))))
    if chip != "H100":
        log(f"[card] this card is not the H100 SXM ({at.H100_SXM_NAME}): "
            f"every bound below is the SXM's data sheet, not this card's; "
            f"its kernel-cost table is keyed {chip!r}, and the catalog "
            f"holds no entry for it to fit in [plan]")
    return smi


def ptxas_report(log: str):
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def _wgmma_kernel_name(mangled: str):
    """(D, block_q) of a flash_fwd_wgmma<D, warpgroups> instantiation, or
    None for another kernel."""
    m = re.search(r"flash_fwd_wgmmaILi(\d+)ELi(\d+)E", mangled)
    return (int(m.group(1)), 64 * int(m.group(2))) if m else None


def _cuda_core_kernel_name(mangled: str):
    """(dtype code, D, block_q) of a flash_fwd<T, D, block_q>
    instantiation (dtype 0 float32, 1 bfloat16), or None for another
    kernel."""
    m = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
    if not m:
        return None
    return (0 if m.group(1) == "f" else 1, int(m.group(2)), int(m.group(3)))


def _decode_kernel_name(mangled: str) -> str:
    """decode_split<bf16, D 64, heads 1> from its mangled name."""
    dt = "bf16" if "__nv_bfloat16" in mangled else "f32"
    m = re.search(r"decode_split.*?Li(\d+)ELi(\d+)E", mangled)
    if m:
        return f"decode_split<{dt}, D {m.group(1)}, heads {m.group(2)}>"
    return f"decode_merge<{dt}>" if "decode_merge" in mangled else mangled


def _bwd_wgmma_name(mangled: str):
    """(kernel, D, block) of a bwd_dq_wgmma / bwd_dkdv_wgmma<D, warpgroups>
    instantiation, or None for another kernel."""
    m = re.search(r"(bwd_dq_wgmma|bwd_dkdv_wgmma)ILi(\d+)ELi(\d+)E", mangled)
    return (m.group(1), int(m.group(2)), 64 * int(m.group(3))) if m else None


def _bwd_cuda_core_name(mangled: str):
    """(kernel, dtype code, D, block) of a CUDA-core bwd_dq / bwd_dkdv<T,
    D, block> instantiation (dtype 0 float32, 1 bfloat16), or None."""
    m = re.search(r"(bwd_dkdv|bwd_dq)I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                  mangled)
    return ((m.group(1), 0 if m.group(2) == "f" else 1, int(m.group(3)),
             int(m.group(4))) if m else None)


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


_BWD_NORM = re.compile(r"fused_add_rmsnorm_bwdI(f|13__nv_bfloat16)Li(\d+)ELb([01])"
                       r"ELb([01])E")


def _bwd_kernel_name(mangled: str) -> str:
    """bwd_dkdv<bf16, D 64> (or fused_add_rmsnorm_bwd<bf16, 4 values a
    lane, bulk copies>) from its mangled name."""
    dt = "bf16" if "__nv_bfloat16" in mangled else "f32"
    wg = _bwd_wgmma_name(mangled)
    if wg:
        return (f"{wg[0]}<D {wg[1]}, "
                f"block_{'q' if wg[0] == 'bwd_dq_wgmma' else 'k'} {wg[2]}>")
    cc = _bwd_cuda_core_name(mangled)
    if cc:
        return (f"{cc[0]}<{dt}, D {cc[2]}, "
                f"block_{'q' if cc[0] == 'bwd_dq' else 'k'} {cc[3]}>")
    m = _BWD_NORM.search(mangled)
    if m:
        how = ("bulk copies" if m.group(4) == "1" else "16-byte loads"
               if m.group(3) == "1" else "scalar loads")
        return f"fused_add_rmsnorm_bwd<{dt}, {m.group(2)} values a lane, {how}>"
    return mangled


def _bwd_norm_smem(mangled: str) -> str:
    """The dynamic shared memory (the source's own count) of
    ``fused.bwd_plan``'s launch of an instantiation of the fused-norm
    backward at the widest row it takes with one warp (8 warps past
    ``BWD_WARP_VALS`` values a lane), 16384 rows."""
    m = _BWD_NORM.search(mangled)
    es = 4 if m.group(1) == "f" else 2
    vals, vec = int(m.group(2)), m.group(3) == "1"
    wpr = 1 if vals <= fused_mod.BWD_WARP_VALS else rn.WARPS
    d = 32 * vals * (16 // es) * wpr
    bp = fused_mod.bwd_plan(16384, d, es, rn.Plan(vec, vals, wpr), _sms())
    smem = _build.load("fused_add_rmsnorm_bwd").repro_fused_add_rmsnorm_bwd_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    dyn = smem(int(vec), es, d, wpr, bp.rows_per_step, bp.stages, bp.blocks)
    ring = (f"a ring of {bp.stages} stages of {bp.rows_per_step} rows"
            if bp.stages else "register loads")
    return f"{dyn} B dynamic shared memory at d {d} ({ring}), "


def _norm_kernel_name(mangled: str, kernel: str) -> str:
    """rmsnorm<bf16, 4 values a lane, 16-byte loads> (or the same of
    fused_add_rmsnorm) from its mangled name."""
    m = re.search(rf"(?<![a-z_]){kernel}I(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                  mangled)
    if not m:
        return mangled
    return (f"{kernel}<{'f32' if m.group(1) == 'f' else 'bf16'}, "
            f"{m.group(2)} values a lane, "
            f"{'16-byte' if m.group(3) == '1' else 'scalar'} loads>")


SSD_PASSES = ("ssd_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")


def _ssd_build_rows(info) -> None:
    """Registers, dynamic shared memory (at chunk 128, N 128) and spills of
    each pass's kernels."""
    smem = _build.load("ssd_scan").repro_ssd_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    for fn, regs, st, ld in ptxas_report(info["log"]):
        name = next((k for k in SSD_PASSES if k in fn), fn)
        kind = "mma" if "_mma" in fn else "fma" if "_fma" in fn else ""
        which = SSD_PASSES.index(name) + 1 if name in SSD_PASSES else 0
        dyn = smem(which, 1 if kind == "mma" else 0, 128, 128)
        log(f"[build]   {name}{'_' + kind if kind else ''}: {regs} registers, "
            f"{dyn} B dynamic shared memory, spill stores {st} B, spill loads "
            f"{ld} B")


def _norm_build_rows(info, kernel: str, warp_vals: int) -> None:
    """Registers and spills of each instantiation of a norm kernel, and
    the width up to which one warp holds a row (``warp_vals`` 16-byte
    values a lane: ``rmsnorm.WARP_VALS``, ``fused.WARP_VALS``)."""
    rows = ptxas_report(info["log"])
    for fn, regs, st, ld in rows:
        log(f"[build]   {_norm_kernel_name(fn, kernel)}: {regs} registers, "
            f"spill stores {st} B, spill loads {ld} B")
    one = [r for r in rows if f"Li{warp_vals}ELb1E" in r[0]]
    log(f"[build]   {kernel}: one warp a row up to {32 * warp_vals} 16-byte "
        f"values (d <= {256 * warp_vals} bf16, {128 * warp_vals} fp32),"
        f" wider rows 2-{rn.WARPS} warps; the 16-byte instantiations at "
        f"{warp_vals} values a lane: {[r[1] for r in one]} registers, "
        f"{sum(r[2] + r[3] for r in rows)} B spilled in all")


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.FLAGS[1]}, one process per source)")
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.1f}s -> {info['path']}")
        if name == "flash_decode":     # registers and spills of each kernel
            for fn, regs, st, ld in ptxas_report(info["log"]):
                log(f"[build]   {_decode_kernel_name(fn)}: {regs} registers,"
                    f" spill stores {st} B, spill loads {ld} B")
            continue
        if name == "flash_attention":  # and of each instantiation of both
            lib = _build.load(name)
            smem = lib.repro_flash_attention_wgmma_smem
            smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_longlong
            cc_smem = lib.repro_flash_attention_cuda_core_smem
            cc_smem.argtypes = [ctypes.c_int] * 3
            cc_smem.restype = ctypes.c_longlong
            for fn, regs, st, ld in ptxas_report(info["log"]):
                shape = _wgmma_kernel_name(fn)
                cc = _cuda_core_kernel_name(fn)
                if shape is not None:
                    what, dyn = (f"flash_fwd_wgmma<D {shape[0]}, block_q "
                                 f"{shape[1]}>", smem(*shape))
                elif cc is not None:
                    what, dyn = (f"flash_fwd<{('f32', 'bf16')[cc[0]]}, D "
                                 f"{cc[1]}, block_q {cc[2]}>", cc_smem(*cc))
                else:
                    what, dyn = fn, "?"
                log(f"[build]   {what}: {regs} registers, {dyn} B dynamic "
                    f"shared memory, spill stores {st} B, spill loads {ld} B")
            continue
        if name == "ssd_scan":
            _ssd_build_rows(info)
            continue
        if name == "rmsnorm":
            _norm_build_rows(info, name, rn.WARP_VALS)
            continue
        if name == "fused_add_rmsnorm":
            _norm_build_rows(info, name, fused_mod.WARP_VALS)
            continue
        if name in ("flash_attention_bwd", "fused_add_rmsnorm_bwd"):
            smem = None
            if name == "flash_attention_bwd":   # and of each attention kernel
                lib = _build.load(name)
                smem = lib.repro_flash_attention_bwd_wgmma_smem
                smem.argtypes = [ctypes.c_int] * 3
                smem.restype = ctypes.c_longlong
                cc_smem = lib.repro_flash_attention_bwd_cuda_core_smem
                cc_smem.argtypes = [ctypes.c_int] * 4
                cc_smem.restype = ctypes.c_longlong
            for fn, regs, st, ld in ptxas_report(info["log"]):
                wg = _bwd_wgmma_name(fn)
                cc = _bwd_cuda_core_name(fn)
                dyn = (f"{smem(int(wg[0] == 'bwd_dkdv_wgmma'), wg[1], wg[2])}"
                       f" B dynamic shared memory, " if wg
                       else f"{cc_smem(int(cc[0] == 'bwd_dkdv'), *cc[1:])} B "
                       f"dynamic shared memory, " if cc
                       else _bwd_norm_smem(fn) if _BWD_NORM.search(fn)
                       else "")
                log(f"[build]   {_bwd_kernel_name(fn)}: {regs} registers, "
                    f"{dyn}spill stores {st} B, spill loads {ld} B")
            continue
        for line in info["log"].splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _attn_inputs(gen, b, sq, sk, h, kh, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(b, sq, h, d), rnd(b, sk, kh, d), rnd(b, sk, kh, d)


def _sdpa(q, k, v, causal):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)


def attention_case(gen, label, b, sq, sk, h, kh, d, causal, dtype,
                   block_q=None, timed=False, impl=None):
    """One attention case against the plain version of the kernel it runs
    (q's dtype's, or with ``impl="cuda_core"`` the CUDA-core kernel, called
    directly so it counts no wrapper launch)."""
    q, k, v = _attn_inputs(gen, b, sq, sk, h, kh, d, dtype)
    bq = block_q or fa.default_block_q(dtype, impl)
    if impl is None:
        got = ops.flash_attention(q, k, v, causal=causal, block_q=block_q)
    else:
        got = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                      impl=impl)
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                    impl=impl)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {label}", got, want, dtype)
    row = dict(label=label, shape=[b, sq, sk, h, kh, d], causal=causal,
               dtype=str(dtype).replace("torch.", ""),
               kernel=fa.kernel_for(dtype, impl), block_q=bq,
               max_abs_err=err)
    if timed:
        es = q.element_size()
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = es * (2 * b * sq * h * d + 2 * b * sk * kh * d)
        flops = 4.0 * d * pairs * b * h
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, block_q=bq, impl=impl))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, block_q=bq, impl=impl), iters=3)
        row["library_ms"] = time_ms(lambda: _sdpa(q, k, v, causal))
    log(f"[kernels] flash_attention {json.dumps(row)}")
    return row


def fused_case(gen, label, rows, d, dtype, timed=False, offset=None,
               want_vector=None):
    """``offset`` = (input, elements): that input ("x", "res" or "scale")
    starts so many elements into a flat buffer; an offset that is not a
    whole 16 bytes takes the scalar instantiation.  y must be the plain
    version's bit for bit (one fp32 add, one rounding)."""
    which, k = offset or (None, 0)

    def rnd(name, *shape):
        n = k if name == which else 0
        flat = torch.randn(int(np.prod(shape)) + n, generator=gen,
                           device="cuda").to(dtype)
        return flat[n:].view(*shape)
    x, r, sc = rnd("x", rows, d), rnd("res", rows, d), rnd("scale", d)
    h, y = ops.fused_add_rmsnorm(x, r, sc)
    wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    err = check_close(f"fused_add_rmsnorm {label} h", h, wh, dtype)
    if not torch.equal(y, wy):
        raise AssertionError(f"fused_add_rmsnorm {label}: y is not the "
                             "plain version's bit for bit")
    plan = fused_mod.LAST_PLAN
    want_plan = fused_mod.plan(x, r, sc)
    if plan != want_plan or (want_vector is not None
                             and plan.vector != want_vector):
        raise AssertionError(f"fused_add_rmsnorm {label}: ran {plan}, "
                             f"expected {want_plan} (16-byte loads: "
                             f"{want_vector})")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=plan._asdict(), max_abs_err=err)
    if offset:
        row["offset"] = [which, k * x.element_size()]
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (4 * rows * d + d), 6.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_cuda(
            x, r, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_plain(
            x, r, sc))
        row["library_ms"] = None    # no single PyTorch call returns (h, y)
    log(f"[kernels] fused_add_rmsnorm {json.dumps(row)}")
    return row


def _dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_max(name: str, got: torch.Tensor, want: torch.Tensor,
              tol: float) -> float:
    """A gradient against its plain version: max |got - want| at most
    ``tol`` times max |want| (elementwise relative bounds mean nothing for
    the gradients' many near-zero entries)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err, top = (g - w).abs().max().item(), w.abs().max().item()
    if not err <= tol * top:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} "
                             f"exceeds {tol} x {top:.3e}")
    return err


def attention_bwd_case(gen, label, b, sq, sk, h, kh, d, causal, dtype,
                       timed=False, impl=None):
    """The backward kernels (q's dtype's, or with ``impl="cuda_core"`` the
    CUDA-core ones, called directly so they count no wrapper launch)
    against the plain backward with the same ``impl`` on the same q, k, v,
    dO and the kernel forward's LSE, run twice and compared bit for bit.
    Timed: beside the backward of ``F.scaled_dot_product_attention``
    (enable_gqa) on the same q, k, v and dO; the tensor-core kernels also
    beside the CUDA-core ones on the same inputs (``earlier_ms``) and at
    each pair of blocks (``blocks_ms``, "block_q x block_k"), as are the
    fp32 ones (CUDA-core), whose inputs are kept in ``F32_BWD_INPUTS`` for
    the parent tree's kernel (``parent_f32_bwd``)."""
    q, k, v = _attn_inputs(gen, b, sq, sk, h, kh, d, dtype)
    do = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    kernel = fa.kernel_for(dtype, impl)
    if impl is None:
        got = ops.flash_attention_bwd(q, k, v, do, lse, causal=causal)
    else:
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal,
                                          impl=impl)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, causal=causal,
                                        impl=impl)
    torch.cuda.synchronize()
    err = max(check_max(f"flash_attention_bwd {label} {n}", g, w,
                        BWD_TOL[dtype])
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal,
                                        impl=impl)
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        raise AssertionError(f"flash_attention_bwd {label}: two runs differ")
    row = dict(label=label, shape=[b, sq, sk, h, kh, d], causal=causal,
               dtype=_dname(dtype), kernel=kernel,
               blocks=list(fa.bwd_block_pair(kernel, b, sq, h)),
               max_abs_err=err)
    if timed:
        es = q.element_size()
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = (es * (3 * b * sq * h * d + 4 * b * sk * kh * d)
                  + 4 * b * h * sq)           # q, dO, dQ; k, v, dK, dV; LSE
        flops = 10.0 * d * pairs * b * h          # S, dP, dV, dK, dQ
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, do, lse, causal=causal, impl=impl))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        if kernel == "wgmma":
            row["earlier_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, do, lse, causal=causal, impl="cuda_core"))
        if impl is None:
            if dtype == torch.float32:
                F32_BWD_INPUTS[f"{b}x{sq}x{h}/{kh}x{d}"] = (
                    row, (q, k, v, do, lse))
            row["blocks_ms"] = {
                f"{bq}x{bk}": time_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, do, lse, causal=causal, block_q=bq, block_k=bk))
                for bq in fa.BWD_BLOCK_CHOICES[kernel]
                for bk in fa.BWD_BLOCK_CHOICES[kernel]}
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, causal=causal, impl=impl), iters=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    log(f"[kernels] flash_attention_bwd {json.dumps(row)}")
    return row


F32_BWD_INPUTS = {}     # "BxSxH/KHxD" -> (its row, (q, k, v, do, lse))
PARENT = os.path.join(ROOT, "build", "parent")


def parent_f32_bwd() -> None:
    """``earlier_ms`` of each timed fp32 backward row: the parent
    commit's kernel on the same inputs in this call, where its tree is
    unpacked at ``build/parent`` (``git archive``), through
    ``bench/attention_ablations.py --f32-bwd-default-only`` with the
    parent's ``src`` first on ``PYTHONPATH`` (it builds that tree's
    library and holds the kernel against that tree's plain version); null
    without a parent tree."""
    rows = {label: row for label, (row, _) in F32_BWD_INPUTS.items()}
    if not os.path.isdir(os.path.join(PARENT, "src", "repro_torch")):
        for row in rows.values():
            row["earlier_ms"] = None
        log(f"[kernels] flash_attention_bwd fp32 earlier_ms: no parent tree "
            f"at {PARENT}")
        return
    path = os.path.join(ROOT, "build", "f32_bwd_inputs.pt")
    torch.save({label: tuple(t.cpu() for t in args)
                for label, (_, args) in F32_BWD_INPUTS.items()}, path)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "src", "repro_torch", "bench",
                                      "attention_ablations.py"),
         "--f32-bwd-default-only", path],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(PARENT, "src")))
    if out.returncode != 0:
        raise RuntimeError(f"the parent tree's fp32 backward: "
                           f"{out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[kernels] flash_attention_bwd fp32, parent tree "
        f"({time.perf_counter() - t0:.1f}s with its build): "
        f"{json.dumps(res)}")
    for label, row in rows.items():
        row["earlier_ms"] = res[f"ms_{label}"]
        row["earlier_max_err_of_max"] = res[f"max_err_of_max_{label}"]


def fused_bwd_case(gen, label, rows, d, dtype, timed=False):
    """The backward kernel against its plain version; dsum at the
    forward's elementwise tolerance, dscale (a sum over every row) at
    BWD_TOL of its max.  The launch must leave the stream's ticket
    counters zero; the row carries ``bwd_plan``'s plan for these inputs."""
    x, r, dh, dy = (torch.randn(rows, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(4))
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    dsum, dscale = ops.fused_add_rmsnorm_bwd(dh, dy, x, r, sc)
    wsum, wscale = fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, r, sc)
    torch.cuda.synchronize()
    pl = rn.plan(x, r, sc, dh, dy, warp_vals=fused_mod.BWD_WARP_VALS)
    bp = fused_mod.bwd_plan(rows, d, x.element_size(), pl, _sms())
    stream = torch.cuda.current_stream()
    if fused_mod.ticket_counters(stream.device, stream).any():
        raise AssertionError(f"fused_add_rmsnorm_bwd {label}: left its "
                             "ticket counters set")
    err = max(check_close(f"fused_add_rmsnorm_bwd {label} dsum", dsum, wsum,
                          dtype),
              check_max(f"fused_add_rmsnorm_bwd {label} dscale", dscale,
                        wscale, BWD_TOL[dtype]))
    again = fused_mod.fused_add_rmsnorm_bwd_cuda(dh, dy, x, r, sc)
    if not (torch.equal(again[0], dsum) and torch.equal(again[1], dscale)):
        raise AssertionError(f"fused_add_rmsnorm_bwd {label}: two runs "
                             "differ")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=bp._asdict(), blocks=bp.blocks, max_abs_err=err)
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (5 * rows * d + 2 * d), 12.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_bwd_cuda(
            dh, dy, x, r, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(
            lambda: fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, r, sc))
        row["library_ms"] = None    # no single PyTorch call computes it
    log(f"[kernels] fused_add_rmsnorm_bwd {json.dumps(row)}")
    return row


def decode_case(gen, label, b, s, h, kh, d, n, dtype, timed=False,
                n_splits=None):
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    n_dev = torch.tensor(n, dtype=torch.int32, device="cuda")
    got = ops.flash_attention_decode(q, k, v, cache_len=n_dev,
                                     n_splits=n_splits)
    want = fa.flash_attention_decode_plain(q, k, v, cache_len=n,
                                           n_splits=n_splits)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention_decode {label}", got, want, dtype)
    if n == 0 and got.float().abs().max().item() != 0.0:
        raise AssertionError("flash_attention_decode: cache_len 0 must "
                             "give zeros")
    ns, _, nh = fa.decode_plan(b, s, h, kh, n_splits)
    row = dict(label=label, shape=[b, s, h, kh, d], cache_len=n,
               dtype=_dname(dtype), n_splits=ns,
               blocks=b * kh * -(-(h // kh) // nh) * ns, max_abs_err=err)
    if timed:
        es = q.element_size()
        nv = min(n, s)
        nbytes = es * (2 * b * h * d + 2 * b * nv * kh * d)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4.0 * b * h * nv * d, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_decode_cuda(
            q, k, v, cache_len=n_dev, n_splits=n_splits))
        row["gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_decode_plain(
            q, k, v, cache_len=n_dev, n_splits=n_splits), iters=3)
        qt = q.transpose(1, 2)
        kt, vt = k[:, :nv].transpose(1, 2), v[:, :nv].transpose(1, 2)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True))
    log(f"[kernels] flash_attention_decode {json.dumps(row)}")
    return row


def rmsnorm_case(gen, label, rows, d, dtype, timed=False, offset=0,
                 want_vector=None):
    """``offset`` elements into a flat buffer: an offset that is not a
    whole 16 bytes takes the scalar instantiation."""
    flat = torch.randn(rows * d + offset, generator=gen,
                       device="cuda").to(dtype)
    x = flat[offset:].view(rows, d)
    sc = torch.randn(d, generator=gen, device="cuda").to(dtype)
    got = ops.rmsnorm(x, sc)
    want = rn.rmsnorm_plain(x, sc)
    torch.cuda.synchronize()
    err = check_close(f"rmsnorm {label}", got, want, dtype)
    plan = rn.LAST_PLAN
    if plan != rn.plan(x, sc) or (want_vector is not None
                                  and plan.vector != want_vector):
        raise AssertionError(f"rmsnorm {label}: ran {plan}, expected "
                             f"{rn.plan(x, sc)} (16-byte loads: "
                             f"{want_vector})")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=plan._asdict(), max_abs_err=err)
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (2 * rows * d + d), 4.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: rn.rmsnorm_cuda(x, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: rn.rmsnorm_plain(x, sc))
        row["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), sc, 1e-5))
    log(f"[kernels] rmsnorm {json.dumps(row)}")
    return row


def add_case(gen, label, rows, d, dtype, timed=False):
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    r = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    got = ops.add(x, r)
    want = add_mod.add_plain(x, r)
    torch.cuda.synchronize()
    err = check_close(f"add {label}", got, want, dtype)
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               max_abs_err=err)
    if timed:
        row["bound_ms"], row["bound_by"] = bound(
            x.element_size() * 3 * rows * d, 1.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: add_mod.add_cuda(x, r))
        row["plain_ms"] = time_ms(lambda: add_mod.add_plain(x, r))
        row["library_ms"] = time_ms(lambda: torch.add(x, r))
    log(f"[kernels] add {json.dumps(row)}")
    return row


def ssd_case(gen, label, b, s, h, p, n, dtype, chunk=None, timed=False):
    """The kernel (four passes) against ``ssd_scan_passes_plain``; timed,
    also each pass alone (``passes_ms``), on buffers of its own."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = 0.001 + 0.099 * torch.rand(b, s, h, generator=gen, device="cuda")
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device="cuda"))
    bb = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    cc = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    ck = chunk or ssd_mod.CHUNK
    y, st = ops.ssd_scan(x, dt, a, bb, cc, chunk=ck)
    wy, wst = ssd_mod.ssd_scan_passes_plain(x, dt, a, bb, cc, chunk=ck)
    torch.cuda.synchronize()
    ytol, stol = SSD_TOL[dtype]
    err = max(check_close(f"ssd_scan {label} y", y, wy, dtype, ytol),
              check_close(f"ssd_scan {label} state", st, wst, dtype, stol))
    row = dict(label=label, shape=[b, s, h, p, n], chunk=ck,
               dtype=_dname(dtype), max_abs_err=err)
    if timed:
        es = x.element_size()
        nbytes = (2 * es * b * s * h * p + 4 * b * s * h + 4 * h
                  + 2 * es * b * s * n + 4 * b * h * p * n)
        flops, _ = kernel_costs.op_flops_bytes(
            "ssd_scan", (b, s, h, p, n), _dname(dtype))
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: ssd_mod.ssd_scan_cuda(
            x, dt, a, bb, cc, chunk=ck))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: ssd_mod.ssd_scan_passes_plain(
            x, dt, a, bb, cc, chunk=ck))
        row["sequential_plain_ms"] = time_ms(lambda: ssd_mod.ssd_scan_plain(
            x, dt, a, bb, cc, chunk=ck))
        row["library_ms"] = None    # no PyTorch call computes the scan
        bufs = ssd_mod.ssd_buffers(x, bb, chunk=ck)
        row["passes_ms"] = {
            name: time_ms(lambda w=name: ssd_mod.ssd_run_cuda(
                x, dt, a, bb, cc, bufs, chunk=ck, which=w))
            for name in ("cb", "chunk_state", "state_pass", "chunk_scan")}
    log(f"[kernels] ssd_scan {json.dumps(row)}")
    return row


def _labelled(rows, label: str) -> dict:
    return next(row for row in rows if row["label"] == label)


def _f32_point(row: dict) -> dict:
    """A timed fp32 case's figures, for its kernel's line."""
    return {key: row[key] for key in (
        "shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
        "max_abs_err") if key in row}


def serve_requests(cfg, seed: int, n: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=n)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(s),
                                               dtype=np.int32),
                    max_new_tokens=MAX_NEW) for i, s in enumerate(lens)]


def batch_lengths(reqs):
    """Padded prompt length of each batch the server will prefill."""
    return [max(len(r.prompt) for r in reqs[i:i + BATCH])
            for i in range(0, len(reqs), BATCH)]


def plan_shapes():
    """(label, mbs, seq_len, dtype) of every ``measure_block`` call the
    plan phase makes (``PLAN_FITS`` x ``BLOCK_MBS``, and the engine fit's
    ``calibrate_cpu_host`` at fp32 seq PLAN_ENGINE_SEQ, whose pipeline runs
    at its mbs 2): its attention runs at (mbs, seq_len, 15/5, 64) causal
    and its norm at mbs x seq_len rows."""
    engine = ("engine", dict(seq_len=PLAN_ENGINE_SEQ, dtype="float32"))
    for _, kw in PLAN_FITS + (engine,):
        for mbs in BLOCK_MBS:
            yield (f"plan_{kw['dtype']}_s{kw['seq_len']}_b{mbs}", mbs,
                   kw["seq_len"], getattr(torch, kw["dtype"]))


def moe_shapes():
    """(label, batch, seq, query heads, KV heads, dtype, backward) of the
    attention on the MoE paths (dbrx-132b's 48/8 heads of 128): [moe
    serve]'s prefills at [serve]'s batch lengths (forward), [moe train]'s
    and [moe pipeline]'s microbatches (both directions; the pipeline's
    stage 0 at tp 2 splits the heads).  Their norms run at batch x seq
    rows of d_model 6144 (the pipeline's unfused: attention only), and
    mixtral's prefill norm at its rows (``moe_norm_rows``)."""
    reqs = serve_requests(get_config("dbrx_132b"), 0, N_REQUESTS)
    cfg = get_config("dbrx_132b")
    h, kh = cfg.n_heads, cfg.n_kv_heads
    def micro(data):
        return (data["global_batch"] // data["num_microbatches"],
                data["seq_len"])

    for s in sorted(set(batch_lengths(reqs))):
        yield (f"moe_serve_s{s}", BATCH, s, h, kh, torch.bfloat16, False)
    yield ("moe_train", *micro(MOE_TRAIN_DATA), h, kh, torch.bfloat16, True)
    yield ("moe_pipe", *micro(MOE_PIPE_DATA), h, kh, torch.bfloat16, True)
    yield ("moe_pipe_1x2", *micro(MOE_PIPE_DATA), h // 2, kh // 2,
           torch.bfloat16, True)


def moe_norm_rows():
    """(label, rows, backward) of the fused norm on the MoE paths."""
    for label, b, s, _, _, _, bwd in moe_shapes():
        if not label.startswith("moe_pipe"):
            yield (f"{label}_rows{b * s}", b * s, bwd)
    yield (f"moe_mixtral_rows{MIXTRAL_ROWS * MIXTRAL_PROMPT}",
           MIXTRAL_ROWS * MIXTRAL_PROMPT, False)


def vlm_shapes():
    """(label, batch, seq, dtype, backward) of the attention on the vlm
    paths (internvl2-26b's 48/8 heads of 128 over its 256 patches and the
    text): [vlm serve]'s prefills at [serve]'s batch lengths, its fp32
    route check's (forward), [vlm train]'s microbatch (both directions).
    Their fused norms run at batch x seq rows of d_model 6144."""
    cfg = get_config(VLM_ARCH)
    p = cfg.n_patches
    for s in sorted(set(batch_lengths(serve_requests(cfg, 0, N_REQUESTS)))):
        yield (f"vlm_serve_s{p + s}", BATCH, p + s, torch.bfloat16, False)
    b, s = VLM_ROUTE_SHAPE
    yield (f"vlm_route_f32_s{p + s}", b, p + s, torch.float32, False)
    yield ("vlm_train", VLM_TRAIN_DATA["global_batch"]
           // VLM_TRAIN_DATA["num_microbatches"], VLM_TRAIN_DATA["seq_len"],
           torch.bfloat16, True)


def mesh_shapes():
    """(label, local batch, query heads, KV heads, dtype) of the attention
    each position of a mesh runs at [train]'s seq, its norms at local
    batch x seq rows: the bf16 meshes of MESH_CASES and the fp32 2-layer
    check's (2, 2); [pipeline]'s mesh stages (stage 0 of ``[2, 1]`` at tp
    2, bf16 and the fp32 2-layer check's, and the fp32 ``[1, 1]`` at dp
    2; these stages run the unfused norm, so only their attention shapes
    are a path's); [elastic]'s meshes (dp 1, 4 and 2 at tp 1, bf16).
    Heads that divide 'model' are split over it (K/V heads divide
    wherever the query heads do, on these meshes)."""
    cfg = get_config(ARCH)
    h, kh = cfg.n_heads, cfg.n_kv_heads
    mb = TRAIN_DATA["global_batch"] // TRAIN_DATA["num_microbatches"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"mesh_{dp}x{tp}_{_dname(dt)}", (dp, tp), dt)
             for (dp, tp), dt in [(shape, bf16) for _, shape in MESH_CASES]
             + [((2, 2), f32)]]
    cases += [(f"pipe_{dp}x{tp}_{_dname(dt)}", (dp, tp), dt)
              for (dp, tp), dt in (((1, 2), bf16), ((1, 2), f32),
                                   ((2, 1), f32))]
    cases += [(f"elastic_{dp}x1_bf16", (dp, 1), bf16)
              for dp in sorted(set(ELASTIC_DEVICES))]
    for label, (dp, tp), dt in cases:
        split = h % tp == 0 and kh % tp == 0
        yield (label, mb // dp, h // tp if split else h,
               kh // tp if split else kh, dt)


def hybrid_attention_cases(gen, main_lens) -> list:
    """The attention kernel at zamba2-2.7b's shared block (32/32 heads,
    head dim 80): [hybrid serve]'s prefills at [serve]'s batch lengths, the
    fp32 route check's (1, 1024), and (2, 1024) bf16 timed beside SDPA
    (``[ssm train]``'s microbatch)."""
    c = get_config(HYBRID_ARCH)
    h, kh, d = c.n_heads, c.n_kv_heads, c.hd
    rows = [attention_case(gen, f"hybrid_serve_s{s}", BATCH, s, s, h, kh, d,
                           True, torch.bfloat16)
            for s in sorted(set(main_lens))]
    b, s = HYBRID_ROUTE_SHAPE
    rows.append(attention_case(gen, f"hybrid_route_f32_s{s}", b, s, s, h,
                               kh, d, True, torch.float32))
    mb = HYBRID_TRAIN_DATA["global_batch"] // \
        HYBRID_TRAIN_DATA["num_microbatches"]
    s = HYBRID_TRAIN_DATA["seq_len"]
    rows.append(attention_case(gen, f"hybrid_b{mb}_s{s}_d{d}", mb, s, s, h,
                               kh, d, True, torch.bfloat16, timed=True))
    return rows


def grad_refusals(gen) -> None:
    """The kernels without a backward raise on the card where a gradient
    would be taken (the kernel's fresh output would drop it silently)."""
    x = torch.randn(2, 64, 3, 16, generator=gen, device="cuda")
    dt = torch.rand(2, 64, 3, generator=gen, device="cuda") * 0.1
    a = -torch.rand(3, generator=gen, device="cuda") - 0.5
    b = torch.randn(2, 64, 8, generator=gen, device="cuda")
    rows, sc = torch.randn(8, 64, device="cuda"), torch.ones(64,
                                                              device="cuda")
    calls = {"ssd_scan": lambda t: ops.ssd_scan(t, dt, a, b, b, chunk=32),
             "rmsnorm": lambda t: ops.rmsnorm(t, sc),
             "add": lambda t: ops.add(t, rows)}
    before = dict(ops.LAUNCHES)
    for name, call in calls.items():
        leaf = (x if name == "ssd_scan" else rows).clone().requires_grad_()
        try:
            call(leaf)
        except RuntimeError as err:
            if "has no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"ops.{name} ran under autograd on the "
                                 f"card")
    if dict(ops.LAUNCHES) != before:
        raise AssertionError("a refused call launched its kernel")
    log("[kernels] ops.ssd_scan, ops.rmsnorm, ops.add raise under autograd "
        "on the card")


def phase_kernels(main_lens):
    """Every kernel against its plain version at the shapes of the main
    paths that run it (serve, serve continuous, calibrate, fused) and at
    the edge cases;
    returns, per kernel, the timed case, at a shape of the path whose
    launches the kernel line reports."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config(ARCH)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    # the serve shape, timed for the wgmma kernel and for the CUDA-core
    # kernel on the same bf16 inputs (the kernel line's "earlier_ms")
    attn = [attention_case(gen, "prefill_s512", BATCH, 512, 512, h, kh, d,
                           True, bf16, timed=True)]
    gen_again = torch.Generator(device="cuda").manual_seed(0)
    attn.append(attention_case(gen_again, "prefill_s512_cuda_core", BATCH,
                               512, 512, h, kh, d, True, bf16, timed=True,
                               impl="cuda_core"))
    for s in sorted(set(main_lens)):          # the serve phase's own shapes
        attn.append(attention_case(gen, f"serve_s{s}", BATCH, s, s, h, kh, d,
                                   True, bf16))
    # the continuous phase's prefill: batch 1 at the prompts' pow2 bucket
    cb = cb_bucket()
    attn.append(attention_case(gen, f"continuous_b1_s{cb}", 1, cb, cb, h, kh,
                               d, True, bf16))
    # the plan phase's fits: every measure_block shape, causal
    for label, mbs, seq, dt in plan_shapes():
        attn.append(attention_case(gen, label, mbs, seq, seq, h, kh, d, True,
                                   dt))
    # the mesh phase's local shapes, a position's
    sl = TRAIN_DATA["seq_len"]
    for label, bl, hq, hk, dt in mesh_shapes():
        attn.append(attention_case(gen, label, bl, sl, sl, hq, hk, d, True,
                                   dt))
    # the MoE paths' (dbrx: head dim 128, GQA 6)
    moe_d = get_config("dbrx_132b").hd
    for label, mb_, s_, hq, hk, dt, _ in moe_shapes():
        attn.append(attention_case(gen, label, mb_, s_, s_, hq, hk, moe_d,
                                   True, dt))
    # the vlm paths' (internvl2: head dim 128, GQA 6, patches + text)
    vcfg = get_config(VLM_ARCH)
    for label, b_, s_, dt, _ in vlm_shapes():
        attn.append(attention_case(gen, label, b_, s_, s_, vcfg.n_heads,
                                   vcfg.n_kv_heads, vcfg.hd, True, dt))
    # [ssm mesh]'s positions' (the hybrid's shared block, head dim 80)
    for kernel, label, (b_, s_, hq, hk, d_), dt, _ in ssm_mesh_shapes():
        if kernel == "flash_attention":
            attn.append(attention_case(gen, label, b_, s_, s_, hq, hk, d_,
                                       True, dt))
    # [serve mesh]'s prefills: each position's and the fp32 one device's
    for kernel, label, shape, dt in serve_mesh_shapes():
        if kernel == "flash_attention":
            b_, s_, hq, hk, d_ = shape
            attn.append(attention_case(gen, label, b_, s_, s_, hq, hk, d_,
                                       True, dt))
    # [mesh families]' positions (internvl2) and its one-device references
    for kernel, label, shape, dt, _ in mesh_families_shapes():
        if kernel == "flash_attention":
            b_, s_, hq, hk, d_ = shape
            attn.append(attention_case(gen, label, b_, s_, s_, hq, hk, d_,
                                       True, dt))
    # [examples]' (quickstart's stages, train_e2e, the elastic loop's
    # positions, the served prefills)
    for kernel, label, shape, dt, _ in examples_shapes():
        if kernel == "flash_attention":
            b_, s_, hq, hk, d_ = shape
            attn.append(attention_case(gen, label, b_, s_, s_, hq, hk, d_,
                                       True, dt))
    attn += [
        attention_case(gen, "ragged_s509", BATCH, 509, 509, h, kh, d, True,
                       bf16),
        attention_case(gen, "block_q64", BATCH, 509, 509, h, kh, d, True,
                       bf16, block_q=64),
        attention_case(gen, "block_q128_f32", 2, 509, 509, h, kh, d, True,
                       f32, block_q=128),
        attention_case(gen, "noncausal_130x70", 2, 130, 70, h, kh, d, False,
                       bf16),
        attention_case(gen, "d128_f32", 2, 256, 256, 4, 2, 128, True, f32),
        attention_case(gen, "d128", 2, 256, 256, 4, 2, 128, True, bf16),
        attention_case(gen, "d80", 2, 200, 200, 6, 2, 80, True, bf16),
        attention_case(gen, "d48_noncausal", 2, 130, 70, 6, 2, 48, False,
                       bf16),
        attention_case(gen, "d112", 2, 200, 200, 6, 2, 112, True, bf16,
                       block_q=64),
        attention_case(gen, "noncausal_257x300_f32", 2, 257, 300, 4, 2, 64,
                       False, f32),
        attention_case(gen, "d16_reduced", 2, 77, 77, 4, 2, 16, True, bf16),
        attention_case(gen, "d32_f32", 2, 150, 150, 4, 2, 32, False, f32),
    ]
    # the calibrate path's attention: q (1, s, 120, 64), one KV head a head;
    # bf16 timed beside the CUDA-core kernel on the same inputs
    bh = CAL_GRID["attn_shapes"][-1][0]
    cal_row = attention_case(gen, "calibrate_s2048_bfloat16", 1, 2048, 2048,
                             bh, bh, d, True, bf16, timed=True)
    gen_again = torch.Generator(device="cuda").manual_seed(1)
    cal = attention_case(gen_again, "calibrate_s2048_bfloat16_cuda_core", 1,
                         2048, 2048, bh, bh, d, True, bf16, timed=True,
                         impl="cuda_core")
    attn += [cal_row, cal,
             attention_case(gen, "calibrate_s2048_float32", 1, 2048, 2048,
                            bh, bh, d, True, f32, timed=True)]
    hybrid_attn = hybrid_attention_cases(gen, main_lens)
    serve_row = attn[0]
    serve_row["earlier_ms"] = attn[1]["ms"]
    serve_row["more"] = [{key: row[key] for key in (
        "label", "shape", "dtype", "ms", "bound_ms", "bound_by",
        "share_of_bound", "tflops", "plain_ms", "library_ms", "max_abs_err")}
        for row in hybrid_attn if "ms" in row]
    serve_row["calibrate"] = {key: cal_row[key] for key in (
        "shape", "ms", "bound_ms", "bound_by", "share_of_bound", "tflops",
        "library_ms", "max_abs_err")}
    serve_row["calibrate"]["earlier_ms"] = cal["ms"]
    serve_row["calibrate_f32"] = {key: attn[-1][key] for key in (
        "shape", "kernel", "ms", "bound_ms", "bound_by", "share_of_bound",
        "tflops", "plain_ms", "library_ms", "max_abs_err")}
    # The calibrate shape is bound by operations (tensor cores against fp32
    # units: 0.065 against 0.962 ms), so the wgmma kernel must be 4x the
    # CUDA-core one there.  The serve shape is bound by bytes (6.3 us) and
    # both kernels by latency, so there it must only be faster.
    for row, old, factor in ((serve_row, attn[1], 1), (cal_row, cal, 4)):
        log(f"[kernels] flash_attention {row['label']}: wgmma "
            f"{row['ms']:.4f} ms, CUDA-core {old['ms']:.4f} ms on the same "
            f"bf16 inputs, {old['ms'] / row['ms']:.2f}x (needs {factor}x)")
        if not row["ms"] * factor < old["ms"]:
            raise AssertionError(
                f"flash_attention {row['label']}: the wgmma kernel "
                f"({row['ms']:.4f} ms) is not {factor}x faster than the "
                f"CUDA-core kernel ({old['ms']:.4f} ms) on the same inputs")
    dm = cfg.d_model
    norm = [fused_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True,
                       want_vector=True),
            fused_case(gen, "rows16384", 16384, dm, bf16, timed=True)]
    for s in sorted(set(main_lens)):
        norm.append(fused_case(gen, f"serve_rows{BATCH * s}", BATCH * s, dm,
                               bf16))
    norm.append(fused_case(gen, f"continuous_rows{cb}", cb, dm, bf16))
    for label, mbs, seq, dt in plan_shapes():
        norm.append(fused_case(gen, f"{label}_rows{mbs * seq}", mbs * seq, dm,
                               dt))
    for label, bl, _, _, dt in mesh_shapes():
        norm.append(fused_case(gen, f"{label}_rows{bl * sl}", bl * sl, dm,
                               dt))
    moe_dm = get_config("dbrx_132b").d_model
    for label, n, _ in moe_norm_rows():
        norm.append(fused_case(gen, label, n, moe_dm, bf16))
    for label, b_, s_, dt, _ in vlm_shapes():
        norm.append(fused_case(gen, f"{label}_rows{b_ * s_}", b_ * s_,
                               vcfg.d_model, dt))
    for kernel, label, shape, dt in serve_mesh_shapes():
        if kernel == "fused_add_rmsnorm":
            norm.append(fused_case(gen, label, *shape, dt))
    for kernel, label, shape, dt, _ in mesh_families_shapes():
        if kernel == "fused_add_rmsnorm":
            norm.append(fused_case(gen, label, *shape, dt))
    for kernel, label, shape, dt, _ in examples_shapes():
        if kernel == "fused_add_rmsnorm":
            norm.append(fused_case(gen, label, *shape, dt))
    norm += [fused_case(gen, "ragged_rows4071", 4071, dm, bf16),
             fused_case(gen, "f32_rows1000", 1000, dm, f32),
             fused_case(gen, "f32_4096x512", 4096, 512, f32),
             fused_case(gen, "rows4096_f32", BATCH * 512, dm, f32,
                        timed=True),
             fused_case(gen, "d2048", 64, 2048, bf16),
             fused_case(gen, "d8192", 64, 8192, bf16),
             fused_case(gen, "d8192_f32", 33, 8192, f32),
             fused_case(gen, "d1001_scalar", 16, 1001, bf16,
                        want_vector=False),
             fused_case(gen, "offset_2B_x_scalar", 300, dm, bf16,
                        offset=("x", 1), want_vector=False),
             fused_case(gen, "offset_2B_res_scalar", 300, dm, bf16,
                        offset=("res", 1), want_vector=False),
             fused_case(gen, "offset_16B_res", 300, dm, bf16,
                        offset=("res", 8), want_vector=True)]
    norm[0]["rows16384"] = {key: norm[1][key] for key in (
        "shape", "plan", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "max_abs_err")}
    norm[0]["f32"] = _f32_point(_labelled(norm, "rows4096_f32"))
    # decode on the calibrate path: q (1, 1, 120, 64) against a (1, sk, 120,
    # 64) cache (one KV head a head), at the grid's and held-out lengths;
    # the timed case is the grid's longest cache
    dec = [decode_case(gen, "calibrate_sk4096", 1, 4096, bh, bh, d, 4096,
                       bf16, timed=True),
           decode_case(gen, "calibrate_sk4096_f32", 1, 4096, bh, bh, d,
                       4096, f32, timed=True)]
    dec[0]["f32"] = {key: dec[1][key] for key in (
        "shape", "n_splits", "ms", "bound_ms", "bound_by", "share_of_bound",
        "gb_s", "plain_ms", "library_ms", "max_abs_err")}
    dec += [decode_case(gen, f"calibrate_sk{sk}_{_dname(dt)}", 1, sk, bh, bh,
                        d, sk, dt)
            for sk in (256, 549, 1024, 2048) for dt in (bf16, f32)]
    # the serve phase's decode shape: 8 rows, a 549-slot cache, GQA 15/5
    smax = PROMPT_MAX + MAX_NEW + 8
    # (the full cache is timed too, for PERF.md; the kernel line stays the
    # calibrate case above)
    dec += [decode_case(gen, f"serve_len{n}", BATCH, smax, h, kh, d, n, bf16,
                        timed=n == smax)
            for n in (0, 1, 300, smax)]
    dec += [decode_case(gen, "f32", BATCH, smax, h, kh, d, 300, f32),
            decode_case(gen, "d128", 2, 300, 4, 2, 128, 137, bf16),
            decode_case(gen, "d16_mqa", 2, 130, 15, 1, 16, 77, f32)]
    # forced split counts: one split (the split kernel writes the output, no
    # merge) and one tile a split (the maximum), with lengths that leave the
    # last splits empty; the two calibrate-shape cases are timed beside the
    # helper's own count
    tiles4096, tiles_serve = 4096 // fa.BLOCK_K, -(-smax // fa.BLOCK_K)
    dec += [decode_case(gen, "calibrate_sk4096_splits1", 1, 4096, bh, bh, d,
                        4096, bf16, timed=True, n_splits=1),
            decode_case(gen, "calibrate_sk4096_splits64", 1, 4096, bh, bh, d,
                        4096, bf16, timed=True, n_splits=tiles4096),
            decode_case(gen, "calibrate_len2000_splits64_f32", 1, 4096, bh,
                        bh, d, 2000, f32, n_splits=tiles4096),
            decode_case(gen, "serve_len300_splits1", BATCH, smax, h, kh, d,
                        300, bf16, n_splits=1),
            decode_case(gen, f"serve_len100_splits{tiles_serve}", BATCH, smax,
                        h, kh, d, 100, bf16, n_splits=tiles_serve),
            decode_case(gen, "serve_len0_splits1", BATCH, smax, h, kh, d, 0,
                        bf16, n_splits=1),
            decode_case(gen, "d16_mqa_splits1_f32", 2, 130, 15, 1, 16, 77,
                        f32, n_splits=1),
            decode_case(gen, "d16_mqa_splits3_f32", 2, 130, 15, 1, 16, 60,
                        f32, n_splits=3)]
    rms = [rmsnorm_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True,
                        want_vector=True),
           rmsnorm_case(gen, "rows16384", 16384, dm, bf16, timed=True),
           rmsnorm_case(gen, "rows16384_f32", 16384, dm, f32, timed=True),
           rmsnorm_case(gen, "rows4096_f32", BATCH * 512, dm, f32,
                        timed=True),
           rmsnorm_case(gen, "rows8", 8, dm, bf16),
           rmsnorm_case(gen, "ragged_rows4071", 4071, dm, bf16),
           rmsnorm_case(gen, "f32_rows1000", 1000, dm, f32),
           rmsnorm_case(gen, "d8192", 64, 8192, bf16),
           rmsnorm_case(gen, "d8192_f32", 33, 8192, f32),
           rmsnorm_case(gen, "d1000", 16, 1000, bf16),
           rmsnorm_case(gen, "d1001_scalar", 16, 1001, bf16,
                        want_vector=False),
           rmsnorm_case(gen, "offset_2B_scalar", 300, dm, bf16, offset=1,
                        want_vector=False)]
    rms[0]["rows16384"] = {key: rms[1][key] for key in (
        "shape", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "library_ms", "max_abs_err")}
    rms[0]["f32"] = dict(_f32_point(_labelled(rms, "rows4096_f32")),
                         rows16384=_f32_point(_labelled(rms, "rows16384_f32")))
    # SSD at mamba2-130m's geometry (H=24, P=64, N=128): the calibrate
    # grid's (4, 2048) and (1, 512), the held-out (2, 1024), and batch 1
    ssd = [ssd_case(gen, "calibrate_b4_s2048", 4, 2048, 24, 64, 128, bf16,
                    timed=True),
           ssd_case(gen, "calibrate_b1_s512", 1, 512, 24, 64, 128, f32),
           ssd_case(gen, "held_out_b2_s1024", 2, 1024, 24, 64, 128, bf16),
           ssd_case(gen, "mamba2_130m_f32", 1, 2048, 24, 64, 128, f32),
           ssd_case(gen, "ragged_s200", 1, 200, 24, 64, 128, bf16),
           ssd_case(gen, "sweep_2x256x3", 2, 256, 3, 64, 64, f32, chunk=64),
           ssd_case(gen, "chunk77_p40", 1, 200, 2, 40, 16, bf16, chunk=77),
           ssd_case(gen, "chunk77_p40_f32", 1, 200, 2, 40, 16, f32,
                    chunk=77),
           ssd_case(gen, "chunk77", 2, 256, 3, 64, 64, bf16, chunk=77),
           ssd_case(gen, "chunk32", 1, 128, 2, 32, 16, bf16, chunk=32)]
    # mamba2-130m at batch 1 and the fp32 calibrate point, timed for PERF.md
    for extra in (ssd_case(gen, "mamba2_130m_timed", 1, 2048, 24, 64, 128,
                           bf16, timed=True),
                  ssd_case(gen, "calibrate_b4_s2048_f32_timed", 4, 2048, 24,
                           64, 128, f32, timed=True)):
        ssd[0].setdefault("more", []).append({key: extra[key] for key in (
            "label", "shape", "dtype", "ms", "bound_ms", "share_of_bound",
            "plain_ms", "passes_ms")})
    # the state-space paths: [ssm serve]'s and [hybrid serve]'s prefills at
    # [serve]'s batch lengths, their fp32 route checks, and zamba2-2.7b's
    # geometry (H 80, P 64, N 64) timed at (2, 1024)
    ssm_geo = {arch: (c.ssm_nheads, c.ssm_headdim, c.ssm_state)
               for arch, c in ((a, get_config(a))
                               for a in (SSM_ARCH, HYBRID_ARCH))}
    for s_ in sorted(set(main_lens)):
        ssd.append(ssd_case(gen, f"ssm_serve_s{s_}", BATCH, s_,
                            *ssm_geo[SSM_ARCH], bf16))
        ssd.append(ssd_case(gen, f"hybrid_serve_s{s_}", BATCH, s_,
                            *ssm_geo[HYBRID_ARCH], bf16))
    ssd.append(ssd_case(gen, "ssm_route_f32", *SSM_ROUTE_SHAPE,
                        *ssm_geo[SSM_ARCH], f32))
    ssd.append(ssd_case(gen, "hybrid_route_f32", *HYBRID_ROUTE_SHAPE,
                        *ssm_geo[HYBRID_ARCH], f32))
    extra = ssd_case(gen, "zamba2_b2_s1024", 2, 1024, *ssm_geo[HYBRID_ARCH],
                     bf16, timed=True)
    ssd[0]["more"].append({key: extra[key] for key in (
        "label", "shape", "dtype", "ms", "bound_ms", "bound_by",
        "share_of_bound", "plain_ms", "passes_ms", "max_abs_err")})
    # [serve mesh]'s prefills' SSD: each position's and the fp32 one device's
    for kernel, label, shape, dt in serve_mesh_shapes():
        if kernel == "ssd_scan":
            ssd.append(ssd_case(gen, label, *shape, dt))
    # [ssm mesh]'s positions' SSD, mamba2-130m's at tp 4 timed
    for kernel, label, shape, dt, _ in ssm_mesh_shapes():
        if kernel == "ssd_scan":
            row = ssd_case(gen, label, *shape, dt,
                           timed=label == "ssm_mesh_mamba2_130m_1x4")
            ssd.append(row)
            if "ms" in row:
                ssd[0]["more"].append({key: row[key] for key in (
                    "label", "shape", "dtype", "ms", "bound_ms", "bound_by",
                    "share_of_bound", "plain_ms", "passes_ms",
                    "max_abs_err")})
    grad_refusals(gen)
    adds = [add_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True),
            add_case(gen, "f32_4096x512", 4096, 512, f32, timed=True)]
    adds[0]["f32"] = _f32_point(_labelled(adds, "f32_4096x512"))
    # the backward kernels at the train path's shapes (micro batch 4 x 1024
    # tokens: attention (4, 1024, 15/5, 64) causal, the norm 4096 x 960)
    mb, sl = (TRAIN_DATA["global_batch"] // TRAIN_DATA["num_microbatches"],
              TRAIN_DATA["seq_len"])
    abwd = [attention_bwd_case(gen, "train_s1024", mb, sl, sl, h, kh, d,
                               True, bf16, timed=True),
            attention_bwd_case(gen, "train_s1024_f32", mb, sl, sl, h, kh, d,
                               True, f32, timed=True),
            attention_bwd_case(gen, "train_s1024_cuda_core", mb, sl, sl, h,
                               kh, d, True, bf16, impl="cuda_core"),
            attention_bwd_case(gen, "noncausal_s1000", 2, 1000, 1000, h, kh,
                               d, False, bf16),
            attention_bwd_case(gen, "noncausal_s1000_f32", 2, 1000, 1000, h,
                               kh, d, False, f32),
            attention_bwd_case(gen, "noncausal_s1000_cuda_core", 2, 1000,
                               1000, h, kh, d, False, bf16,
                               impl="cuda_core"),
            attention_bwd_case(gen, "d16_reduced", 2, 77, 77, 4, 2, 16, True,
                               bf16),
            attention_bwd_case(gen, "d16_f32", 2, 77, 77, 4, 2, 16, True,
                               f32),
            # the rest of the GPU tests' shapes: head dim 128, and unequal
            # lengths, where the dK/dV kernel's transposed mask shows
            attention_bwd_case(gen, "d128_s1000", 1, 1000, 1000, 4, 2, 128,
                               True, bf16),
            attention_bwd_case(gen, "d128_s200", 1, 200, 200, 6, 2, 128,
                               True, bf16),
            attention_bwd_case(gen, "sq130_sk70_d48", 2, 130, 70, 4, 2, 48,
                               False, bf16),
            attention_bwd_case(gen, "sq70_sk130_d32", 1, 70, 130, 4, 4, 32,
                               True, bf16)]
    for label, bl, hq, hk, dt in mesh_shapes():
        abwd.append(attention_bwd_case(gen, label, bl, sl, sl, hq, hk, d,
                                       True, dt))
    for label, mb_, s_, hq, hk, dt, bwd in moe_shapes():
        if bwd:
            abwd.append(attention_bwd_case(gen, label, mb_, s_, s_, hq, hk,
                                           get_config("dbrx_132b").hd, True,
                                           dt))
    vcfg = get_config(VLM_ARCH)
    for label, b_, s_, dt, bwd in vlm_shapes():
        if bwd:
            abwd.append(attention_bwd_case(gen, label, b_, s_, s_,
                                           vcfg.n_heads, vcfg.n_kv_heads,
                                           vcfg.hd, True, dt))
    for kernel, label, (b_, s_, hq, hk, d_), dt, bwd in ssm_mesh_shapes():
        if kernel == "flash_attention" and bwd:
            abwd.append(attention_bwd_case(gen, label, b_, s_, s_, hq, hk,
                                           d_, True, dt))
    for kernel, label, shape, dt, bwd in mesh_families_shapes():
        if kernel == "flash_attention" and bwd:
            b_, s_, hq, hk, d_ = shape
            abwd.append(attention_bwd_case(gen, label, b_, s_, s_, hq, hk,
                                           d_, True, dt))
    for kernel, label, shape, dt, bwd in examples_shapes():
        if kernel == "flash_attention" and bwd:
            b_, s_, hq, hk, d_ = shape
            abwd.append(attention_bwd_case(gen, label, b_, s_, s_, hq, hk,
                                           d_, True, dt))
    # [ssm train]'s hybrid microbatch: the shared block at head dim 80
    hcfg = get_config(HYBRID_ARCH)
    hmb = HYBRID_TRAIN_DATA["global_batch"] // \
        HYBRID_TRAIN_DATA["num_microbatches"]
    hs = HYBRID_TRAIN_DATA["seq_len"]
    hyb = attention_bwd_case(gen, f"hybrid_train_s{hs}_d{hcfg.hd}", hmb, hs,
                             hs, hcfg.n_heads, hcfg.n_kv_heads, hcfg.hd,
                             True, bf16, timed=True)
    abwd.append(hyb)
    # the plan phase's gradients; the fp32 fit's largest shape timed (the
    # fp32 kernel's only path)
    for label, mbs, seq, dt in plan_shapes():
        abwd.append(attention_bwd_case(
            gen, label, mbs, seq, seq, h, kh, d, True, dt,
            timed=(label == PLAN_BWD_TIMED)))
    parent_f32_bwd()
    for row in (abwd[1], _labelled(abwd, PLAN_BWD_TIMED)):
        log(f"[kernels] flash_attention_bwd {row['label']}: "
            + json.dumps({key: row[key] for key in (
                "shape", "ms", "earlier_ms", "library_ms", "bound_ms",
                "share_of_bound", "blocks_ms")}))
    abwd[0]["more"] = [{key: hyb[key] for key in (
        "label", "shape", "dtype", "ms", "earlier_ms", "bound_ms", "bound_by",
        "share_of_bound", "tflops", "plain_ms", "library_ms", "max_abs_err",
        "blocks_ms")}]
    abwd[0]["f32"] = {key: abwd[1][key] for key in (
        "ms", "earlier_ms", "bound_ms", "bound_by", "share_of_bound",
        "plain_ms", "library_ms", "max_abs_err", "blocks_ms")}
    abwd[0]["plan_f32"] = {key: _labelled(abwd, PLAN_BWD_TIMED)[key]
                           for key in ("shape", "ms", "earlier_ms",
                                       "bound_ms", "bound_by",
                                       "share_of_bound", "plain_ms",
                                       "library_ms", "max_abs_err",
                                       "blocks_ms")}
    nbwd = [fused_bwd_case(gen, "train_rows4096", mb * sl, dm, bf16,
                           timed=True),
            fused_bwd_case(gen, "rows16384", 16384, dm, bf16, timed=True),
            fused_bwd_case(gen, "rows4096_f32", mb * sl, dm, f32),
            fused_bwd_case(gen, "rows16384_f32", 16384, dm, f32),
            fused_bwd_case(gen, "d1001_scalar", 37, 1001, bf16),
            fused_bwd_case(gen, "d1001_f32", 37, 1001, f32),
            fused_bwd_case(gen, "d8192", 64, 8192, bf16),
            fused_bwd_case(gen, "d8192_f32", 33, 8192, f32),
            fused_bwd_case(gen, "rows1", 1, dm, bf16),
            fused_bwd_case(gen, "rows7", 7, dm, bf16)]
    for label, mbs, seq, dt in plan_shapes():
        nbwd.append(fused_bwd_case(gen, f"{label}_rows{mbs * seq}",
                                   mbs * seq, dm, dt))
    for label, bl, _, _, dt in mesh_shapes():
        nbwd.append(fused_bwd_case(gen, f"{label}_rows{bl * sl}", bl * sl,
                                   dm, dt))
    for label, n, bwd in moe_norm_rows():
        if bwd:
            nbwd.append(fused_bwd_case(gen, label, n,
                                       get_config("dbrx_132b").d_model, bf16))
    for label, b_, s_, dt, bwd in vlm_shapes():
        if bwd:
            nbwd.append(fused_bwd_case(gen, f"{label}_rows{b_ * s_}",
                                       b_ * s_, vcfg.d_model, dt))
    for kernel, label, shape, dt, bwd in mesh_families_shapes():
        if kernel == "fused_add_rmsnorm" and bwd:
            nbwd.append(fused_bwd_case(gen, label, *shape, dt))
    for kernel, label, shape, dt, bwd in examples_shapes():
        if kernel == "fused_add_rmsnorm" and bwd:
            nbwd.append(fused_bwd_case(gen, label, *shape, dt))
    nbwd[0]["rows16384"] = {key: nbwd[1][key] for key in (
        "shape", "plan", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "max_abs_err")}
    return {"flash_attention": attn[0], "fused_add_rmsnorm": norm[0],
            "flash_attention_decode": dec[0], "rmsnorm": rms[0],
            "ssd_scan": ssd[0], "add": adds[0],
            "flash_attention_bwd": abwd[0], "fused_add_rmsnorm_bwd": nbwd[0]}


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_small_reference() -> None:
    """fp32, 2 layers, head_dim 64: the kernel path against the plain path
    on the card (TF32 is off, so both are float32 throughout)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), head_dim=64)
    params = model_lib.init(cfg, 1, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 77))).cuda()
    got = model_lib.forward(cfg, params, {"tokens": toks}, attn_impl="kernel")
    want = model_lib.forward(cfg, params, {"tokens": toks},
                             attn_impl="naive")
    err = (got - want).abs().max().item()
    if not err <= SMALL_FP32_TOL:
        raise AssertionError(f"small fp32 model: kernel vs plain path "
                             f"{err:.3e} > {SMALL_FP32_TOL}")
    log(f"[serve] small fp32 model, kernel vs plain path: max |dlogit| "
        f"{err:.3e} (tol {SMALL_FP32_TOL})")


def phase_reduced() -> None:
    """The reduced smollm config as it is (head_dim 16, attn_impl "auto"):
    one prefill through the attention kernel on the card."""
    cfg = get_config(ARCH).reduced()
    if cfg.hd != 16 or cfg.attn_impl != "auto":
        raise AssertionError(f"reduced {ARCH}: head_dim {cfg.hd}, "
                             f"attn_impl {cfg.attn_impl!r}")
    params = model_lib.init(cfg, 2, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 100))).cuda()
    ops.reset_launches()
    got = model_lib.forward(cfg, params, {"tokens": toks})
    launched = ops.LAUNCHES["flash_attention"]
    want = model_lib.forward(cfg, params, {"tokens": toks},
                             attn_impl="naive")
    err = (got - want).abs().max().item()
    if launched != cfg.n_layers or not err <= SMALL_FP32_TOL:
        raise AssertionError(f"reduced model (head_dim 16): {launched} "
                             f"attention launches, max |dlogit| {err:.3e}")
    log(f"[reduced] {cfg.name}, head_dim {cfg.hd}, attn_impl auto: "
        f"{launched} attention kernel launches, kernel vs plain path max "
        f"|dlogit| {err:.3e} (tol {SMALL_FP32_TOL})")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention kernel"
    if "bwd_dkdv" in name or "bwd_dq" in name:
        return "flash_attention_bwd kernel"
    if "fused_add_rmsnorm_bwd" in name:
        return "fused_add_rmsnorm_bwd kernel"
    if "fused_add_rmsnorm" in name:
        return "fused_add_rmsnorm kernel"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "splitk",
                              "nvjet")):    # nvjet: cuBLAS's sm90 GEMMs
        return "matmul (cuBLAS)"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    return "elementwise/other"


def _short_kernel_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces and, past 160
    characters, the rest (template arguments, parameter lists)."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(anonymous namespace\)::|\b\w+::", "", name)
    return name[:160]


def profile_window(label: str, fn, wall_ms: float, per: int,
                   breakdown: bool = False):
    """Device time by kernel group over one run of ``fn`` (torch.profiler,
    read from its Chrome trace so kernels launched outside PyTorch's own
    operators count too; it traces the card's activity only: nothing here
    reads the host's operator events, and an eager mesh step holds
    hundreds of thousands of them, several times the step's own wall to
    record and export).  ``busy`` is that device time over ``wall_ms``,
    the same work's wall time measured without the profiler.
    ``breakdown`` also prints the "elementwise/other" group by kernel
    name: the 10 largest, ms and launches a step (or call).  Returns the
    device ms, or None when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"chip_smoke_trace_{label}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    groups: dict = {}
    counts: dict = {}     # kernels by group
    names: dict = {}
    ported: dict = {}     # the port's own kernels by entry function
    other: dict = {}      # "elementwise/other" by kernel name: [ms, count]
    n_kernels = 0
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            ms = ev.get("dur", 0.0) / 1e3 / per
            g = _kernel_group(ev.get("name", ""))
            groups[g] = groups.get(g, 0.0) + ms
            counts[g] = counts.get(g, 0) + 1 / per
            short = ev.get("name", "")[:60]
            names[short] = names.get(short, 0.0) + ms
            if g.endswith(" kernel"):
                fn = re.sub(r"^.*?(\w+)(<|\().*$", r"\1", ev.get("name", ""))
                ported[fn] = ported.get(fn, 0.0) + ms
            if g == "elementwise/other":
                row = other.setdefault(_short_kernel_name(ev.get("name", "")),
                                       [0.0, 0.0])
                row[0] += ms
                row[1] += 1 / per
            n_kernels += 1
    if not n_kernels:
        log(f"[profile] {label}: the trace holds no device kernels; "
            "device time not measured")
        return None
    device_ms = sum(groups.values())
    log(f"[profile] {label} (per {'step' if per > 1 else 'call'}): "
        + json.dumps(dict(
            wall_ms=wall_ms / per, device_ms=device_ms,
            busy=device_ms / (wall_ms / per), kernels=n_kernels / per,
            by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            kernels_by_group=dict(sorted(counts.items(),
                                         key=lambda kv: -kv[1])),
            port_kernels=dict(sorted(ported.items(), key=lambda kv: -kv[1])),
            top=sorted(names.items(), key=lambda kv: -kv[1])[:5])))
    if breakdown:
        top = sorted(other.items(), key=lambda kv: -kv[1][0])[:10]
        log(f"[profile] {label} elementwise/other by kernel name (top 10 "
            f"of {len(other)}; ms and launches a "
            f"{'step' if per > 1 else 'call'}): " + json.dumps(dict(
                total_ms=groups.get("elementwise/other", 0.0),
                top=[dict(name=n, ms=ms, count=c) for n, (ms, c) in top])))
    return device_ms


def _fresh_requests(reqs):
    """The same prompts and lengths as new, unserved requests."""
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs]


def _same_tokens(label: str, got, want) -> None:
    bad = [g.rid for g, w in zip(got, want) if g.output != w.output]
    if bad or len(got) != len(want):
        raise AssertionError(f"[{label}] graphed vs eager tokens differ for "
                             f"requests {bad}")


def _serve_launch_check(label: str, cfg, n_prefill: int) -> dict:
    """The prefill kernels launch ``n_layers`` times a prefill, the others
    never (decode runs the plain path, as the reference's does)."""
    launches = dict(ops.LAUNCHES)
    for name, n in launches.items():
        want = cfg.n_layers * n_prefill if name in SERVE_KERNELS else 0
        if n != want:
            raise AssertionError(
                f"[{label}] {name}: {n} launches, expected {want} "
                f"({cfg.n_layers} per prefill x {n_prefill} prefills for "
                f"{', '.join(SERVE_KERNELS)}, none for the others)")
    return launches


def _pool_bytes(pool):
    """Bytes the caching allocator holds in a graph memory pool, or None
    where its snapshot does not name pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def _graph_stats(step) -> dict:
    return dict(graphs=sorted(step.graphs),
                capture_s={str(k): v for k, v in step.capture_seconds.items()},
                pool_reserved_bytes=_pool_bytes(step.pool))


def phase_serve(reqs, warm):
    """The graphed server's run is the serve path (launch counts, tokens,
    tok/s); the eager server (``graphed=False``) serves the same requests
    and must give the same tokens."""
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = model_lib.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) \
        + params["embed"].numel() + params["ln_f"].numel()
    log(f"[serve] {cfg.name}: {n_params / 1e6:.1f}M params "
        f"({cfg.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    max_len = PROMPT_MAX + MAX_NEW + 8
    server = BatchedServer(cfg, params, max_len=max_len, batch_size=BATCH)
    eager = BatchedServer(cfg, params, max_len=max_len, batch_size=BATCH,
                          graphed=False)
    if not server.graphed:
        raise AssertionError("[serve] BatchedServer on CUDA params is not "
                             "graphed")

    t_warm = _timed(lambda: server.run(warm))
    t_warm_eager = _timed(lambda: eager.run(_fresh_requests(warm)))
    log(f"[serve] warmup batch ({len(warm)} requests): graphed "
        f"{t_warm:.0f} ms, eager {t_warm_eager:.0f} ms")

    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    n_prefill = len(batch_lengths(reqs))
    ops.reset_launches()
    with DecodeClock() as clock:
        t_run = _timed(lambda: server.run(reqs))
    launches = _serve_launch_check("serve", cfg, n_prefill)
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and len(r.output) == MAX_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("a generated token is outside the vocabulary")
    n_tok = sum(len(r.output) for r in reqs)
    log(f"[serve] launches in the serve run: {json.dumps(launches)} "
        f"({n_prefill} prefills x {cfg.n_layers} layers)")
    ereqs = _fresh_requests(reqs)
    ops.reset_launches()
    with DecodeClock() as eclock:
        t_eager = _timed(lambda: eager.run(ereqs))
    _serve_launch_check("serve eager", cfg, n_prefill)
    _same_tokens("serve", reqs, ereqs)
    log(f"[serve] graphed vs eager: all {len(reqs)} requests' tokens equal")

    # prefill / decode step times on the first batch
    first = reqs[:BATCH]
    plen = max(len(r.prompt) for r in first)
    toks = np.zeros((len(first), plen), np.int64)
    for i, r in enumerate(first):
        toks[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        pre = _prefill_in_turns("serve", cfg, params, server.prefill_graph,
                                server.state, toks)
        peak_prefill = torch.cuda.max_memory_allocated()
        logits = pre["logits"]
        plain = model_lib.forward(cfg, params, batch, attn_impl="naive")[:, -1]
        decode = _decode_in_turns(cfg, params, server.decode_graph,
                                  server.state, len(first), plen)
        dev_prefill = profile_window(
            "prefill", lambda: pre["run"]("graphed"), pre["graphed_ms"], 1)
        profile_window("prefill_eager", lambda: pre["run"]("eager"),
                       pre["eager_ms"], 1)
        dev_decode = profile_window(
            "decode", lambda: decode["run"]("graphed", DECODE_PROFILED),
            decode["graphed_ms"] * DECODE_PROFILED, DECODE_PROFILED)
        profile_window("decode_eager",
                       lambda: decode["run"]("eager", DECODE_PROFILED),
                       decode["eager_ms"] * DECODE_PROFILED, DECODE_PROFILED)
    if logits.shape != (len(first), cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    dlogit = (logits - plain).abs().max().item()
    if not dlogit <= LOGITS_TOL:
        raise AssertionError(f"prefill last-token logits: kernel vs plain "
                             f"path {dlogit:.3e} > {LOGITS_TOL}")
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    stats = dict(prefill_ms=pre["graphed_ms"],
                 prefill_ms_eager=pre["eager_ms"],
                 prefill_batch=[len(first), plen],
                 decode_ms_per_step=decode["graphed_ms"],
                 decode_ms_per_step_eager=decode["eager_ms"],
                 decode_batch=len(first),
                 steady_tok_s=n_tok / (t_run / 1e3),
                 steady_tok_s_eager=n_tok / (t_eager / 1e3),
                 steady_tokens=n_tok, steady_s=t_run / 1e3,
                 steady_s_eager=t_eager / 1e3, warmup_s=t_warm / 1e3,
                 steady_split=_split(t_run, clock),
                 steady_split_eager=_split(t_eager, eclock),
                 reserved_gib_before_run=reserved / 2**30,
                 peak_mem_gib=peak / 2**30,
                 peak_mem_gib_prefill_in_turns=peak_prefill / 2**30,
                 logits_max_abs_diff=dlogit,
                 logits_std=logits.std().item(), argmax_agree=agree,
                 decode_steps=server.decode_steps,
                 decode_row_steps=server.decode_row_steps,
                 decode_graphs=_graph_stats(server.decode_graph),
                 prefill_graphs=_graph_stats(server.prefill_graph))
    log(f"[serve] {json.dumps(stats)}")
    return launches, dict(prefill_len=plen, prefill_device_ms=dev_prefill,
                          decode_device_ms=dev_decode), params


def _split(run_ms: float, clock) -> dict:
    """A timed run's host seconds inside the decode steps and outside them
    (prefills, host work), and the allocator's counts meanwhile."""
    return dict(decode_rows_s=clock.seconds,
                other_s=run_ms / 1e3 - clock.seconds, **clock.allocator)


def _in_turns(steps, pairs: int):
    """Host ms of each of ``pairs`` pairs of calls, in turns (eager,
    graphed, graphed, eager, ...)."""
    times = {"graphed": [], "eager": []}
    for j in range(pairs):
        order = ("eager", "graphed") if j % 2 == 0 else ("graphed", "eager")
        for kind in order:
            times[kind].append(_timed(steps[kind]))
    return times


def _prefill_in_turns(label, cfg, params, graph, state, toks, row=None):
    """Prefill ms, graphed and eager, in turns from the same state: the
    graph (``GraphedPrefill``) takes the prompts until it holds their
    shape's graph (eager, then the capture), then a copy of
    the state goes to the eager side (``prefill_on_device`` on the
    caller's stream).  PREFILL_PAIRS pairs follow, each side writing its
    own copy; after them one more call each must give the same logits,
    and the two states the same K/V, lengths and tokens, bit for bit.
    ``row``: the continuous server's row (by row), else the prefix.
    Returns the medians, the graphed logits and ``run(kind)``."""
    by_row = row is not None
    key = toks.shape[1] if by_row else tuple(toks.shape)
    tok_dev = torch.from_numpy(toks).cuda()
    rows = torch.tensor([row], device="cuda") if by_row else toks.shape[0]
    steps = {"graphed": lambda: graph(params, state, toks, row=row)}
    while key not in graph.graphs:
        steps["graphed"]()
    other = {k: v.clone() for k, v in state.items()}
    steps["eager"] = lambda: serve_step.prefill_on_device(
        cfg, params, other, tok_dev, rows)
    times = _in_turns(steps, PREFILL_PAIRS)
    logits = steps["graphed"]().clone()
    if not torch.equal(logits, steps["eager"]()):
        raise AssertionError(f"[{label}] prefill in turns: graphed and "
                             f"eager logits differ")
    for k in state:
        if not torch.equal(state[k], other[k]):
            raise AssertionError(f"[{label}] prefill in turns: graphed and "
                                 f"eager {k} differ")
    out = {f"{kind}_ms": statistics.median(t) for kind, t in times.items()}
    log(f"[{label}] prefill in turns ({PREFILL_PAIRS} pairs, "
        f"{'batch 1 into a row' if by_row else 'the prefix'} at "
        f"{tuple(toks.shape)}, from the same state; logits, caches, lengths "
        f"and tokens equal after): " + json.dumps(dict(
            out, graphed_ms_all=times["graphed"], eager_ms_all=times["eager"],
            speedup=out["eager_ms"] / out["graphed_ms"])))
    return dict(out, logits=logits, run=lambda kind: steps[kind]())


def _decode_in_turns(cfg, params, graph, state, rows, plen, label="serve"):
    """Decode ms a step, graphed and eager, in turns from the same cache
    state: ``state`` (the graph's) holds a ``plen``-token prefill in its
    first ``rows`` rows; the graph takes 2 steps at those rows (eager,
    then capture, or replays where it exists), then a copy of
    the state goes to the eager side.  DECODE_PAIRS pairs of single steps
    follow (eager, graphed, graphed, eager, ...), each side on its own
    copy; the two must hold the same cache, lengths and tokens after them.
    Returns the medians and ``run(kind, steps)`` for the profiles."""
    # the tensor length reads nothing on the host, so the room for the
    # graphed side's steps (2, the pairs, the profile) is checked here
    # (a state-space state has no slots to run past)
    need = plen + 2 + DECODE_PAIRS + DECODE_PROFILED
    size = state["k"].shape[2] if "k" in state else need
    if need > size:
        raise ValueError(f"[{label}] decode in turns: a {plen}-token prefill "
                         f"and {need - plen} steps write past the cache's "
                         f"{size} slots")
    steps = {"graphed": lambda: graph(params, state, rows)}
    for _ in range(2):
        steps["graphed"]()
    other = {k: v.clone() for k, v in state.items()}
    steps["eager"] = lambda: serve_step.decode_on_device(
        cfg, params, serve_step.rows_of(other, rows))
    times = _in_turns(steps, DECODE_PAIRS)
    for key in serve_step.cache_keys(state) + ["len", "cur"]:
        a, b = serve_step.rows_of(state, rows)[key], \
            serve_step.rows_of(other, rows)[key]
        if not torch.equal(a, b):
            raise AssertionError(f"[{label}] decode in turns: graphed and "
                                 f"eager {key} differ after {DECODE_PAIRS} "
                                 f"steps each")

    def run(kind, n):
        for _ in range(n):
            steps[kind]()
    out = {f"{kind}_ms": statistics.median(t) for kind, t in times.items()}
    log(f"[{label}] decode in turns (" + f"{DECODE_PAIRS} pairs, batch {rows}, "
        f"from the same cache state; caches, lengths and tokens equal "
        f"after): " + json.dumps(dict(
            out, graphed_ms_all=times["graphed"], eager_ms_all=times["eager"],
            speedup=out["eager_ms"] / out["graphed_ms"])))
    return dict(out, run=run)


def cb_bucket() -> int:
    """The continuous phase's prefill length: its prompts' pow2 bucket."""
    return min(_next_pow2(PROMPT_MAX), CB_CTX)


def continuous_requests(cfg, seed: int, n: int):
    """Prompts as ``serve_requests`` makes them (256-509 tokens: every
    bucket is 512); ``max_new_tokens`` spread evenly over CB_NEW, in an
    order drawn from the seed."""
    reqs = serve_requests(cfg, seed, n)
    spread = np.linspace(CB_NEW[0], CB_NEW[1], n).round().astype(int)
    for r, m in zip(reqs, np.random.default_rng(seed).permutation(spread)):
        r.max_new_tokens = int(m)
    return reqs


def phase_serve_continuous(params) -> dict:
    """``ContinuousBatchingServer`` at smollm-360M's published widths and
    depth: a warm run, then CB_REQUESTS requests through the graphed server
    (the path: launch counts, tok/s, stats) and the same through an eager
    one (``graphed=False``), which must give the same tokens and stats."""
    cfg = get_config(ARCH)
    kw = dict(max_slots=CB_SLOTS, max_ctx=CB_CTX, page_size=CB_PAGE,
              total_pages=CB_PAGES)
    servers = {"graphed": ContinuousBatchingServer(cfg, params, **kw),
               "eager": ContinuousBatchingServer(cfg, params, graphed=False,
                                                 **kw)}
    if not servers["graphed"].graphed:
        raise AssertionError("[serve continuous] the server on CUDA params "
                             "is not graphed")
    warm = continuous_requests(cfg, 1, CB_SLOTS)
    for i, r in enumerate(warm):      # every bucket twice before the run
        r.max_new_tokens = 4 + 2 * i
    reqs = continuous_requests(cfg, 0, CB_REQUESTS)
    runs, launches, out = {}, {}, {}
    for kind, srv in servers.items():
        t_warm = _timed(lambda: srv.run(_fresh_requests(warm)))
        srv.stats = ServerStats()
        mine = _fresh_requests(reqs)
        graphs = [set(step.graphs) if step else None
                  for step in (srv.decode_graph, srv.prefill_graph)]
        ops.reset_launches()
        with DecodeClock() as clock:
            t_run = _timed(lambda: srv.run(mine))
        if srv.graphed and graphs != [set(srv.decode_graph.graphs),
                                      set(srv.prefill_graph.graphs)]:
            raise AssertionError(
                f"[serve continuous] the timed run captured graphs the warm "
                f"run did not: decode {sorted(graphs[0])} -> "
                f"{sorted(srv.decode_graph.graphs)}, prefill "
                f"{sorted(graphs[1])} -> {sorted(srv.prefill_graph.graphs)}")
        launches[kind] = _serve_launch_check(
            f"serve continuous {kind}", cfg, srv.stats.prefill_calls)
        bad = [r.rid for r in mine
               if not r.done or len(r.output) != r.max_new_tokens]
        if bad:
            raise AssertionError(f"[serve continuous] {kind}: requests {bad} "
                                 f"did not finish with their own length")
        if srv.alloc.used_pages or srv.live or srv.queue:
            raise AssertionError(f"[serve continuous] {kind}: "
                                 f"{srv.alloc.used_pages} pages, "
                                 f"{len(srv.live)} live, {len(srv.queue)} "
                                 f"queued after the run")
        n_tok = sum(len(r.output) for r in mine)
        runs[kind] = mine
        out[kind] = dict(
            stats=dataclasses.asdict(srv.stats), steady_tok_s=n_tok
            / (t_run / 1e3), steady_tokens=n_tok, steady_s=t_run / 1e3,
            warmup_s=t_warm / 1e3, steady_split=_split(t_run, clock))
    _same_tokens("serve continuous", runs["graphed"], runs["eager"])
    if out["graphed"]["stats"] != out["eager"]["stats"]:
        raise AssertionError(f"[serve continuous] ServerStats differ: "
                             f"{out['graphed']['stats']} vs "
                             f"{out['eager']['stats']}")
    if out["graphed"]["stats"]["n_preempted"] < 1:
        raise AssertionError("[serve continuous] no preemption with "
                             f"{CB_PAGES} pages")
    g = servers["graphed"]
    log(f"[serve continuous] {CB_REQUESTS} requests, {CB_SLOTS} slots, "
        f"max_ctx {CB_CTX}, {CB_PAGES} pages of {CB_PAGE}; tokens and "
        f"ServerStats equal graphed vs eager: " + json.dumps(dict(
            out, launches=launches["graphed"],
            decode_graphs=_graph_stats(g.decode_graph),
            prefill_graphs=_graph_stats(g.prefill_graph))))
    # decode ms a step at each bucket the run used, graphed and eager in
    # turns; every row is set to length 1 first so no row can reach past
    # max_ctx (the time does not depend on the lengths: the plain
    # attention reads every slot).  Beside them, DECODE_PROFILED replays
    # back to back with one sync at the end, a step's wall without the
    # per-step sync.
    per_bucket = {}
    with torch.inference_mode():
        for srv in servers.values():
            srv.state["len"].fill_(1)
        e = servers["eager"]
        for bsz in sorted(g.decode_graph.graphs):
            steps = {"graphed": lambda: g.decode_graph(params, g.state, bsz),
                     "eager": lambda: serve_step.decode_rows(
                         cfg, params, e.state, bsz)}
            times = _in_turns(steps, 4)
            back = _timed(lambda: [steps["graphed"]()
                                   for _ in range(DECODE_PROFILED)])
            per_bucket[bsz] = dict(
                {k: statistics.median(t) for k, t in times.items()},
                graphed_all=times["graphed"],
                graphed_back_to_back=back / DECODE_PROFILED)
        log("[serve continuous] decode ms a step by bucket (4 pairs in "
            "turns; back to back: " f"{DECODE_PROFILED} replays, one sync): "
            + json.dumps(per_bucket))
        # the batch-1 prefill at the bucket, the run's other part,
        # left-padded as the server pads it, graphed and eager in turns
        # into row 0; its last-token logits held against the plain path
        # (naive attention + unfused norm)
        r, cb = reqs[0], cb_bucket()
        toks = np.zeros((1, cb), np.int64)
        toks[0, cb - len(r.prompt):] = r.prompt
        pbatch = {"tokens": torch.from_numpy(toks).cuda()}
        torch.cuda.reset_peak_memory_stats()
        pre = _prefill_in_turns("serve continuous", cfg, params,
                                g.prefill_graph, g.state, toks, row=0)
        peak = torch.cuda.max_memory_allocated()
        logits = pre["logits"]
        plain = model_lib.forward(cfg, params, pbatch,
                                  attn_impl="naive")[:, -1]
        if logits.shape != (1, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"[serve continuous] prefill logits "
                                 f"{tuple(logits.shape)} not finite or of "
                                 f"the wrong shape")
        dlogit = (logits - plain).abs().max().item()
        if not dlogit <= LOGITS_TOL:
            raise AssertionError(f"[serve continuous] prefill (1, {cb}) "
                                 f"last-token logits: kernel vs plain path "
                                 f"{dlogit:.3e} > {LOGITS_TOL}")
        calls = out["graphed"]["stats"]["prefill_calls"]
        log(f"[serve continuous] prefill (1, {cb}), graphed and eager: "
            + json.dumps(dict(
                prefill_ms=pre["graphed_ms"], prefill_ms_eager=pre["eager_ms"],
                prefill_calls=calls,
                prefill_share_of_run=calls * pre["graphed_ms"]
                / (out["graphed"]["steady_s"] * 1e3),
                prefill_share_of_run_eager=calls * pre["eager_ms"]
                / (out["eager"]["steady_s"] * 1e3),
                peak_mem_gib_prefill_in_turns=peak / 2**30,
                logits_max_abs_diff=dlogit, logits_tol=LOGITS_TOL,
                argmax_agree=bool(logits.argmax(-1) == plain.argmax(-1)))))
        profile_window("prefill_continuous", lambda: pre["run"]("graphed"),
                       pre["graphed_ms"], 1)
        top = max(per_bucket)
        profile_window("decode_continuous",
                       lambda: [g.decode_graph(params, g.state, top)
                                for _ in range(DECODE_PROFILED)],
                       per_bucket[top]["graphed"] * DECODE_PROFILED,
                       DECODE_PROFILED)
    return launches["graphed"]


def _path_launches(label: str, names) -> dict:
    launches = dict(ops.LAUNCHES)
    missing = [n for n in names if not launches[n]]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing} on the path "
                             f"({json.dumps(launches)})")
    log(f"[{label}] launches on the path: {json.dumps(launches)}")
    return launches


def table_path() -> str:
    """Where phase 6 saves the card's kernel-cost table: keyed by
    ``default_chip``, as ``calibrate_kernels`` keys it."""
    return os.path.join(ROOT, "build",
                        f"kernel-costs-{at.default_chip('cuda')}.json")


def phase_calibrate(serve_dev: dict) -> tuple:
    """Kernel calibration at full width, the table's held-out accuracy,
    and what it does to the analytic price of a smollm-360M layer.
    Returns the launches and the accuracy (for [autotune])."""
    cfg = get_config(ARCH)
    path = table_path()
    ops.reset_launches()
    t0 = time.perf_counter()
    cal = measured.calibrate_kernels(at.default_chip("cuda"),
                                     dtypes=("bfloat16", "float32"),
                                     iters=10, path=path, **CAL_GRID)
    t_cal = time.perf_counter() - t0
    acc = kernels_bench.cost_table_accuracy(
        cal.table, HELD_OUT, dtypes=("bfloat16", "float32"), iters=10)
    launches = _path_launches("calibrate", CALIBRATE_KERNELS)
    log(f"[calibrate] {cal.table.n_points()} points in {t_cal:.1f}s -> "
        f"{path}")
    for r in cal.points:
        log(f"[calibrate] {json.dumps(r)}")
    for dtype, res in acc.items():
        for r in res["rows"]:
            log(f"[accuracy] {dtype} {json.dumps(r)}")
        log(f"[accuracy] {dtype} " + json.dumps(
            {k: v for k, v in res.items() if k != "rows"}))

    table = cal.table
    train = JobProfile(TrainJob(cfg, seq_len=512, global_batch=8))
    like = JobProfile(TrainJob(cfg, seq_len=serve_dev["prefill_len"],
                               global_batch=BATCH))
    serve = JobProfile(ServeJob(cfg, prompt_len=512, decode_batch=BATCH))
    smax = PROMPT_MAX + MAX_NEW + 8

    def prices():
        return dict(
            prefill_block_ms_s512=train.cost("block", "H100", 1, 8).fwd * 1e3,
            prefill_block_ms_serve=like.cost("block", "H100", 1, BATCH).fwd
            * 1e3,
            decode_block_ms=serve.decode_cost("block", "H100", 1, BATCH,
                                              smax) * 1e3)
    kernel_costs.clear_kernel_tables()
    roofline = prices()
    kernel_costs.register_kernel_table(table)
    with_table = prices()
    per_layer = {k: (v / cfg.n_layers if v is not None else None)
                 for k, v in (("prefill", serve_dev["prefill_device_ms"]),
                              ("decode", serve_dev["decode_device_ms"]))}
    log("[analytic] one smollm-360M block on 'H100' (ms): " + json.dumps(dict(
        roofline=roofline, with_table=with_table,
        serve_device_ms_per_layer=dict(
            prefill=per_layer["prefill"], decode=per_layer["decode"],
            prefill_batch=[BATCH, serve_dev["prefill_len"]],
            decode_batch=BATCH, decode_cache=smax))))
    kernel_costs.clear_kernel_tables()
    return launches, acc


def phase_fused() -> dict:
    """The reference's fused-vs-unfused benchmark, on the port's kernels."""
    ops.reset_launches()
    out = {}
    for rows, d, dtype in ((4096, 512, "float32"), (4096, 960, "bfloat16")):
        res = kernels_bench.fused_vs_unfused(rows, d, dtype, iters=20)
        out[f"{rows}x{d}_{dtype}"] = res
        log(f"[fused] {rows}x{d} {dtype}: {json.dumps(res)}")
    return _path_launches("fused", FUSED_KERNELS)


def _flat_grads(cfg, params, mb):
    """Loss and fp32 gradient leaves of one microbatch (``loss_and_grads``
    over a batch of one microbatch)."""
    batch = {k: v[None] for k, v in mb.items()}
    loss, grads = train_lib.loss_and_grads(cfg, params, batch)
    return loss.item(), dict(opt_lib.tree_leaves(grads))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two gradient leaves, summed in float64 (an fp32 sum over
    millions of elements is itself off in the fourth digit)."""
    return F.cosine_similarity(a.double().flatten(), b.double().flatten(),
                               dim=0).item()


def _grad_agreement(label, cfg, params, mb, tol, cosine=None):
    """One microbatch through the kernel path and the plain path
    (``attn_impl="naive"``: naive attention and the unfused norm seam):
    the losses and every gradient leaf, errors printed.  A bf16 model is
    also run as fp32 on the plain path, and each bf16 path's cosine to
    those gradients is printed (``cos_fp32``, ``plain_cos_fp32``): it says
    which path the kernel-vs-plain difference comes from."""
    kl, kg = _flat_grads(cfg, params, mb)
    pl, pg = _flat_grads(dataclasses.replace(cfg, attn_impl="naive"),
                         params, mb)
    ref = None
    if cfg.dtype != "float32":
        f32 = dataclasses.replace(cfg, attn_impl="naive", dtype="float32",
                                  param_dtype="float32")
        up = opt_lib.tree_unflatten(
            (k, p.float()) for k, p in opt_lib.tree_leaves(params))
        ref = _flat_grads(f32, up, mb)[1]
        del up
    worst, rows = 0.0, {}
    for name in kg:
        g, w = kg[name], pg[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"[train] {label}: non-finite grad {name}")
        rel = ((g - w).abs().max() / w.abs().max()).item()
        cos = _cosine(g, w)
        rows[name] = dict(rel=rel, cos=cos)
        if ref is not None:
            rows[name].update(cos_fp32=_cosine(g, ref[name]),
                              plain_cos_fp32=_cosine(w, ref[name]))
        worst = max(worst, rel)
        if not rel <= tol or (cosine is not None and not cos >= cosine):
            raise AssertionError(
                f"[train] {label}: grad {name} kernel vs plain path max "
                f"|dg| / max|g| {rel:.3e} (tol {tol}), cosine {cos:.6f}"
                f" (min {cosine})")
    if not abs(kl - pl) <= TRAIN_LOSS_TOL * abs(pl):
        raise AssertionError(f"[train] {label}: loss {kl} vs plain {pl}")
    log(f"[train] {label}: kernel vs plain path: " + json.dumps(dict(
        loss=kl, plain_loss=pl, max_rel_grad_err=worst,
        min_cosine=min(r["cos"] for r in rows.values()), tol=tol,
        cosine_min=cosine, leaves=rows)))
    return worst


def _train_launch_check(label: str, cfg, dc, n_steps: int) -> dict:
    """The launches counted since the last reset: each train kernel its
    per-step count times ``n_steps``, every other kernel none."""
    launches = dict(ops.LAUNCHES)
    per_step = cfg.n_layers * dc.num_microbatches
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * per_step, fused_add_rmsnorm=2 * per_step,
                flash_attention_bwd=per_step, fused_add_rmsnorm_bwd=per_step)
    for name, n in launches.items():
        if n != want[name] * n_steps:
            raise AssertionError(
                f"[train] {label}: {name}: {n} launches in {n_steps} steps, "
                f"expected {want[name]} a step ({cfg.n_layers} layers x "
                f"{dc.num_microbatches} microbatches; the forward kernels "
                f"run again under remat)")
    log(f"[train] {label}: launches in {n_steps} steps: "
        f"{json.dumps(launches)} (per step "
        f"{json.dumps({k: v for k, v in want.items() if v})})")
    return launches


def _add_counts(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def _resident_bytes(params, state) -> int:
    trees = (params, state["m"], state["v"], {"step": state["step"]})
    return sum(t.numel() * t.element_size() for tree in trees
               for _, t in opt_lib.tree_leaves(tree))


def _graph_nodes(graph):
    """The captured graph's nodes by type (driver API, on its
    ``cudaGraph_t``), or None where PyTorch does not expose the graph."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(n)):
        return None
    names = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
             5: "empty", 6: "wait_event", 7: "event_record"}
    kinds: dict = {}
    kind = ctypes.c_int(0)
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        name = names.get(kind.value, str(kind.value))
        kinds[name] = kinds.get(name, 0) + 1
    return dict(total=n.value, by_type=kinds)


def _timed_step(fn):
    """(wall ms, device ms, working set in bytes above what was allocated
    before) of one call of ``fn``, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (wall, start.elapsed_time(end),
            torch.cuda.max_memory_allocated() - base, out)


def _param_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for (_, x), (_, y) in zip(opt_lib.tree_leaves(a),
                                         opt_lib.tree_leaves(b)))


def _compare_steps(label, em, gm, ep, gp) -> bool:
    """Graphed vs eager after one step: loss and grad_norm within
    TRAIN_LOSS_TOL of their size, every param leaf within TRAIN_GRAD_TOL
    of its max |p|.  Returns whether all of it is bit-identical."""
    row, same = {}, True
    for key in ("loss", "grad_norm", "lr"):
        err = (gm[key] - em[key]).abs().item()
        row[key] = err
        same &= torch.equal(gm[key], em[key])
        if not err <= TRAIN_LOSS_TOL * em[key].abs().item():
            raise AssertionError(f"[train] {label}: {key} graphed "
                                 f"{gm[key].item()} vs eager {em[key].item()}")
    worst = 0.0
    for (k, g), (_, e) in zip(opt_lib.tree_leaves(gp),
                              opt_lib.tree_leaves(ep)):
        err = (g.float() - e.float()).abs().max().item()
        worst = max(worst, err)
        same &= torch.equal(g, e)
        if not err <= TRAIN_GRAD_TOL * e.float().abs().max().item():
            raise AssertionError(f"[train] {label}: param {k} graphed vs "
                                 f"eager max |dp| {err:.3e}")
    log(f"[train] {label}: graphed vs eager max |diff|: " + json.dumps(dict(
        row, params=worst, bit_identical=same)))
    return same


def phase_train():
    """smollm-360M, 32 layers, bf16, ``remat="full"``: training steps
    through ``make_train_step`` and ``make_graphed_train_step``, a main
    path for the two forward kernels and both backward kernels.  Returns
    the launches and the measured steps (the eager ``[train]`` stats and
    the graphed step's figures in turns)."""
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    n_fresh = 1 + TRAIN_TIMED + 1
    batches = [ds.batch(i)
               for i in range(n_fresh + TRAIN_GRAPH_STEPS + TRAIN_PAIRS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init(cfg, 0, device="cuda")
    state = opt_lib.init_state(params)
    step = train_lib.make_train_step(cfg, ocfg)
    total: dict = {}
    ops.reset_launches()
    # (a) one repeated batch: the loss must fall
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, m = step(params, state, batches[0])
        losses.append(m["loss"].item())
    first_s = time.perf_counter() - t0
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] losses {losses}: not finite, or the "
                             "last is not below the first")
    # (b) fresh batches, timed: CUDA events around each step, host clock
    dev_ms, wall_ms, timed_losses = [], [], []
    for i in range(TRAIN_TIMED):
        b = batches[1 + i]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, b)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        timed_losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    # (c) launches over (a) and (b), per step
    _add_counts(total, _train_launch_check(
        "eager", cfg, dc, TRAIN_STEPS + TRAIN_TIMED))
    tokens = dc.global_batch * dc.seq_len
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, remat=cfg.remat,
        data=TRAIN_DATA, opt=TRAIN_OPT, losses=losses,
        timed_losses=timed_losses, first_steps_s=first_s,
        step_device_ms=statistics.median(dev_ms), step_device_ms_all=dev_ms,
        step_wall_ms=statistics.median(wall_ms), step_wall_ms_all=wall_ms,
        tokens_per_step=tokens,
        tokens_per_s=tokens / (statistics.median(wall_ms) / 1e3),
        peak_mem_gib=peak / 2**30)
    log(f"[train] {json.dumps(stats)}")
    profile_window("train_step_eager",
                   lambda: step(params, state, batches[n_fresh - 1]),
                   statistics.median(wall_ms), 1, breakdown=True)
    # (d) kernel path vs plain path on one microbatch, on the card
    mb = {k: v[0] for k, v in batches[0].items()}
    _grad_agreement(f"{cfg.name} bf16, {cfg.n_layers} layers", cfg, params,
                    mb,
                    TRAIN_GRAD_TOL, TRAIN_COSINE)
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param_dtype="float32")
    _grad_agreement(f"{cfg.name} widths fp32, 2 layers", small,
                    model_lib.init(small, 1, device="cuda"), mb,
                    SMALL_FP32_TOL)
    del params, state, m
    graphed_launches, turns = phase_train_graphed(cfg, dc, ocfg,
                                                  batches[n_fresh:])
    _add_counts(total, graphed_launches)
    return total, dict(eager=stats, graphed=turns["graphed"])


def phase_train_graphed(cfg, dc, ocfg, batches):
    """The graphed step (``make_graphed_train_step``) against the eager one
    from two copies of the same seeded weights: TRAIN_GRAPH_STEPS steps
    each on the same fresh batches (the first graphed call runs eagerly
    on its side stream, the second captures and replays, the rest
    replay), compared after every step; then TRAIN_PAIRS pairs of steps
    timed in turns (eager, graphed, graphed, eager, ...); then the graphed
    step profiled.  Returns the launches of both windows and each side's
    figures in turns."""
    tokens = dc.global_batch * dc.seq_len
    ep = model_lib.init(cfg, 3, device="cuda")
    es = opt_lib.init_state(ep)
    gp = model_lib.init(cfg, 3, device="cuda")
    gs = opt_lib.init_state(gp)
    eager = train_lib.make_train_step(cfg, ocfg)
    graphed = train_lib.make_graphed_train_step(cfg, ocfg, gp, gs,
                                                batches[0])
    total: dict = {}
    ops.reset_launches()
    same, g_extra, e_extra, calls = True, 0, 0, []
    reserved0 = torch.cuda.memory_reserved()
    for i in range(TRAIN_GRAPH_STEPS):
        b = batches[i]
        e_wall, _, ext, (_, _, em) = _timed_step(lambda: eager(ep, es, b))
        e_extra = max(e_extra, ext)
        g_wall, g_dev, ext, (_, _, gm) = _timed_step(
            lambda: graphed(gp, gs, b))
        g_extra = max(g_extra, ext)
        calls.append(dict(call=i + 1, wall_ms=g_wall, device_ms=g_dev,
                          working_set_gib=ext / 2**30, eager_wall_ms=e_wall))
        same &= _compare_steps(f"step {i + 1}", em, gm, ep, gp)
    _add_counts(total, _train_launch_check(
        "graphed vs eager", cfg, dc, 2 * TRAIN_GRAPH_STEPS))
    if graphed.capture_launches != {k: n // (2 * TRAIN_GRAPH_STEPS)
                                    for k, n in total.items()}:
        raise AssertionError(f"[train] the capture recorded "
                             f"{graphed.capture_launches}, not one eager "
                             f"step's launches")
    nodes = _graph_nodes(graphed.graph)
    log("[train] graphed step: " + json.dumps(dict(
        capture_s=graphed.capture_seconds, graph_nodes=nodes,
        capture_launches=graphed.capture_launches, calls=calls,
        reserved_growth_gib=(torch.cuda.memory_reserved() - reserved0)
        / 2**30, bit_identical_3_steps=same)))
    if nodes is not None and nodes["by_type"].get("kernel", 0) < sum(
            graphed.capture_launches.values()):
        raise AssertionError(f"[train] the graph holds {nodes} nodes, fewer "
                             f"kernels than the port's launches")
    # timing in turns, the pairs' batches shared
    runs = {"eager": [], "graphed": []}
    steps = {"eager": lambda b: eager(ep, es, b),
             "graphed": lambda b: graphed(gp, gs, b)}
    ops.reset_launches()
    for j in range(TRAIN_PAIRS):
        b = batches[TRAIN_GRAPH_STEPS + j]
        order = ("eager", "graphed") if j % 2 == 0 else ("graphed", "eager")
        for kind in order:
            wall, dev, ext, (_, _, m) = _timed_step(lambda: steps[kind](b))
            runs[kind].append((wall, dev, ext, m["loss"].item()))
    _add_counts(total, _train_launch_check(
        "turns", cfg, dc, 2 * TRAIN_PAIRS))
    same_after = _param_diff(ep, gp)
    turns = {}
    for kind, rows in runs.items():
        wall = statistics.median(r[0] for r in rows)
        extra = max([r[2] for r in rows]
                    + [e_extra if kind == "eager" else g_extra])
        own = _resident_bytes(ep, es) if kind == "eager" \
            else _resident_bytes(gp, gs)
        turns[kind] = dict(
            step_wall_ms=wall, step_wall_ms_all=[r[0] for r in rows],
            step_device_ms=statistics.median(r[1] for r in rows),
            step_device_ms_all=[r[1] for r in rows],
            tokens_per_s=tokens / (wall / 1e3),
            peak_mem_gib=(own + extra) / 2**30,
            resident_gib=own / 2**30, working_set_gib=extra / 2**30,
            losses=[r[3] for r in rows])
    log(f"[train] in turns ({TRAIN_PAIRS} pairs, eager and graphed from "
        f"the same weights on the same batches; peak_mem_gib = the copy's "
        f"params and AdamW state + the most a step allocated above them, "
        f"for the graphed step at its capture): " + json.dumps(dict(
            turns, wall_speedup=turns["eager"]["step_wall_ms"]
            / turns["graphed"]["step_wall_ms"],
            params_max_abs_diff_after=same_after,
            reserved_gib=torch.cuda.memory_reserved() / 2**30)))
    g_wall = turns["graphed"]["step_wall_ms"]
    b = batches[-1]
    dev = profile_window("train_step", lambda: graphed(gp, gs, b), g_wall, 1,
                         breakdown=True)
    if dev is None:
        log(f"[profile] train_step: the trace holds no kernel of the "
            f"graph's replay; the graphed step's device time from events "
            f"is {turns['graphed']['step_device_ms']:.3f} ms (busy "
            f"{turns['graphed']['step_device_ms'] / g_wall:.3f}); the eager "
            f"step's profile above holds its kernels")
    return total, turns


def _pipe_cfg():
    return dataclasses.replace(get_config(ARCH), tie_embeddings=False,
                               remat="full")


def _pipe(pl, cfg, ocfg, full, graphed, tps=(1, 1), dp=1,
          policy=PIPE_MESH_POLICY):
    """A pipeline of ``even_stages(cfg, tps, dp)`` with every position on
    the one card, ``full``'s weights copied in."""
    stages = pl.even_stages(cfg, list(tps), dp=dp)
    pipe = pl.MPMDPipeline(cfg, stages, ocfg, policy=policy,
                           devices=["cuda:0"] * sum(s.n_devices
                                                    for s in stages),
                           graphed=graphed)
    pipe.full_params_like(full)
    return pipe


def _stage_leaves(tree):
    """(path, whole tensor on the card) of a stage's tree, a mesh stage's
    ``Sharded`` leaves gathered."""
    from repro_torch.dist import placement as pm
    return [(k, pm.unshard(t, "cuda") if isinstance(t, pm.Sharded) else t)
            for k, t in pm.tree_items(tree)]


def _stage_slice(st, flat: dict, key: str):
    """The single-device tree's leaf ``key`` cut to stage ``st``."""
    if key.startswith("layers/"):
        return flat[key][st.start:st.stop]
    return flat[key]


def _pipe_param_diff(a, b) -> tuple:
    """(max |a - b| over every stage's params, bit-identical)."""
    worst, same = 0.0, True
    for pa, pb in zip(a.params, b.params):
        for (_, x), (_, y) in zip(opt_lib.tree_leaves(pa),
                                  opt_lib.tree_leaves(pb)):
            worst = max(worst, (x.float() - y.float()).abs().max().item())
            same &= torch.equal(x, y)
    return worst, same


def _pipe_stage_memory(pipe, batch) -> list:
    """One eager step with each stage program's working set read off the
    allocator (``max_memory_allocated`` over the call, above what was
    allocated before it) beside the stage's resident params, AdamW state
    and gradient buffers."""
    seen = [dict(working_set_bytes=0) for _ in pipe.stages]
    progs = pipe._programs
    saved = [dict(p) for p in progs]

    def wrap(i, fn):
        def call(*a):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a)
            torch.cuda.synchronize()
            seen[i]["working_set_bytes"] = max(
                seen[i]["working_set_bytes"],
                torch.cuda.max_memory_allocated() - before)
            return out
        return call

    for i, p in enumerate(progs):
        for name in p:
            p[name] = wrap(i, p[name])
    try:
        pipe.train_step(batch)
    finally:
        for p, orig in zip(progs, saved):
            p.update(orig)
    for i, (p, o, acc) in enumerate(zip(pipe.params, pipe.opt_states,
                                        pipe._acc)):
        seen[i]["resident_bytes"] = sum(
            t.numel() * t.element_size() for tree in (p, o["m"], o["v"], acc)
            for _, t in opt_lib.tree_leaves(tree))
        seen[i]["max_memory_allocated_gib"] = (
            seen[i]["resident_bytes"] + seen[i]["working_set_bytes"]) / 2**30
    return seen


def _pipe_launch_check(label: str, cfg, dc, n_steps: int,
                       prefix: str = "[pipeline]") -> dict:
    """The launches counted since the last reset: per step the attention
    forward 3 x layers x microbatches (the forward pass, and the
    backward's recompute of the stage forward, which the full remat runs
    once more), its backward layers x microbatches, and no other kernel
    (the stages run the unfused sub-blocks, as the reference's)."""
    launches = dict(ops.LAUNCHES)
    per_step = cfg.n_layers * dc.num_microbatches
    want = {name: 0 for name in launches}
    want.update(flash_attention=3 * per_step, flash_attention_bwd=per_step)
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(
            f"{prefix} {label}: launches {json.dumps(launches)} in "
            f"{n_steps} steps, expected {json.dumps(want)} a step")
    log(f"{prefix} {label}: launches in {n_steps} steps: "
        f"{json.dumps(launches)} (per step "
        f"{json.dumps({k: v for k, v in want.items() if v})})")
    return launches


def _pipe_small_check(pl, cfg, tps=(1, 1), dp=1,
                      params_tol=SMALL_FP32_TOL) -> dict:
    """fp32, 2 layers at full width, untied: the 2-stage pipeline
    ``even_stages(small, tps, dp)`` (its one-device stages graphed, its
    mesh stages eager, every position on the one card) against the
    single-device step from the same weights on the same batches, 3 steps
    (every program replayed by the third).  The first step's loss, each
    stage's gradients (of max |g|; a mesh stage's gathered whole) within
    SMALL_FP32_TOL, the updated params within ``params_tol`` (of max(1,
    |p|)), and every step's loss.  The
    single-device path fuses the seam (the fused-norm kernels), the
    pipeline's stages do not, so their gradients differ by rounding; from
    the second step on AdamW moves an element whose gradient is near zero
    by up to ~lr whatever the rounding did to it, so later params are
    printed, not held.  AdamW's clip is off: the pipeline clips each stage
    by its own norm (the reference's per-stage optimizer)."""
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param_dtype="float32")
    ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    ds = data_lib.SyntheticDataset(small, data_lib.DataConfig(**TRAIN_DATA))
    full = model_lib.init(small, 11, device="cuda")
    pipe = _pipe(pl, small, ocfg, full, None, tps, dp)
    ref = opt_lib.tree_unflatten((k, v.clone())
                                 for k, v in opt_lib.tree_leaves(full))
    state = opt_lib.init_state(ref)
    step = train_lib.make_train_step(small, ocfg)

    def rel_err(trees, flat, floor):
        worst = 0.0
        for st, tree in zip(pipe.stages, trees):
            for k, t in _stage_leaves(tree):
                w = _stage_slice(st, flat, k)
                worst = max(worst, (t - w).abs().max().item()
                            / max(floor, w.abs().max().item()))
        return worst

    b = ds.batch(200)
    loss, grads = pipe.grad_step(b)
    wl, wg = train_lib.loss_and_grads(small, ref, b)
    grad_err = rel_err(grads, dict(opt_lib.tree_leaves(wg)), 0.0)
    pipe.apply_grads(grads)
    rows = []
    for i in range(3):
        if i:
            b = ds.batch(200 + i)
            loss = pipe.train_step(b)
        _, _, m = step(ref, state, b)
        rows.append(dict(loss=loss, single=m["loss"].item(), params_err=rel_err(
            pipe.params, dict(opt_lib.tree_leaves(ref)), 1.0)))
        ok = abs(loss - m["loss"].item()) <= SMALL_FP32_TOL * abs(loss)
        if i == 0:
            rows[0].update(grad_err=grad_err,
                           loss_and_grads_loss=wl.item())
            ok &= grad_err <= SMALL_FP32_TOL and \
                rows[0]["params_err"] <= params_tol
        if not ok:
            raise AssertionError(f"[pipeline] fp32 2 layers {list(tps)} dp "
                                 f"{dp}, step {i + 1}: {rows[-1]} (tol "
                                 f"{SMALL_FP32_TOL}, params {params_tol})")
    return dict(tps=list(tps), dp=dp, steps=rows, tol=SMALL_FP32_TOL,
                params_tol=params_tol)


def _pipe_group_check(pl, cfg) -> dict:
    """Two 2-stage fp32 2-layer replicas on the card as an
    ``AdaptiveDPGroup``: a 2:1 assignment of [train]'s 8 sequences
    against the uniform one, PIPE_GROUP_STEPS steps on one repeated batch
    from the same weights; each step's group loss within PIPE_GROUP_TOL
    of the uniform one's (of its size), and the loss falls."""
    from repro_torch.core.planner.plan import BatchAssignment
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param_dtype="float32")
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(small, data_lib.DataConfig(**TRAIN_DATA))
    b = ds.batch(300)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in b.items()}
    full = model_lib.init(small, 12, device="cuda")
    gbs = TRAIN_DATA["global_batch"]
    runs = {}
    for label, assignment in (
            ("uniform", BatchAssignment.uniform(dp=2, mbs=gbs // 2,
                                                n_micro=1)),
            ("2:1", BatchAssignment.proportional([2.0, 1.0], gbs, 1))):
        assignment.validate(gbs)
        group = pl.AdaptiveDPGroup.from_assignment(
            [_pipe(pl, small, ocfg, full, None) for _ in range(2)],
            assignment)
        shards = pl.shard_batch_by_assignment(flat, assignment)
        runs[label] = dict(
            samples=[r.samples for r in assignment.replicas],
            losses=[group.train_step(shards)
                    for _ in range(PIPE_GROUP_STEPS)])
    uni, ad = runs["uniform"]["losses"], runs["2:1"]["losses"]
    if not all(abs(a - u) <= PIPE_GROUP_TOL * abs(u)
               for a, u in zip(ad, uni)) or not ad[-1] < ad[0]:
        raise AssertionError(f"[pipeline] AdaptiveDPGroup: 2:1 {ad} vs "
                             f"uniform {uni} (tol {PIPE_GROUP_TOL})")
    return dict(runs, tol=PIPE_GROUP_TOL)


def _pipe_position_bytes(pipe) -> list:
    """Each stage's resident bytes a position: its params, AdamW ``m`` and
    ``v`` and fp32 gradient buffers (a mesh stage's blocks a position)."""
    from repro_torch.dist import placement as pm
    rows = []
    for st, mesh, p, o, acc in zip(pipe.stages, pipe.meshes, pipe.params,
                                   pipe.opt_states, pipe._acc):
        per = [0] * mesh.size
        for tree in (p, o["m"], o["v"], acc):
            for _, x in pm.tree_items(tree):
                blocks = x.blocks if isinstance(x, pm.Sharded) else [x]
                for pos, blk in enumerate(blocks):
                    per[pos] += blk.numel() * blk.element_size()
        rows.append(dict(stage=st.index, mesh=dict(mesh.shape),
                         layers=[st.start, st.stop],
                         resident_bytes_per_position=per))
    return rows


def _pipe_mesh_case(pl, cfg, dc, ocfg, batches, full, one_wall) -> dict:
    """Mesh stages at full width: ``even_stages(cfg, [2, 1])``, stage 0 on
    a (1, 2) ``fsdp_tp`` mesh, every position on the one card, graphed
    (``graphed=True``: both stages, the mesh stage too) and eager from the
    same weights in turns: the first step's gradients, every loss and,
    after every step, every stage's params and AdamW state bit for bit;
    the first step's loss and gradients (gathered whole) against the
    single-device ``loss_and_grads`` (phase 8's bounds) and against the
    ``[1, 1]`` pipeline's first step on the same weights; the loss falling
    over PIPE_LEARN steps; PIPE_MESH_TIMED pairs timed in turns beside the
    ``[1, 1]`` pipeline's eager step; each side profiled; the launches a
    step (each position the attention forward 3 x its layers x
    microbatches, its backward layers x microbatches, no fused norm; the
    same on both sides); the resident bytes a position.  Returns the
    launches over the mesh pipelines' steps."""
    label = f"{list(PIPE_MESH_TPS)} {PIPE_MESH_POLICY}"
    sides = dict(graphed=_pipe(pl, cfg, ocfg, full, True, PIPE_MESH_TPS),
                 eager=_pipe(pl, cfg, ocfg, full, False, PIPE_MESH_TPS))
    if any(g is None for g in sides["graphed"].graphs) or any(
            g is not None for g in sides["eager"].graphs):
        raise AssertionError(f"[pipeline] {label}: graphed=True must graph "
                             f"every stage, the mesh stage too, and "
                             f"graphed=False none")
    mesh = sides["eager"]
    log(f"[pipeline] {label} memory: "
        + json.dumps(_pipe_position_bytes(mesh)))

    def same(i):
        g, e = sides["graphed"], sides["eager"]
        ok = all(_blocks_equal(a, b) for a, b in zip(
            g.params + g.opt_states, e.params + e.opt_states))
        if not ok:
            raise AssertionError(f"[pipeline] {label}: graphed vs eager "
                                 f"after step {i + 1}: params or state "
                                 f"differ")

    ops.reset_launches()
    firsts = {}
    for name, pipe in sides.items():
        loss, grads = pipe.grad_step(batches[0])
        firsts[name] = (loss, [{k: t.clone() for k, t in _stage_leaves(g)}
                               for g in grads])
        pipe.apply_grads(grads)
    gl, first = firsts["eager"]
    if firsts["graphed"][0] != gl or not all(
            torch.equal(a[k], b[k]) for a, b in zip(firsts["graphed"][1],
                                                    first) for k in b):
        raise AssertionError(f"[pipeline] {label}: the first step's loss or "
                             f"gradients differ graphed vs eager")
    del firsts
    same(0)
    learn = []
    for i in range(PIPE_LEARN):
        le = sides["eager"].train_step(batches[PIPE_STEPS])
        lg = sides["graphed"].train_step(batches[PIPE_STEPS])
        if lg != le:
            raise AssertionError(f"[pipeline] {label}: loss {lg} graphed vs "
                                 f"{le} eager")
        same(1 + i)
        learn.append(le)
    if not all(np.isfinite(learn)) or not learn[-1] < learn[0]:
        raise AssertionError(f"[pipeline] {label}: losses {learn}: not "
                             f"finite, or the last is not below the first")
    rows = dict(eager=[], graphed=[])
    for i in range(PIPE_MESH_TIMED):
        for name in ("eager", "graphed"):
            pipe = sides[name]
            rows[name].append(_timed_step(
                lambda: pipe.train_step(batches[PIPE_STEPS + 1 + i])))
        if rows["graphed"][-1][3] != rows["eager"][-1][3]:
            raise AssertionError(f"[pipeline] {label}: timed loss graphed vs "
                                 f"eager differ")
        same(1 + PIPE_LEARN + i)
    walls = {k: statistics.median(r[0] for r in v) for k, v in rows.items()}
    n_steps = 2 * (1 + PIPE_LEARN + PIPE_MESH_TIMED)
    launches = dict(ops.LAUNCHES)
    dev_ms = {name: profile_window(
        "pipeline_mesh_step" if name == "eager"
        else "pipeline_mesh_step_graphed",
        lambda: sides[name].train_step(batches[-1]), walls[name], 1)
        for name in ("eager", "graphed")}
    want = {name: 0 for name in launches}
    for st in mesh.stages:
        n = st.n_layers * dc.num_microbatches * st.n_devices
        want["flash_attention"] += 3 * n
        want["flash_attention_bwd"] += n
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(
            f"[pipeline] {label}: launches {json.dumps(launches)} in "
            f"{n_steps} steps, expected {json.dumps(want)} a step")
    capture_s = sum(sum(g.capture_seconds.values())
                    for g in sides["graphed"].graphs)
    del mesh, sides
    _release()
    # the first step against loss_and_grads and the [1, 1] pipeline's
    wl, wg = train_lib.loss_and_grads(cfg, full, batches[0])
    wl = wl.item()
    flat = dict(opt_lib.tree_leaves(wg))
    del wg
    one = _pipe(pl, cfg, ocfg, full, False)
    ol, og = one.grad_step(batches[0])
    ones = [dict(opt_lib.tree_leaves(g)) for g in og]
    stages = pl.even_stages(cfg, list(PIPE_MESH_TPS))
    worst = dict(single=0.0, one_device=0.0)
    min_cos = dict(single=1.0, one_device=1.0)
    for st, g in zip(stages, first):
        for k, t in g.items():
            for kind, w in (("single", _stage_slice(st, flat, k)),
                            ("one_device", ones[st.index][k])):
                rel = ((t - w).abs().max() / w.abs().max()).item()
                cos = _cosine(t, w)
                worst[kind] = max(worst[kind], rel)
                min_cos[kind] = min(min_cos[kind], cos)
                if not (rel <= TRAIN_GRAD_TOL and cos >= TRAIN_COSINE):
                    raise AssertionError(
                        f"[pipeline] {label} stage {st.index} grad {k} vs "
                        f"{kind}: max |dg| / max |g| {rel:.3e}, cosine "
                        f"{cos:.6f}")
    for kind, ref in (("single", wl), ("one_device", ol)):
        if not abs(gl - ref) <= TRAIN_LOSS_TOL * abs(ref):
            raise AssertionError(f"[pipeline] {label}: first-step loss {gl} "
                                 f"vs {kind} {ref}")
    del first, flat, ones, og
    log(f"[pipeline] {label} first step vs the single-device loss_and_grads "
        f"and the [1, 1] pipeline (same untied weights and batch): "
        + json.dumps(dict(loss=gl, single_loss=wl, one_device_loss=ol,
                          max_rel_grad_err=worst, min_cosine=min_cos,
                          tol=TRAIN_GRAD_TOL, cosine_min=TRAIN_COSINE)))
    # the [1, 1] pipeline's eager step in the same call
    one_rows = [_timed_step(lambda: one.train_step(
        batches[PIPE_STEPS + 1 + i]))[:2] for i in range(PIPE_MESH_TIMED)]
    one_eager = statistics.median(r[0] for r in one_rows)
    del one
    tokens = dc.global_batch * dc.seq_len
    stats = dict(
        tps=list(PIPE_MESH_TPS), policy=PIPE_MESH_POLICY, losses_learn=learn,
        graphed_bit_identical=True, capture_s=capture_s,
        one_device_eager_step_wall_ms=one_eager,
        one_device_eager_step_device_ms=statistics.median(
            r[1] for r in one_rows),
        one_device_graphed_step_wall_ms=one_wall,
        launches_per_step={k: v // n_steps for k, v in launches.items()
                           if v})
    for name, rs in rows.items():
        wall = walls[name]
        stats[name] = dict(
            timed_losses=[r[3] for r in rs], step_wall_ms=wall,
            step_wall_ms_all=[r[0] for r in rs],
            step_device_ms=statistics.median(r[1] for r in rs),
            working_set_gib=max(r[2] for r in rs) / 2**30,
            tokens_per_s=tokens / (wall / 1e3),
            ratio_to_one_device_eager=wall / one_eager)
        if dev_ms[name] is not None:
            stats[name].update(profiled_device_ms=dev_ms[name],
                               busy=dev_ms[name] / wall)
    stats["eager_over_graphed_wall"] = walls["eager"] / walls["graphed"]
    log(f"[pipeline] {label} (smollm-360M untied, stages of "
        f"{[s.n_layers for s in stages]} layers on one card, graphed and "
        f"eager in turns): " + json.dumps(stats))
    return launches


def phase_pipeline(train: dict) -> dict:
    """The MPMD pipeline that executes Sailor's plans
    (``dist/pipeline.py``) at smollm-360M's published widths and depth,
    bf16, untied, two stages of 16 layers on the one card in turn, as CUDA
    graphs (one a stage, program and shape) and eagerly from the same
    weights on [train]'s data: graphed vs eager bit for bit, the first
    step's loss and gradients against the single-device
    ``loss_and_grads``, the loss falling, timed in turns, profiled, each
    stage's memory; then an fp32 2-layer pipeline against the
    single-device step and an ``AdaptiveDPGroup`` of two replicas.  Then
    the mesh stages (``_pipe_mesh_case``) and their fp32 checks.  A main
    path for the attention kernels, forward and backward.  Returns the
    launches over the bf16 ``[1, 1]`` pipelines' steps and over the mesh
    stages' pipeline's."""
    from repro_torch.dist import pipeline as pl
    cfg = _pipe_cfg()
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(100 + i) for i in range(PIPE_STEPS + 1 + PIPE_PAIRS
                                                + 2)]
    full = model_lib.init(cfg, 5, device="cuda")
    graphed, eager = _pipe(pl, cfg, ocfg, full, None), \
        _pipe(pl, cfg, ocfg, full, False)
    ops.reset_launches()
    # (a) graphed vs eager from the same weights; the graphed first step
    # as grad_step + apply_grads, its gradients kept for (e)
    rows, same = [], True
    first = None
    for i in range(PIPE_STEPS):
        b = batches[i]
        t0 = time.perf_counter()
        if i == 0:
            gl, gg = graphed.grad_step(b)
            first = (gl, [{k: t.clone() for k, t in opt_lib.tree_leaves(g)}
                          for g in gg])
            graphed.apply_grads(gg)
        else:
            gl = graphed.train_step(b)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        el = eager.train_step(b)
        diff, ident = _pipe_param_diff(graphed, eager)
        same &= ident and gl == el
        rows.append(dict(step=i + 1, graphed_loss=gl, eager_loss=el,
                         params_max_abs_diff=diff, graphed_call_s=g_s))
        if not (abs(gl - el) <= TRAIN_LOSS_TOL * abs(el)):
            raise AssertionError(f"[pipeline] step {i + 1}: graphed loss "
                                 f"{gl} vs eager {el}")
    if not same:
        raise AssertionError(f"[pipeline] graphed vs eager not bit-identical "
                             f"after {PIPE_STEPS} steps: {rows}")
    log(f"[pipeline] graphed vs eager: " + json.dumps(dict(
        steps=rows, bit_identical=same,
        graphs={i: sorted(str(k[0]) for k in g.graphs)
                for i, g in enumerate(graphed.graphs)},
        capture_s={i: sum(g.capture_seconds.values())
                   for i, g in enumerate(graphed.graphs)})))
    # (b) the loss falls over PIPE_LEARN steps on one repeated batch
    learn = [graphed.train_step(batches[PIPE_STEPS])
             for _ in range(PIPE_LEARN)]
    if not all(np.isfinite(learn)) or not learn[-1] < learn[0]:
        raise AssertionError(f"[pipeline] losses {learn}: not finite, or "
                             f"the last is not below the first")
    # (c) timed in turns, graphed and eager, each on its own weights
    runs = {"eager": [], "graphed": []}
    pipes = {"eager": eager, "graphed": graphed}
    for j in range(PIPE_PAIRS):
        b = batches[PIPE_STEPS + 1 + j]
        order = ("eager", "graphed") if j % 2 == 0 else ("graphed", "eager")
        for kind in order:
            wall, dev, _, loss = _timed_step(
                lambda: pipes[kind].train_step(b))
            runs[kind].append((wall, dev, loss))
    n_graphed = PIPE_STEPS + PIPE_LEARN + PIPE_PAIRS
    n_eager = PIPE_STEPS + PIPE_PAIRS
    tokens = dc.global_batch * dc.seq_len
    turns = {}
    for kind, r in runs.items():
        wall = statistics.median(x[0] for x in r)
        turns[kind] = dict(step_wall_ms=wall,
                           step_wall_ms_all=[x[0] for x in r],
                           step_device_ms=statistics.median(x[1] for x in r),
                           tokens_per_s=tokens / (wall / 1e3),
                           losses=[x[2] for x in r])
    g_wall = turns["graphed"]["step_wall_ms"]
    train_wall = train["graphed"]["step_wall_ms"]
    log(f"[pipeline] in turns ({PIPE_PAIRS} pairs; smollm-360M untied, "
        f"{cfg.n_layers} layers as 2 stages of {cfg.n_layers // 2} on one "
        f"card, {dc.num_microbatches} x ({dc.micro_batch} x {dc.seq_len}) "
        f"tokens, full remat, bf16): " + json.dumps(dict(
            turns, losses_learn=learn,
            wall_speedup=turns["eager"]["step_wall_ms"] / g_wall,
            train_graphed_step_wall_ms=train_wall,
            ratio_to_train_graphed=g_wall / train_wall)))
    # (d) one graphed step profiled
    dev_ms = profile_window(
        "pipeline_step", lambda: graphed.train_step(batches[-1]), g_wall, 1,
        breakdown=True)
    launches = _pipe_launch_check("graphed and eager", cfg, dc,
                                  n_graphed + n_eager + 1)
    log("[pipeline] per-stage memory (eager step; working set = the most "
        "one stage program allocated above what was allocated before it): "
        + json.dumps(_pipe_stage_memory(eager, batches[-2])))
    # (e) the first step against the single-device loss_and_grads
    wl, wg = train_lib.loss_and_grads(cfg, full, batches[0])
    wl = wl.item()
    flat = dict(opt_lib.tree_leaves(wg))
    gl, grads = first
    worst, min_cos = 0.0, 1.0
    for st, g in zip(graphed.stages, grads):
        for k, t in g.items():
            w = _stage_slice(st, flat, k)
            rel = ((t - w).abs().max() / w.abs().max()).item()
            cos = _cosine(t, w)
            worst, min_cos = max(worst, rel), min(min_cos, cos)
            if not (rel <= TRAIN_GRAD_TOL and cos >= TRAIN_COSINE):
                raise AssertionError(
                    f"[pipeline] stage {st.index} grad {k} vs single device: "
                    f"max |dg| / max |g| {rel:.3e}, cosine {cos:.6f}")
    if not abs(gl - wl) <= TRAIN_LOSS_TOL * abs(wl):
        raise AssertionError(f"[pipeline] first-step loss {gl} vs single "
                             f"device {wl}")
    del grads, first, wg, flat
    log("[pipeline] first step vs the single-device loss_and_grads (same "
        "untied weights and batch): " + json.dumps(dict(
            loss=gl, single_loss=wl, max_rel_grad_err=worst,
            min_cosine=min_cos, tol=TRAIN_GRAD_TOL,
            cosine_min=TRAIN_COSINE)))
    del graphed, eager
    torch.cuda.empty_cache()
    # (f) mesh stages at full width, from the same weights; its own launch
    # window (set to 0 inside, read after its steps)
    mesh_launches = _pipe_mesh_case(pl, cfg, dc, ocfg, batches, full, g_wall)
    del full
    torch.cuda.empty_cache()
    # (g) fp32 2 layers against the single-device step, one-device stages
    # and mesh stages; (h) the DP group
    log("[pipeline] fp32 2 layers vs make_train_step: "
        + json.dumps(_pipe_small_check(pl, cfg)))
    for tps, dp in PIPE_MESH_SMALL:
        log(f"[pipeline] fp32 2 layers {list(tps)} dp {dp} vs "
            f"make_train_step: " + json.dumps(_pipe_small_check(
                pl, cfg, tps, dp, PIPE_MESH_PARAMS_TOL)))
    log("[pipeline] AdaptiveDPGroup, fp32 2 layers, 2 replicas of 2 "
        "stages: " + json.dumps(_pipe_group_check(pl, cfg)))
    if dev_ms is not None:
        log(f"[pipeline] device ms of a graphed step {dev_ms:.3f}, busy "
            f"{dev_ms / g_wall:.3f}")
    return launches, mesh_launches


def _mesh_of(shape):
    from repro_torch.dist.mesh import data_model_mesh
    n = shape[0] * shape[1]
    return data_model_mesh(*shape, [torch.device("cuda", 0)] * n)


def _mesh_replicas_equal(*trees) -> bool:
    """Every replica of every block of ``trees`` equal bit for bit."""
    from repro_torch.dist import placement as pm
    for tree in trees:
        for _, x in pm.tree_items(tree):
            for group in x.mesh.groups(pm.replica_axes(x.spec, x.mesh)):
                if not all(torch.equal(x.blocks[p], x.blocks[group[0]])
                           for p in group[1:]):
                    return False
    return True


def _mesh_memory(cfg, mesh, params, state, data=TRAIN_DATA) -> dict:
    """Each position's elements and resident bytes (its params, ``m`` and
    ``v`` blocks) beside the simulator's ``params / tp`` for the same
    (dp, tp) (``core/simulator/memory.py``: ``M_model = params / tp *
    mul_factor``, the fp32 gradient included) and the declared params /
    tp."""
    from repro_torch.core.simulator.memory import DEFAULT_MEM
    from repro_torch.dist import placement as pm
    tp = mesh.shape["model"]
    prof = JobProfile(TrainJob(cfg, seq_len=data["seq_len"],
                               global_batch=data["global_batch"]))
    total = prof.stage_params(0, len(prof.layer_kinds()))
    declared = sum(math.prod(x.shape) for _, x in pm.tree_items(params))
    rows = []
    for p in range(mesh.size):
        elems = sum(x.blocks[p].numel() for _, x in pm.tree_items(params))
        resident = sum(x.blocks[p].numel() * x.blocks[p].element_size()
                       for tree in (params, state["m"], state["v"])
                       for _, x in pm.tree_items(tree))
        rows.append(dict(position=mesh.coords(p), elements=elems,
                         resident_bytes=resident,
                         with_fp32_grad_bytes=elems * DEFAULT_MEM.mul_factor))
    return dict(per_position=rows, params=total, params_over_tp=total / tp,
                declared_params=declared, declared_over_tp=declared / tp,
                ratio=rows[0]["elements"] / (total / tp),
                sim_m_model_bytes=total / tp * DEFAULT_MEM.mul_factor,
                mul_factor=DEFAULT_MEM.mul_factor)


def _mesh_launch_check(label: str, cfg, dc, mesh, n_steps: int) -> dict:
    """The launches counted since the last reset: per step and position,
    the attention forward and the fused norm 2 x layers x microbatches
    (the forward runs again under remat), each backward layers x
    microbatches, every other kernel none."""
    launches = dict(ops.LAUNCHES)
    per = cfg.n_layers * dc.num_microbatches * mesh.size
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * per, fused_add_rmsnorm=2 * per,
                flash_attention_bwd=per, fused_add_rmsnorm_bwd=per)
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(
            f"[mesh] {label}: launches {json.dumps(launches)} in {n_steps} "
            f"steps, expected {json.dumps(want)} a step")
    return launches


def _mesh_grads(label, cfg, mesh, params, full, batch) -> dict:
    """The first step's loss and gradients on the mesh (unsharded leaf by
    leaf) against the single-device ``loss_and_grads`` on the same
    weights and batch, at ``[pipeline]``'s bounds."""
    from repro_torch.dist import placement as pm
    gl, gg = train_lib.loss_and_grads(cfg, params, batch, mesh=mesh)
    wl, wg = train_lib.loss_and_grads(cfg, full, batch)
    flat = dict(opt_lib.tree_leaves(wg))
    worst, min_cos = 0.0, 1.0
    for k, x in pm.tree_items(gg):
        t, w = pm.unshard(x, "cuda"), flat[k]
        rel = ((t - w).abs().max() / w.abs().max()).item()
        cos = _cosine(t, w)
        worst, min_cos = max(worst, rel), min(min_cos, cos)
        if not (rel <= TRAIN_GRAD_TOL and cos >= TRAIN_COSINE):
            raise AssertionError(f"[mesh] {label} grad {k} vs single device: "
                                 f"max |dg| / max |g| {rel:.3e}, cosine "
                                 f"{cos:.6f}")
    if not abs(gl.item() - wl.item()) <= TRAIN_LOSS_TOL * abs(wl.item()):
        raise AssertionError(f"[mesh] {label}: loss {gl.item()} vs single "
                             f"device {wl.item()}")
    return dict(loss=gl.item(), single_loss=wl.item(), max_rel_grad_err=worst,
                min_cosine=min_cos, tol=TRAIN_GRAD_TOL,
                cosine_min=TRAIN_COSINE)


def _blocks_equal(a, b) -> bool:
    """Every block (or tensor) of two trees of ``Sharded`` or tensors equal
    bit for bit."""
    from repro_torch.dist import placement as pm

    def blocks(tree):
        return [b for _, x in pm.tree_items(tree)
                for b in (x.blocks if isinstance(x, pm.Sharded) else [x])]
    xs, ys = blocks(a), blocks(b)
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


def _mesh_sides_equal(label, i, eager, graphed) -> None:
    """Raise unless the graphed side's (params, state, metrics) after step
    ``i`` equal the eager side's bit for bit: params, ``m``, ``v``, the
    step, loss and grad_norm."""
    (ep, es, em), (gp, gs, gm) = eager, graphed
    same = dict(params=_blocks_equal(gp, ep), m=_blocks_equal(gs["m"],
                                                              es["m"]),
                v=_blocks_equal(gs["v"], es["v"]),
                step=_blocks_equal({"s": gs["step"]}, {"s": es["step"]}),
                loss=torch.equal(gm["loss"], em["loss"]),
                grad_norm=torch.equal(gm["grad_norm"], em["grad_norm"]))
    if not all(same.values()):
        raise AssertionError(f"{label}: graphed vs eager after step {i + 1}"
                             f" not bit for bit: {same}")


def _mesh_side(label, cfg, ocfg, mesh, full, data_cfg, graphed: bool):
    """``full``'s weights laid out on ``mesh``, a fresh AdamW state and
    ``jit_train_step(..., graphed=graphed)`` for them: [params, state,
    step]."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg),
                                             cfg.sharding, mesh), mesh)
    step = train_lib.jit_train_step(cfg, ocfg, mesh,
                                    data_cfg.num_microbatches,
                                    data_cfg.micro_batch, graphed=graphed)
    if step.graphed is not graphed:
        raise AssertionError(f"{label}: graphed={graphed} gave "
                             f"{step.graphed}")
    return [params, opt_lib.init_sharded_state(params), step]


def _fingerprint(t: torch.Tensor) -> tuple:
    """Two sums over a tensor's 32-bit words as int64 (plain, and each
    word times its index mod 8191): equal tensors give equal pairs, and a
    changed bit changes them."""
    w = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    idx = torch.arange(w.numel(), device=w.device) % 8191
    return int(w.sum()), int((w * idx).sum())


def _side_snapshot(side) -> dict:
    """What ``_steps_in_turns(..., apart=True)`` holds one side's end state
    by: params and the step, every block copied to the host; ``m`` and
    ``v`` by ``_fingerprint`` a block (their 4 fp32 bytes a parameter
    twice over do not fit beside a second model)."""
    from repro_torch.dist import placement as pm
    params, state, _ = side
    out = {}
    for name, tree in (("params", params), ("step", {"s": state["step"]})):
        for k, x in pm.tree_items(tree):
            out[f"{name}/{k}"] = [b.cpu() for b in x.blocks]
    for name in ("m", "v"):
        for k, x in pm.tree_items(state[name]):
            out[f"{name}/{k}"] = [_fingerprint(b) for b in x.blocks]
    return out


def _snapshots_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(
            torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(a[k], b[k])) for k in a)


def _steps_in_turns(label, cfg, dc, mesh, full, batches, graphed,
                    record_first=False, apart=False) -> dict:
    """A step of ``jit_train_step`` (``dc``'s shape) on each of
    ``batches`` from ``full``'s weights laid out on ``mesh``: eager
    (``graphed=False``), timed, the first under the collective record
    with ``record_first``;
    with ``graphed``, a graphed side (``graphed=True``) from the same
    weights, timed, a step's launches, loss and grad_norm equal to the
    eager step's: in turns, every side's params, ``m``, ``v`` and step
    held bit for bit after every step; ``apart`` (a model whose two
    copies do not fit on the card), the eager side's n steps first and
    the graphed side's after it, their end states held by
    ``_side_snapshot``.  Returns each side ([params, state, step]; the
    eager one None with ``apart``), whether the eager side's replicas are
    equal, each side's rows (wall, device ms, working set, loss, grad
    norm), the eager steps' launches, the record's entries, the launches
    over every step and the capture's seconds."""
    from repro_torch.dist import placement as pm
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    n = len(batches)
    rows = {"eager": [], "graphed": []}
    per_step, metrics, total = [], [], {}
    entries: list = []

    def one(side, name, i):
        params, state, step = side
        batch = batches[i]
        ops.reset_launches()
        with (pm.record_collectives() if record_first and i == 0
              and name == "eager" else contextlib.nullcontext()) as rec:
            wall, dev, extra, (side[0], side[1], m) = _timed_step(
                lambda: step(params, state, batch))
        if rec is not None:
            entries.extend(rec.entries)
        rows[name].append((wall, dev, extra, m["loss"].item(),
                           m["grad_norm"].item()))
        launches = dict(ops.LAUNCHES)
        _add_counts(total, launches)
        return m, launches

    def held(i, m, launches):
        """Raise unless the graphed step ``i`` matches the eager one."""
        em, el = metrics[i], per_step[i]
        if launches != el:
            raise AssertionError(f"{label}: step {i + 1} launched "
                                 f"{json.dumps(launches)} graphed, "
                                 f"{json.dumps(el)} eager")
        if not (torch.equal(m["loss"], em["loss"])
                and torch.equal(m["grad_norm"], em["grad_norm"])):
            raise AssertionError(f"{label}: step {i + 1} graphed loss or "
                                 f"grad_norm differs from eager")

    eager = _mesh_side(label, cfg, ocfg, mesh, full, dc, False)
    gside = None if apart or not graphed else _mesh_side(
        label, cfg, ocfg, mesh, full, dc, True)
    for i in range(n):
        m, launches = one(eager, "eager", i)
        per_step.append(launches)
        metrics.append({k: m[k].clone() for k in ("loss", "grad_norm")})
        if gside is not None:
            gm, gl = one(gside, "graphed", i)
            held(i, gm, gl)
            _mesh_sides_equal(label, i, (eager[0], eager[1], m),
                              (gside[0], gside[1], gm))
    replicas = _mesh_replicas_equal(eager[0], eager[1]["m"], eager[1]["v"])
    out = dict(eager=eager, replicas=replicas,
               rows={k: v for k, v in rows.items() if v or graphed},
               per_step=per_step, entries=entries, total=total,
               capture_s=None)
    if apart and graphed:
        want = _side_snapshot(eager)
        out.update(eager=None)
        del eager, m
        _release()
        gside = _mesh_side(label, cfg, ocfg, mesh, full, dc, True)
        for i in range(n):
            held(i, *one(gside, "graphed", i))
        if not _snapshots_equal(_side_snapshot(gside), want):
            raise AssertionError(f"{label}: the graphed side's params, m, v "
                                 f"or step after {n} steps differ from the "
                                 f"eager side's")
    if graphed:
        gp, gs, gstep = gside
        if not _mesh_replicas_equal(gp, gs["m"], gs["v"]):
            raise AssertionError(f"{label}: graphed replicas differ")
        out.update(capture_s=gstep.capture_seconds, graphed=gside)
    return out


def _graphed_stats(got: dict, tokens: int) -> dict:
    """The graphed side's replays (the calls after the warm one and the
    capture) beside the eager steps at the same positions."""
    g = got["rows"]["graphed"][2:]
    e = got["rows"]["eager"][2:]
    gw = statistics.median(r[0] for r in g)
    ew = statistics.median(r[0] for r in e)
    return dict(replays=len(g), graphed_bit_identical=True,
                capture_s=got["capture_s"],
                graphed_step_wall_ms=gw,
                graphed_step_wall_ms_all=[r[0] for r in g],
                graphed_step_device_ms=statistics.median(r[1] for r in g),
                graphed_tokens_per_s=tokens / (gw / 1e3),
                eager_same_steps_wall_ms=ew, eager_over_graphed_wall=ew / gw)


def _mesh_case(policy, shape, full, batches, train) -> dict:
    """One mesh at full width: the first step against the single device;
    then the graphed and the eager ``jit_train_step`` from the same
    weights on the same batches in turns (MESH_LEARN steps on one batch,
    the loss falling; MESH_TIMED pairs timed), bit for bit after every
    step, a step's launches equal on both sides; replicas bit for bit,
    the launches, each side's median wall beside [train]'s eager step,
    each side profiled (device ms, busy), the capture's seconds, each
    position's memory.  Returns the launches over the mesh's steps, and
    the graphed side's profiled replay: its launches and collective
    record, and its capture's record."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    cfg = dataclasses.replace(get_config(ARCH), remat="full",
                              sharding=policy)
    dc = data_lib.DataConfig(**TRAIN_DATA)
    mesh = _mesh_of(shape)
    label = f"{shape[0]}x{shape[1]} {policy}"
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg), policy,
                                             mesh), mesh)
    state = opt_lib.init_sharded_state(params)
    log(f"[mesh] {label} memory: "
        + json.dumps(_mesh_memory(cfg, mesh, params, state)))
    first = _mesh_grads(label, cfg, mesh, params, full, batches[0])
    log(f"[mesh] {label} first step vs the single-device loss_and_grads "
        f"(same weights and batch): " + json.dumps(first))
    del params, state
    got = _steps_in_turns(f"[mesh] {label}", cfg, dc, mesh, full,
                          [batches[0]] * MESH_LEARN
                          + batches[1:1 + MESH_TIMED], graphed=True)
    learn = [r[3] for r in got["rows"]["eager"][:MESH_LEARN]]
    if not all(np.isfinite(learn)) or not learn[-1] < learn[0]:
        raise AssertionError(f"[mesh] {label}: losses {learn}: not finite, "
                             f"or the last is not below the first")
    n_steps = MESH_LEARN + MESH_TIMED
    ops.LAUNCHES.update(got["total"])
    launches = _mesh_launch_check(label, cfg, dc, mesh, 2 * n_steps)
    (ep, es, estep), (gp, gs, gstep) = got["eager"], got["graphed"]
    same = got["replicas"] and _mesh_replicas_equal(gp, gs["m"], gs["v"])
    if not same:
        raise AssertionError(f"[mesh] {label}: replicas of a block differ "
                             f"after {n_steps} steps")
    train_wall = train["eager"]["step_wall_ms"]
    tokens = dc.global_batch * dc.seq_len
    stats = dict(mesh=dict(mesh.shape), policy=policy, losses_learn=learn,
                 train_eager_step_wall_ms=train_wall,
                 capture_s=gstep.capture_seconds,
                 capture_launches=gstep.graph_step.capture_launches,
                 capture_record_entries=len(
                     gstep.graph_step.capture_collectives),
                 launches_per_step={k: v // (2 * n_steps)
                                    for k, v in launches.items() if v},
                 replicas_bit_identical=same, graphed_bit_identical=True)
    walls = {}
    for name, rows in got["rows"].items():
        rows = rows[MESH_LEARN:]
        wall = statistics.median(r[0] for r in rows)
        walls[name] = wall
        stats[name] = dict(
            timed_losses=[r[3] for r in rows], step_wall_ms=wall,
            step_wall_ms_all=[r[0] for r in rows],
            step_device_ms=statistics.median(r[1] for r in rows),
            working_set_gib=max(r[2] for r in rows) / 2**30,
            tokens_per_s=tokens / (wall / 1e3),
            ratio_to_train_eager=wall / train_wall)
    stats["eager_over_graphed_wall"] = walls["eager"] / walls["graphed"]
    log(f"[mesh] {label} graphed and eager in turns: " + json.dumps(stats))
    sfx = f"{shape[0]}x{shape[1]}"
    for name, (p, st, step) in (("eager", got["eager"]),
                                ("graphed", got["graphed"])):
        ops.reset_launches()
        with pm.record_collectives() as record:
            dev_ms = profile_window(
                f"mesh_step_{sfx}" if name == "eager"
                else f"mesh_step_graphed_{sfx}",
                lambda: step(p, st, batches[-1]), walls[name], 1)
        if dev_ms is not None:
            log(f"[mesh] {label}: device ms of a {name} step {dev_ms:.3f}, "
                f"busy {dev_ms / walls[name]:.3f}")
    # the profiled replay's launches and record: [dryrun] holds them
    # against the replayed fake trace of this cell
    return launches, dict(launches=dict(ops.LAUNCHES),
                          entries=record.entries,
                          capture_entries=gstep.graph_step.capture_collectives)


def _mesh_small_check() -> dict:
    """fp32, 2 layers at full width on (2, 2) ``fsdp_tp``, through the
    kernels: the sharded step against ``make_train_step`` from the same
    weights on the same batches, MESH_SMALL_STEPS steps: every step's
    loss, and after the first its gradients (of max |g|) and params (of
    max(1, |p|)) within SMALL_FP32_TOL; later params are printed (AdamW
    moves an element with a near-zero gradient by ~lr whatever the
    rounding, ``_pipe_small_check``)."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    small = dataclasses.replace(get_config(ARCH), n_layers=2,
                                dtype="float32", param_dtype="float32",
                                remat="full", sharding="fsdp_tp")
    ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1)
    ds = data_lib.SyntheticDataset(small, data_lib.DataConfig(**TRAIN_DATA))
    mesh = _mesh_of((2, 2))
    full = model_lib.init(small, 13, device="cuda")
    params = pm.shard_tree(full, param_specs(model_lib.decls(small),
                                             "fsdp_tp", mesh), mesh)
    state = opt_lib.init_sharded_state(params)
    ref_state = opt_lib.init_state(full)
    b = ds.batch(400)
    gl, gg = train_lib.loss_and_grads(small, params, b, mesh=mesh)
    wl, wg = train_lib.loss_and_grads(small, full, b)
    flat = dict(opt_lib.tree_leaves(wg))
    grad_err = max(((pm.unshard(x, "cuda") - flat[k]).abs().max()
                    / flat[k].abs().max()).item()
                   for k, x in pm.tree_items(gg))
    del gg, wg, flat
    step = train_lib.jit_train_step(small, ocfg, mesh, 2,
                                    TRAIN_DATA["global_batch"] // 2)
    one = train_lib.make_train_step(small, ocfg)
    rows = []
    for i in range(MESH_SMALL_STEPS):
        bi = b if i == 0 else ds.batch(400 + i)
        params, state, m2 = step(params, state, bi)
        full, ref_state, m1 = one(full, ref_state, bi)
        got = dict(opt_lib.tree_leaves(pm.unshard_tree(params, "cuda")))
        perr = max(((got[k] - w).abs().max()
                    / max(1.0, w.abs().max().item())).item()
                   for k, w in opt_lib.tree_leaves(full))
        rows.append(dict(loss=m2["loss"].item(), single=m1["loss"].item(),
                         params_err=perr))
        ok = abs(rows[-1]["loss"] - rows[-1]["single"]) <= \
            SMALL_FP32_TOL * abs(rows[-1]["single"])
        if i == 0:
            rows[0].update(grad_err=grad_err, loss_and_grads=gl.item(),
                           single_loss_and_grads=wl.item())
            ok &= grad_err <= SMALL_FP32_TOL and perr <= SMALL_FP32_TOL
        if not ok:
            raise AssertionError(f"[mesh] fp32 2 layers, step {i + 1}: "
                                 f"{rows[-1]} (tol {SMALL_FP32_TOL})")
    if not _mesh_replicas_equal(params, state["m"], state["v"]):
        raise AssertionError("[mesh] fp32 2 layers: replicas differ")
    return dict(steps=rows, tol=SMALL_FP32_TOL)


def phase_mesh(train: dict) -> dict:
    """The sharded (data, model) train step (``train_step.jit_train_step``
    over ``dist/spmd.py``) at smollm-360M's published widths and depth,
    bf16, on two meshes whose positions are all ``cuda:0``: (2, 2)
    ``fsdp_tp`` (FFN, vocab and 'embed' sharded, attention replicated)
    and (1, 5) ``tp`` (3/1 heads, d_ff 512 a position, vocab replicated),
    graphed and eager in turns, bit for bit (``_mesh_case``); then an
    fp32 2-layer model on (2, 2) against ``make_train_step``.  Returns the
    launches over the bf16 meshes' steps and the (2, 2) graphed step's
    profiled replay (its launches and record, for [dryrun]).  A
    main path for the attention and fused-norm kernels, forward and
    backward."""
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(500 + i) for i in range(MESH_TIMED + 2)]
    full = model_lib.init(cfg, 0, device="cuda")     # [train]'s weights
    total: dict = {}
    replays = {}
    for policy, shape in MESH_CASES:
        launches, replays[policy, shape] = _mesh_case(policy, shape, full,
                                                      batches, train)
        _add_counts(total, launches)
        _release()
    del full
    log("[mesh] fp32 2 layers on (2, 2) fsdp_tp vs make_train_step: "
        + json.dumps(_mesh_small_check()))
    return total, replays[("fsdp_tp", (2, 2))]


def _dryrun_cell(cfg, mesh):
    """[mesh]'s (2, 2) cell as the dry run builds it: the train cell's
    tokens in its microbatches."""
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    shape = ShapeConfig("mesh_train", "train", TRAIN_DATA["seq_len"],
                        TRAIN_DATA["global_batch"],
                        TRAIN_DATA["num_microbatches"])
    return shapes_mod.build_cell(cfg, shape, mesh)


def phase_dryrun(mesh_replay: dict) -> tuple:
    """The dry run against the card on [mesh]'s (2, 2) ``fsdp_tp`` cell:
    the fake trace in full and replayed (host seconds; they must be one
    program), the replayed trace's costs on ``cuda:0``, then one real step
    with the collective record on, held to the replayed trace (record
    entry for entry, launches equal to ``FAKE_CALLS``), its peak memory
    beside the fake peak, and a second step's wall and a third's device
    ms (``[profile] dryrun_mesh_step_2x2``: the kernels' time) beside the
    roofline; ``mesh_replay`` (``phase_mesh``'s graphed (2, 2) step's
    profiled replay) held to the replayed trace the same way
    (``_dryrun_graphed``); then the chunked loss on the mesh
    (``_dryrun_chunked``).  Returns the real steps' launches, the chunked
    step's and what [audit] reads."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config(ARCH), remat="full",
                              sharding="fsdp_tp")
    mesh = _mesh_of((2, 2))
    full_trace = dryrun.trace_cell(_dryrun_cell(cfg, mesh), replay=False)
    cell = _dryrun_cell(cfg, mesh)
    trace = dryrun.trace_cell(cell)
    diff = dryrun.trace_differences(full_trace, trace)
    log("[dryrun] full vs replayed trace of the (2, 2) fsdp_tp cell: "
        + json.dumps(dict(full_host_s=full_trace.host_s,
                          replayed_host_s=trace.host_s, trips=trace.trips,
                          ops_full=full_trace.cost.dispatched,
                          ops_replayed=trace.cost.dispatched,
                          entries=len(trace.record.entries),
                          equal=not diff)))
    if diff:
        raise AssertionError("[dryrun] the replayed trace is not the full "
                             "one: " + "; ".join(diff[:8]))
    del full_trace
    cost = dryrun.device_costs(cell, trace)["cuda:0"]
    acc = ACCELERATORS["H100"]
    terms = dict(compute_s=cost.flops / acc.peak_flops,
                 memory_s=cost.bytes_accessed / acc.mem_bw,
                 collective_s=cost.collective_traffic
                 / acc.collective_link_bw)
    roofline_s = max(terms.values())
    fake = dict(host_s=trace.host_s, flops=cost.flops,
                bytes_accessed=cost.bytes_accessed,
                peak_bytes=cost.peak_bytes,
                base_bytes=trace.cost.base["meta:0"],
                collective_traffic=cost.collective_traffic,
                roofline=dict(terms, roofline_s=roofline_s),
                entries=len(trace.record.entries),
                kernel_calls={k: v for k, v in trace.kernel_calls.items()
                              if v})
    log("[dryrun] replayed fake trace of the (2, 2) fsdp_tp cell on "
        "[cuda:0] * 4: " + json.dumps(fake))
    dc = data_lib.DataConfig(**TRAIN_DATA)
    batch = data_lib.SyntheticDataset(cfg, dc).batch(500)
    specs = param_specs(model_lib.decls(cfg), cfg.sharding, mesh)
    params = pm.shard_tree(model_lib.init(cfg, 0, device="cuda"), specs,
                           mesh)
    state = opt_lib.init_sharded_state(params)
    step = train_lib.jit_train_step(cfg, opt_lib.OptimizerConfig(**TRAIN_OPT),
                                    mesh, dc.num_microbatches, dc.micro_batch,
                                    graphed=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    with pm.record_collectives() as record:
        params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.LAUNCHES)
    same_record = record.entries == trace.record.entries
    if not same_record:
        first = next(i for i, (a, b) in enumerate(zip(
            record.entries, trace.record.entries)) if a != b) \
            if len(record.entries) == len(trace.record.entries) else None
        raise AssertionError(
            f"[dryrun] the real record ({len(record.entries)} entries) is "
            f"not the replayed fake one ({len(trace.record.entries)}); "
            f"first difference at {first}")
    if launches != trace.kernel_calls:
        raise AssertionError(f"[dryrun] launches {json.dumps(launches)} != "
                             f"FAKE_CALLS {json.dumps(trace.kernel_calls)}")
    batch2 = data_lib.SyntheticDataset(cfg, dc).batch(501)
    wall, _, _, (params, state, m2) = _timed_step(
        lambda: step(params, state, batch2))
    dev_ms = profile_window("dryrun_mesh_step_2x2",
                            lambda: step(params, state, batch2), wall, 1)
    launches = dict(ops.LAUNCHES)         # the three steps
    kinds: dict = {}
    for e in record.entries:
        key = f"{e.kind}/{e.phase}"
        kinds[key] = kinds.get(key, 0) + 1
    log("[dryrun] real step vs the replayed fake trace: " + json.dumps(dict(
        records_equal=same_record, entries=len(record.entries),
        entries_by_kind_phase=kinds,
        launches_equal_fake_calls=True,
        launches_per_step={k: v // 3 for k, v in launches.items() if v},
        loss=m["loss"].item(), loss_2=m2["loss"].item(),
        real_peak_bytes=peak, real_base_bytes=base,
        fake_peak_bytes=cost.peak_bytes,
        fake_over_real_peak=cost.peak_bytes / peak,
        fake_over_real_above_base=(cost.peak_bytes - fake["base_bytes"])
        / (peak - base),
        roofline_s=roofline_s, step_device_ms=dev_ms, step_wall_ms=wall,
        device_over_roofline=None if dev_ms is None
        else dev_ms / 1e3 / roofline_s,
        fake_host_s=trace.host_s)))
    del params, state
    _release()
    _dryrun_graphed(mesh_replay, trace)
    # the chunked step from the same seed-0 weights, made again
    cfg_c = dataclasses.replace(cfg, logits_chunk=DRYRUN_CHUNK)
    full = model_lib.init(cfg, 0, device="cuda")
    ref_c = _grads_reference(cfg_c, full, batch)
    params = pm.shard_tree(full, specs, mesh)
    del full
    chunked = _dryrun_chunked(cfg_c, mesh, params, batch, ref_c, peak)
    del params, ref_c
    _release()
    return launches, chunked, dict(cfg=cfg, cell=cell, mesh=mesh,
                                   record=record)


def _dryrun_graphed(replay: dict, trace) -> None:
    """[mesh]'s (2, 2) ``fsdp_tp`` graphed step (``jit_train_step(...,
    graphed=True)``, the same cell on the same mesh): its profiled
    replay's collective record must equal the replayed fake trace's
    entry for entry and its launches the trace's ``FAKE_CALLS``, as must
    the record its capture kept."""
    if replay["entries"] != trace.record.entries or \
            replay["capture_entries"] != trace.record.entries:
        raise AssertionError(
            f"[dryrun] a replay's record ({len(replay['entries'])} entries; "
            f"its capture's {len(replay['capture_entries'])}) is not the "
            f"replayed fake trace's ({len(trace.record.entries)})")
    if replay["launches"] != trace.kernel_calls:
        raise AssertionError(f"[dryrun] a replay's launches "
                             f"{json.dumps(replay['launches'])} != FAKE_CALLS "
                             f"{json.dumps(trace.kernel_calls)}")
    log("[dryrun] [mesh]'s graphed (2, 2) step, a replay vs the replayed "
        "fake trace: " + json.dumps(dict(
            records_equal=True, entries=len(replay["entries"]),
            capture_entries=len(replay["capture_entries"]),
            launches_equal_fake_calls=True)))


def _dryrun_chunked(cfg, mesh, params, batch, ref, unchunked_peak) -> dict:
    """[dryrun]'s chunked loss: ``cfg`` (``logits_chunk`` DRYRUN_CHUNK) on
    the (2, 2) mesh from the weights ``ref`` (``_grads_reference`` of the
    one-device chunked step) was taken from: the loss and gradients
    against one device (``_ssm_mesh_grads``'s rule), then one real step
    with the record on, whose launches and record must equal the cell's
    replayed fake trace, its peak memory beside the unchunked step's
    (``unchunked_peak``) and the fake peak (``ref``'s gradients dropped
    first, so the card holds what the unchunked step's did).  Returns the
    step's launches."""
    from repro_torch.dist import placement as pm
    from repro_torch.launch import dryrun
    cell = _dryrun_cell(cfg, mesh)
    trace = dryrun.trace_cell(cell)
    fake_peak = dryrun.device_costs(cell, trace)["cuda:0"].peak_bytes
    grads = _ssm_mesh_grads("(2, 2) fsdp_tp chunked", cfg, mesh, params,
                            batch, ref, phase="dryrun")
    ref.clear()
    dc = data_lib.DataConfig(**TRAIN_DATA)
    state = opt_lib.init_sharded_state(params)
    step = train_lib.jit_train_step(cfg, opt_lib.OptimizerConfig(**TRAIN_OPT),
                                    mesh, dc.num_microbatches, dc.micro_batch,
                                    graphed=False)
    _release()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with pm.record_collectives() as record:
        _, _, m = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.LAUNCHES)
    if record.entries != trace.record.entries:
        raise AssertionError(
            f"[dryrun] chunked: the real record ({len(record.entries)} "
            f"entries) is not the replayed fake one "
            f"({len(trace.record.entries)})")
    if launches != trace.kernel_calls:
        raise AssertionError(
            f"[dryrun] chunked: launches {json.dumps(launches)} != "
            f"FAKE_CALLS {json.dumps(trace.kernel_calls)}")
    log("[dryrun] chunked loss on the (2, 2) fsdp_tp mesh: " + json.dumps(dict(
        logits_chunk=cfg.logits_chunk, **grads, step_loss=m["loss"].item(),
        records_equal=True, entries=len(record.entries),
        launches_equal_fake_calls=True,
        launches={k: v for k, v in launches.items() if v},
        trips=trace.trips, fake_host_s=trace.host_s,
        real_peak_bytes=peak, unchunked_real_peak_bytes=unchunked_peak,
        fake_peak_bytes=fake_peak)))
    del params, state
    return launches


def phase_audit(dry: dict) -> None:
    """The collective audit on the card: the real step's record against
    ``predicted_comm`` (advisory, as the reference's ``--audit``), the
    demo's two variants on ``[cuda:0] * 8`` (its exit rule holds or the
    script fails), and ``plan_for`` with ``audit="warn"`` on the [plan]
    fleets."""
    import tempfile
    from repro_torch.analysis import demo
    from repro_torch.launch import dryrun
    rep = dryrun._audit_cell(dry["cfg"], dry["cell"], dry["mesh"],
                             dry["record"], tag="smollm_360m__mesh_2x2")
    log("[audit] real (2, 2) fsdp_tp step vs predicted_comm (tp 2, dp 2): "
        + json.dumps(dict(ok=rep["ok"], by_kind=rep["by_kind"],
                          rel_diff=rep["summary"].get("rel_diff"),
                          actual={k: v["traffic"] for k, v in
                                  rep["summary"]["actual"].items()},
                          predicted=rep["summary"]["predicted"])))
    with tempfile.TemporaryDirectory() as out:
        rc = demo.main(["--out", out])
        reports = {v: json.load(open(os.path.join(out, f"demo_{v}.json")))
                   for v in ("clean", "seeded")}
    log("[audit] demo on [cuda:0] * 8: " + json.dumps(dict(
        rc=rc, clean_findings=len(reports["clean"]["findings"]),
        clean_rel_diff=reports["clean"]["summary"].get("rel_diff"),
        seeded_by_kind=reports["seeded"]["by_kind"])))
    if rc != 0:
        raise AssertionError(f"[audit] demo exit {rc}: clean must audit "
                             f"clean, seeded must fail")
    for fleet, cluster in PLAN_FLEETS.items():
        res = plan_for(get_config(ARCH), cluster, Objective(MAX_THROUGHPUT),
                       seq_len=TRAIN_DATA["seq_len"],
                       global_batch=PLAN_GLOBAL_BATCH, audit="warn")
        log(f"[audit] plan_for({fleet}, audit='warn'): " + json.dumps(dict(
            plan=res.best.plan.describe(), audit=res.stats["audit"])))


def _serve_mesh_reference(cfg, params, batch, max_len, steps) -> dict:
    """One device, eager: the bf16 prefill of ``batch`` (the tokens and
    any stub frames or patches; twice: the second timed), ``grow_cache``
    and ``steps`` greedy decode steps (their tokens drive every run of the
    case), timed; then the same weights cast to fp32 (``_f32_copy``) fed
    the same tokens.  Returns each step's logits in both and the
    tokens."""
    def run(cfg, params, tokens=None):
        prefill = serve_step.make_prefill(cfg)
        decode = serve_step.make_decode(cfg)
        b = batch["tokens"].shape[0]
        with torch.no_grad():
            prefill(params, batch)                   # warm: the timed
            torch.cuda.synchronize()                 # prefill is the 2nd
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            cache = kv_cache.grow_cache(cache, model_lib.init_cache(
                cfg, b, max_len, device="cuda"))
            outs, fed, walls = [logits.float()], [], []
            for i in range(steps):
                nxt = outs[-1].argmax(-1)[:, None] if tokens is None \
                    else tokens[i]
                fed.append(nxt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = decode(params, cache, nxt)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits.float())
        del cache
        return outs, fed, prefill_ms, statistics.median(walls)
    outs, tokens, prefill_ms, decode_ms = run(cfg, params)
    cfg32, params32 = _f32_copy(cfg, params)
    outs32 = run(cfg32, params32, tokens)[0]
    del params32
    _release()
    floor = max((a - b).abs().max().item() for a, b in zip(outs, outs32))
    return dict(logits=outs, tokens=tokens, prefill_ms=prefill_ms,
                decode_ms=decode_ms, floor=floor)


def _serve_mesh_case(label, cfg, shape, rows, prompt, max_len, steps,
                     smi, phase="serve mesh") -> dict:
    """One [serve mesh] case: the one-device reference, the dry run's fake
    trace of the prefill cell, then the mesh's prefill (launches equal to
    ``FAKE_CALLS``, its collective record the fake one), a second one
    timed, ``grow_cache`` and ``steps`` decode steps fed the reference's
    tokens (no launch: the decode's plain route), each step's logits held
    to the reference.  Each side's wall is the second prefill's (the
    first warms the side) and the median step's.  encdec and vlm prefill
    seeded stub frames or patches (std 0.02, as the train data's) with
    the ``prompt`` text tokens (a vlm's cell counts its patches).  Returns
    the launches of the mesh's two prefills and steps."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    mesh = _mesh_of(shape)
    full = model_lib.init(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (rows, prompt), device="cuda",
                         generator=gen)
    batch = {"tokens": toks}
    for name, x in model_lib.stub_inputs(cfg, rows, "cuda").items():
        batch[name] = 0.02 * torch.randn(x.shape, device="cuda",
                                         generator=gen)
    seq = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
    ref = _serve_mesh_reference(cfg, full, batch, max_len, steps)
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg),
                                             cfg.sharding, mesh), mesh)
    del full
    _release()
    t0 = time.perf_counter()
    trace = dryrun.trace_cell(shapes_mod.build_cell(
        cfg, ShapeConfig("serve_mesh", "prefill", seq, rows), mesh))
    fake_s = time.perf_counter() - t0
    prefill = serve_step.make_prefill(cfg, mesh)
    decode = serve_step.make_decode(cfg, mesh)
    with torch.no_grad():
        ops.reset_launches()
        with pm.record_collectives() as record:
            prefill(params, batch)
        torch.cuda.synchronize()
        prefill_launches = dict(ops.LAUNCHES)
        t0 = time.perf_counter()                 # the second prefill
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = kv_cache.grow_cache(cache, model_lib.init_cache(
            cfg, rows, max_len, mesh=mesh))
        outs, walls = [pm.unshard(logits, "cuda")], []
        for nxt in ref["tokens"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, nxt)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            outs.append(pm.unshard(logits, "cuda"))
        launches = dict(ops.LAUNCHES)
    diffs = [(a - b).abs().max().item() for a, b in zip(outs, ref["logits"])]
    tol = max(LOGITS_TOL, 2 * ref["floor"])
    # the reference's token i is its greedy pick from its logits i
    agree = [(o.argmax(-1)[:, None] == t).float().mean().item()
             for o, t in zip(outs, ref["tokens"])]
    first_equal = agree[0] == 1.0
    row = dict(
        mesh=dict(mesh.shape), layers=cfg.n_layers, dtype=cfg.dtype,
        rows=rows, prompt=prompt, buffer=max_len, steps=steps,
        cache_specs={k: [str(p) for p in v.spec]
                     for k, v in cache.items() if k != "len"},
        first_tokens_equal=first_equal,
        greedy_agreement=statistics.mean(agree),
        logits_max_abs_diff=max(diffs), prefill_logits_max_abs_diff=diffs[0],
        single_bf16_vs_fp32=ref["floor"], tol=tol,
        finite=all(bool(torch.isfinite(o).all()) for o in outs),
        prefill_launches={k: v for k, v in prefill_launches.items() if v},
        fake_calls_equal=prefill_launches == trace.kernel_calls,
        records_equal=record.entries == trace.record.entries,
        record_entries=len(record.entries), fake_trace_host_s=fake_s,
        decode_launches={k: v - 2 * prefill_launches[k]
                         for k, v in launches.items()
                         if v != 2 * prefill_launches[k]},
        prefill_wall_ms=prefill_ms,
        one_device_prefill_wall_ms=ref["prefill_ms"],
        prefill_ratio=prefill_ms / ref["prefill_ms"],
        decode_step_wall_ms=statistics.median(walls),
        one_device_decode_step_wall_ms=ref["decode_ms"],
        decode_ratio=statistics.median(walls) / ref["decode_ms"], card=smi)
    log(f"[{phase}] {label}: " + json.dumps(row))
    if not (first_equal and row["finite"] and max(diffs) <= tol
            and row["fake_calls_equal"] and row["records_equal"]
            and not row["decode_launches"]):
        raise AssertionError(f"[{phase}] {label}: {row}; FAKE_CALLS "
                             f"{json.dumps(trace.kernel_calls)}")
    del params, cache, ref, outs
    _release()
    return launches


def phase_serve_mesh(smi: str) -> dict:
    """Serving on a mesh (``serve_step.make_prefill(cfg, mesh)`` and
    ``make_decode(cfg, mesh)`` over ``dist/spmd_serve.py``), every position
    on ``cuda:0``, eager, bf16 (``[serve mesh]``): smollm-360M at all 32
    layers on (2, 2) ``fsdp_tp`` (query heads replicated, the cache split
    over the sequence) and (1, 5) ``tp`` (3 query heads and 1 K/V head a
    position), then dbrx and mixtral (past its window) at 2 layers on (1,
    2), mamba2-130m at 24 on (1, 4) and zamba2-2.7b at 12 on (1, 2).  A
    main path for the attention and fused-norm kernels (a layer a
    position a prefill) and the SSD scan (the same).  Returns the launches
    of the mesh runs (the one-device references run outside the count)."""
    t_phase = time.perf_counter()
    log(f"[serve mesh] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    total: dict = {}
    for case in serve_mesh_cases():
        _add_counts(total, _serve_mesh_case(*case, smi))
    log(f"[serve mesh] launches_serve_mesh "
        + json.dumps({k: v for k, v in total.items() if v}))
    missing = [n for n in ("flash_attention", "fused_add_rmsnorm",
                           "ssd_scan") if not total.get(n)]
    if missing:
        raise AssertionError(f"[serve mesh] no launch of {missing} on the "
                             f"path ({total})")
    log(f"[serve mesh] phase seconds {time.perf_counter() - t_phase:.1f}")
    return total


def _family_mesh_train(cfg, shape, full, batches, ref) -> dict:
    """One [mesh families] train case: each position's memory, the first
    step's loss and gradients against one device (``_ssm_mesh_grads``'s
    bounds), the dry run's fake trace of
    the step's cell, then FAMILY_MESH_STEPS eager steps timed, the first
    with the record on: its launches equal to ``FAKE_CALLS`` and its
    collective record the fake one; every step's launches the same;
    losses finite; replicas bit for bit.  Returns the steps' launches."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    data = ENCDEC_TRAIN_DATA if cfg.family == "encdec" else VLM_TRAIN_DATA
    dc = data_lib.DataConfig(**data)
    mesh = _mesh_of(shape)
    label = (f"{cfg.name} {cfg.n_layers} layers {shape[0]}x{shape[1]} "
             f"{cfg.sharding} train")
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg),
                                             cfg.sharding, mesh), mesh)
    state = opt_lib.init_sharded_state(params)
    log(f"[mesh families] {label} memory: "
        + json.dumps(_mesh_memory(cfg, mesh, params, state, data)))
    first = _ssm_mesh_grads(label, cfg, mesh, params, batches[0], ref,
                            "mesh families")
    log(f"[mesh families] {label} first step vs the one-device "
        f"loss_and_grads (same weights and batch): " + json.dumps(first))
    t0 = time.perf_counter()
    trace = dryrun.trace_cell(shapes_mod.build_cell(
        cfg, ShapeConfig("mesh_families", "train", dc.seq_len,
                         dc.global_batch, dc.num_microbatches), mesh))
    fake_s = time.perf_counter() - t0
    del params, state
    graphed = (cfg.name, shape) in {(get_config(a).name, m)
                                    for a, m in GRAPHED_FAMILY_MESHES}
    got = _steps_in_turns(f"[mesh families] {label}", cfg, dc, mesh, full,
                          batches[:GRAPHED_STEPS if graphed
                                  else FAMILY_MESH_STEPS], graphed,
                          record_first=True,
                          apart=cfg.family in GRAPHED_APART)
    rows, launches = got["rows"]["eager"], got["per_step"]
    entries = got["entries"]
    vals = [v for r in rows for v in r[3:]]
    same = got["replicas"]
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, mesh=dict(mesh.shape),
        policy=cfg.sharding, data=data, losses=[r[3] for r in rows],
        grad_norms=[r[4] for r in rows],
        step_wall_ms=statistics.median(r[0] for r in rows),
        step_wall_ms_all=[r[0] for r in rows],
        step_device_ms=statistics.median(r[1] for r in rows),
        working_set_gib=max(r[2] for r in rows) / 2**30,
        tokens_per_s=dc.global_batch * dc.seq_len
        / (statistics.median(r[0] for r in rows) / 1e3),
        launches_per_step={k: v for k, v in launches[0].items() if v},
        fake_calls_equal=all(x == trace.kernel_calls for x in launches),
        records_equal=entries == trace.record.entries,
        record_entries=len(entries), fake_trace_host_s=fake_s,
        replicas_bit_identical=same)
    if graphed:
        stats.update(_graphed_stats(got, dc.global_batch * dc.seq_len))
    log(f"[mesh families] {label}: " + json.dumps(stats))
    if not (all(np.isfinite(vals)) and same and stats["fake_calls_equal"]
            and stats["records_equal"]):
        raise AssertionError(f"[mesh families] {label}: {stats}; FAKE_CALLS "
                             f"{json.dumps(trace.kernel_calls)}")
    total = got["total"]
    del got
    _release()
    n = FAMILY_MESH_STEPS
    return dict(total=total, wall=statistics.median(r[0] for r in rows[:n]),
                losses=stats["losses"][:n])


def _family_one_device(cfg, full, batches):
    """The median wall and the losses of FAMILY_MESH_STEPS eager
    one-device steps (``make_train_step``) from ``full`` (updated in
    place) on the mesh's batches, outside the launch count."""
    step = train_lib.make_train_step(cfg, opt_lib.OptimizerConfig(
        **TRAIN_OPT))
    state = opt_lib.init_state(full)
    walls, losses = [], []
    for b in batches:
        wall, _, _, (full, state, m) = _timed_step(
            lambda b=b: step(full, state, b))
        walls.append(wall)
        losses.append(m["loss"].item())
    del state
    _release()
    return statistics.median(walls), losses


def mesh_families_cases():
    """(arch, cfg, mesh shape, train, serve) of [mesh families]."""
    for arch, layers, policy, shape, train, serve in FAMILY_MESH_CASES:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                                  remat="full", sharding=policy)
        yield arch, cfg, shape, train, serve


def mesh_families_shapes():
    """(kernel, label, shape, dtype, backward) of what [mesh families]
    launches and its one-device references run: internvl2's attention
    (b, S, heads, K/V heads, D) and fused norm (rows, D) on each train
    position (bf16, both directions) and each serving position (bf16,
    forward), and the one-device references' (the train step's fp32
    copy; the served bf16 and fp32; its bf16 step is [vlm train]'s
    shape); whisper's family launches none."""
    bf16, f32 = torch.bfloat16, torch.float32
    for arch, cfg, (dp, tp), train, serve in mesh_families_cases():
        if cfg.family != "vlm":
            continue
        h, kh = _local_heads(cfg.n_heads, cfg.n_kv_heads, tp)
        tag = f"mesh_families_{dp}x{tp}"
        cases = []
        if train:
            d = VLM_TRAIN_DATA
            mb = d["global_batch"] // d["num_microbatches"]
            cases += [(tag, mb // dp, d["seq_len"], h, kh, bf16, True),
                      (tag + "_one_device_f32", mb, d["seq_len"],
                       cfg.n_heads, cfg.n_kv_heads, f32, True)]
        if serve:
            rows, text, _ = FAMILY_MESH_SERVE[arch]
            s = cfg.n_patches + text
            cases += [(tag + "_serve", rows // dp, s, h, kh, bf16, False)]
            cases += [(f"{tag}_serve_one_device_{_dname(dt)}", rows, s,
                       cfg.n_heads, cfg.n_kv_heads, dt, False)
                      for dt in (bf16, f32)]
        for label, b, s, hq, hk, dt, bwd in cases:
            yield ("flash_attention", label, (b, s, hq, hk, cfg.hd), dt, bwd)
            yield ("fused_add_rmsnorm", f"{label}_rows{b * s}",
                   (b * s, cfg.d_model), dt, bwd)


def phase_mesh_families(smi: str) -> dict:
    """The encoder-decoder and vision-language families on a mesh
    (``[mesh families]``): the sharded train step
    (``train_step.jit_train_step``) and ``serve_step.make_prefill(cfg,
    mesh)`` / ``make_decode(cfg, mesh)``, every position on ``cuda:0``,
    eager and, on GRAPHED_FAMILY_MESHES, the train step graphed beside it
    bit for bit, bf16 (FAMILY_MESH_CASES).  Each family's train meshes are held
    against one device run once (``_grads_reference``; its eager
    step timed after them), its serving meshes as [serve mesh]'s.  A main
    path for the attention and fused-norm kernels, forward and backward
    (internvl2's positions); whisper launches none.  Returns the launches
    of the mesh runs."""
    t_phase = time.perf_counter()
    log(f"[mesh families] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    total: dict = {}
    by_case = {}
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        cases = [c for c in mesh_families_cases() if c[0] == arch]
        trains = [(cfg, shape) for _, cfg, shape, train, _ in cases if train]
        if trains:
            base = trains[0][0]
            data = ENCDEC_TRAIN_DATA if arch == ENCDEC_ARCH \
                else VLM_TRAIN_DATA
            ds = data_lib.SyntheticDataset(base, data_lib.DataConfig(**data))
            batches = [ds.batch(600 + i) for i in range(GRAPHED_STEPS)]
            full = model_lib.init(base, 0, device="cuda")
            ref = _grads_reference(base, full, batches[0])
            walls, losses = {}, {}
            for cfg, shape in trains:
                got = _family_mesh_train(cfg, shape, full, batches, ref)
                key = f"{shape[0]}x{shape[1]} {cfg.sharding}"
                walls[key], losses[key] = got["wall"], got["losses"]
                by_case[f"{arch} {shape[0]}x{shape[1]} train"] = {
                    k: v for k, v in got["total"].items() if v}
                _add_counts(total, got["total"])
            del ref
            _release()
            one, one_losses = _family_one_device(
                base, full, batches[:FAMILY_MESH_STEPS])
            log(f"[mesh families] {base.name} {base.n_layers} layers train "
                f"steps, mesh vs one device (eager, same weights and "
                f"batches): " + json.dumps(dict(
                    one_device_step_wall_ms=one, mesh_step_wall_ms=walls,
                    ratio={k: v / one for k, v in walls.items()},
                    one_device_losses=one_losses, mesh_losses=losses)))
            del full
            _release()
        for _, cfg, shape, _, serve in cases:
            if not serve:
                continue
            rows, text, steps = FAMILY_MESH_SERVE[arch]
            seq = text + (cfg.n_patches if cfg.family == "vlm" else 0)
            got = _serve_mesh_case(
                f"{arch} {cfg.n_layers} layers {shape[0]}x{shape[1]} "
                f"{cfg.sharding} serve", cfg, shape, rows, text,
                seq + steps + 8, steps, smi, phase="mesh families")
            by_case[f"{arch} {shape[0]}x{shape[1]} serve"] = {
                k: v for k, v in got.items() if v}
            _add_counts(total, got)
    log(f"[mesh families] launches_mesh_families {json.dumps(by_case)}")
    missing = [n for n in TRAIN_KERNELS if not total.get(n)]
    if missing:
        raise AssertionError(f"[mesh families] no launch of {missing} on "
                             f"the path ({total})")
    log(f"[mesh families] phase seconds {time.perf_counter() - t_phase:.1f}")
    return total


def _whole_state(tr) -> dict:
    """The trainer's params, ``m``, ``v`` and step gathered whole on the
    card, by path."""
    from repro_torch.dist import placement as pm
    return {k: pm.unshard(x, "cuda") for k, x in pm.tree_items(
        {"params": tr.params, "opt": tr.opt_state})}


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_elastic() -> dict:
    """Sailor's elastic runtime (``train/elastic.ElasticTrainer`` over
    ``jit_train_step``, ``train/checkpoint.CheckpointManager``) on the
    train cell (smollm-360M at its published widths and depth, tied,
    bf16, full remat, [train]'s data and optimizer), ``devices=[cuda:0] *
    4``, the default all-data-parallel plan, a checkpoint every
    ELASTIC_EVERY steps into a temporary directory deleted at the end:
    ``build(1)``, then ELASTIC_STEPS steps with a kill-free resize to 4
    positions at step 3 and a failure down to 2 at step 7, which rolls
    back to the step-6 checkpoint.  The state just after the reshard must
    equal the state before it, and the state just after the restore the
    saved one, gathered whole, bit for bit; step 6's replayed loss within
    phase 8's loss bound of its first run; the loss lower at the end.
    Prints each reconfiguration's seconds, the checkpoint's bytes, the
    seconds of a save's synchronous snapshot and of its write
    (``wait()``), and the median step wall at each position count.  Then
    ``launch.train.main`` plans on 8 H100s and trains the plan's model on
    the card.  A main path for the attention and fused-norm kernels,
    forward and backward; returns the launches over the phase."""
    import shutil
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.train.elastic import ElasticTrainer
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    workdir = tempfile.mkdtemp(prefix="elastic-")
    ops.reset_launches()
    try:
        tr = ElasticTrainer(cfg, ocfg, dc, workdir,
                            checkpoint_every=ELASTIC_EVERY,
                            devices=[torch.device("cuda", 0)]
                            * max(ELASTIC_DEVICES))
        saved, checks, save_s = {}, [], []
        change, save = tr.on_availability_change, tr.ckpt.save

        def on_change(n, failure=False):
            before = None if failure else _whole_state(tr)
            change(n, failure)
            after = _whole_state(tr)
            want = saved[tr.step] if failure else before
            checks.append(dict(kind="rollback" if failure else "kill-free",
                               mesh=dict(tr.mesh.shape),
                               bit_identical=_same_state(after, want)))
            del before, after, want

        def on_save(step, state, blocking=False):
            saved.clear()
            saved[step] = _whole_state(tr)
            t0 = time.perf_counter()
            save(step, state, blocking)
            save_s.append(time.perf_counter() - t0)

        tr.on_availability_change, tr.ckpt.save = on_change, on_save
        tr.ckpt.keep = 1        # the latest is all a rollback reads
        tr.build(ELASTIC_DEVICES[0])
        log_rows = tr.train(ELASTIC_STEPS, events=list(ELASTIC_EVENTS))
        saved.clear()
        kinds = [r["kind"] for r in tr.reconfigs]
        first = {r["step"]: r["loss"] for r in log_rows[:ELASTIC_EVENTS[1][0]]}
        back = tr.reconfigs[1]["resumed_at"]
        replay = [r for r in log_rows if r["step"] == back][-1]["loss"]
        losses = [r["loss"] for r in log_rows]
        # the graphed step: a capture after the build and after each
        # reconfiguration (the new step binds the new tensors)
        if (kinds != ["kill-free", "rollback"] or back != 6
                or not tr.step_fn.graphed or len(tr.captures) != 3
                or len(log_rows) != ELASTIC_STEPS + 1
                or not all(c["bit_identical"] for c in checks)
                or not abs(replay - first[back]) <= TRAIN_LOSS_TOL
                * abs(first[back])
                or not all(np.isfinite(losses))
                or not losses[-1] < losses[0]):
            raise AssertionError(f"[elastic] reconfigs {tr.reconfigs}, "
                                 f"checks {checks}, log {log_rows}")
        walls = {}
        for r in log_rows:
            walls.setdefault(r["n_devices"], []).append(r["time_s"] * 1e3)
        # one more save of the final state, timed: its snapshot and write
        tr.ckpt.wait()
        t0 = time.perf_counter()
        save(ELASTIC_STEPS, {"params": tr.params, "opt": tr.opt_state})
        snap = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr.ckpt.wait()
        write = time.perf_counter() - t0
        path = os.path.join(workdir, f"step-{ELASTIC_STEPS}", "state.npz")
        nbytes = os.path.getsize(path)
        disk = shutil.disk_usage(workdir)
        log("[elastic] " + json.dumps(dict(
            reconfigs=tr.reconfigs, captures=tr.captures,
            checks=checks, losses=losses,
            steps=[r["step"] for r in log_rows],
            replayed_step=back, replayed_loss=replay,
            first_run_loss=first[back], loss_tol=TRAIN_LOSS_TOL,
            step_wall_ms_by_positions={
                n: dict(median=statistics.median(w), all=w)
                for n, w in walls.items()},
            train_save_snapshot_s=save_s, checkpoint_bytes=nbytes,
            save_snapshot_s=snap, save_write_s=write,
            disk_free_bytes=disk.free)))
        del tr
        torch.cuda.empty_cache()
        # launch/train.py: plan, then train on the card
        res, lt = launch_train.main([
            "--arch", ARCH, "--plan", "--cluster", "H100:8",
            "--steps", str(ELASTIC_LAUNCH_STEPS),
            "--seq-len", str(TRAIN_DATA["seq_len"]),
            "--global-batch", str(TRAIN_DATA["global_batch"]),
            "--num-micro", str(TRAIN_DATA["num_microbatches"]),
            "--workdir", os.path.join(workdir, "launch")])
        lt_losses = [r["loss"] for r in lt.log]
        if not (res.best is not None and res.best.valid
                and len(lt_losses) == ELASTIC_LAUNCH_STEPS
                and all(np.isfinite(lt_losses))):
            raise AssertionError(f"[elastic] launch.train: plan "
                                 f"{res.best}, losses {lt_losses}")
        rows = log_rows + lt.log
        positions = sum(r["n_devices"] for r in rows)
        del lt
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = _elastic_launch_check("[elastic]", cfg, dc, rows)
    log(f"[elastic] launch.train: plan {res.best.plan.describe()!r}, t_iter "
        f"{res.best.t_iter}, losses {lt_losses}; launches over the phase "
        f"({positions} position-steps): {json.dumps(launches)}")
    return launches


def _elastic_launch_check(label: str, cfg, dc, rows) -> dict:
    """The launches counted since the last reset, against the trainer's
    log ``rows``: each position-step launches the attention forward and
    the fused norm 2 x layers x microbatches times (the forward, and its
    recompute under full remat), each backward layers x microbatches."""
    launches = dict(ops.LAUNCHES)
    positions = sum(r["n_devices"] for r in rows)
    per = cfg.n_layers * dc.num_microbatches * positions
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * per, fused_add_rmsnorm=2 * per,
                flash_attention_bwd=per, fused_add_rmsnorm_bwd=per)
    if launches != want:
        raise AssertionError(f"{label} launches {json.dumps(launches)}, "
                             f"expected {json.dumps(want)} ({positions} "
                             f"position-steps)")
    return launches


def _rows_from(rows, reconfigs) -> list:
    """The index in ``rows`` (a trainer's log) of the first step each of
    ``reconfigs`` ran: the row of its ``resumed_at`` right after the row
    of the step before its ``step``."""
    out, at = [], 1
    for r in reconfigs:
        at = next(i for i in range(at, len(rows))
                  if rows[i]["step"] == r["resumed_at"]
                  and rows[i - 1]["step"] == r["step"] - 1)
        out.append(at)
    return out


def _manager_controller() -> dict:
    """(a) Sailor's control loop (``manager.Controller``: the availability
    monitor, the incremental replanner, the transition model) over an
    ``ElasticTrainer`` as the ``elastic_reconfig`` example runs it at its
    defaults (``controller`` and ``report``, what its ``main`` runs), with
    an audit file and a telemetry bus: the decisions must be the
    reference controller's on the example's trace (MANAGER_OUTCOMES,
    MANAGER_RECONFIGS), every loss finite, a ``step_time`` sample a step
    on the controller's sim clock, the audit file equal to the decision
    log; decisions the wall clock made (straggler flags, detector events)
    are printed and left out of the comparison, the reconfigurations
    are not.  Prints the example's report, each decision, each priced
    transition beside the trainer's measured ``reconfig_s`` and its new
    step's capture, ``_state_bytes()`` beside the checkpoint's bytes and
    the step wall at each position count."""
    import shutil
    import tempfile
    from repro_torch.examples import elastic_reconfig as example
    from repro_torch.examples.common import positions
    from repro_torch.telemetry import TelemetryBus, read_jsonl
    workdir = tempfile.mkdtemp(prefix="manager-")
    audit = os.path.join(workdir, "audit.jsonl")
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        ctl = example.controller(
            get_config(example.ARCH),
            positions("cuda", example.ZONE_DEVICES),
            os.path.join(workdir, "ckpt"), audit_path=audit)
        tr = ctl.trainer
        tr.ckpt.keep = 1        # the latest is all a rollback reads
        bus = TelemetryBus()
        ctl.attach_telemetry(bus)
        # what the loop priced (each decide's details) and built (plans)
        priced, plans = [], []
        decide, build = ctl.transition.decide, tr.build

        def on_decide(**kw):
            d = decide(**kw)
            priced.append(dict(time_s=ctl.sim_time, kind=d.kind,
                               cost_s=d.cost_s, details=d.details,
                               state_bytes=kw["state_bytes"],
                               t_iter_old_s=kw["t_iter_old_s"]))
            return d

        def on_build(n, *a, **k):
            build(n, *a, **k)
            plans.append(tr.plan)

        ctl.transition.decide, tr.build = on_decide, on_build
        rows = ctl.run(example.STEPS)
        report = example.report(ctl, rows)
        seconds = time.perf_counter() - t0
        ckpt_step = tr.ckpt.latest_step()
        ckpt_bytes = os.path.getsize(os.path.join(
            workdir, "ckpt", f"step-{ckpt_step}", "state.npz"))
        records = read_jsonl(audit)
        # rows the wall clock decides (the trainer's straggler flags, the
        # bus's detector events, which carry a root cause) have no
        # counterpart in the reference's run; the reconfigurations do
        decisions = [d for d in ctl.decisions
                     if not d.get("straggler") and "root_cause" not in d]
        outcomes = [d["action"] for d in decisions]
        reconfigs = [(r["kind"], r["n_devices"], r["step"], r["resumed_at"])
                     for r in tr.reconfigs]
        losses = [r["loss"] for r in rows]
        times = [s.time_s for s in bus.series("step_time", ())]
        audit_ok = [{k: v for k, v in r.items()
                     if k not in ("kind", "wall_time_s")} for r in records] \
            == json.loads(json.dumps(ctl.decisions))
        if (outcomes != list(MANAGER_OUTCOMES)
                or reconfigs != [tuple(r) for r in MANAGER_RECONFIGS]
                or not all(np.isfinite(losses))
                or report["positions"] != example.ZONE_DEVICES
                or len(times) != len(rows) or max(times) > ctl.sim_time
                or not audit_ok or not tr.step_fn.graphed
                or any(p.tp != 1 or p.dp not in MANAGER_DP for p in plans)):
            raise AssertionError(
                f"[manager] outcomes {outcomes} (want "
                f"{list(MANAGER_OUTCOMES)}), reconfigs {reconfigs} (want "
                f"{list(MANAGER_RECONFIGS)}), losses {losses}, step_time "
                f"at {times} (sim clock {ctl.sim_time}), audit equal "
                f"{audit_ok}, plans {plans} (phase 3 holds dp {MANAGER_DP} "
                f"at tp 1)\n" + ctl.summary())
        for d in ctl.decisions:
            log("[manager] decision " + json.dumps(dict(
                time_s=d["time_s"], step=d["step"], event=d["event"],
                action=d["action"], reason=d["reason"],
                search_ms=d["search_ms"], cache=d["cache"],
                n_devices=d["n_devices"],
                transition_cost_s=d.get("transition_cost_s"))))
        # each committed transition: what the model priced, what it took
        commits = [p for p in priced if p["kind"] in ("reshard", "rollback")]
        if len(commits) != len(tr.reconfigs):
            raise AssertionError(f"[manager] {len(commits)} priced commits "
                                 f"for reconfigs {tr.reconfigs}")
        tm = ctl.transition
        for p, r, start in zip(commits, tr.reconfigs,
                               _rows_from(rows, tr.reconfigs)):
            row = dict(kind=r["kind"], at_step=r["step"],
                       resumed_at=r["resumed_at"], n_devices=r["n_devices"],
                       priced_s=p["cost_s"],
                       reshard_cost_s=p["details"]["reshard_cost_s"],
                       measured_reconfig_s=r["reconfig_s"],
                       capture_s=r["capture_s"])
            if r["kind"] == "rollback":
                lost = p["details"]["lost_steps"]
                replay = [x["time_s"] for x in rows[start:start + lost]]
                row.update(
                    rollback_cost_s=p["cost_s"], lost_steps=lost,
                    priced_restore_s=p["state_bytes"] / tm.cfg.restore_bw,
                    priced_setup_s=tm.cfg.comm_setup_s,
                    priced_lost_work_s=lost * p["t_iter_old_s"],
                    measured_replay_s=sum(replay),
                    measured_total_s=r["reconfig_s"] + sum(replay))
            log("[manager] transition priced vs measured " + json.dumps(row))
        walls = {}
        for r in rows:
            walls.setdefault(r["n_devices"], []).append(r["time_s"] * 1e3)
        log("[manager] " + json.dumps(dict(
            model=report["model"], n_layers=report["n_layers"],
            positions=report["positions"], seconds=seconds,
            state_bytes_priced=ctl._state_bytes(),
            checkpoint_bytes=ckpt_bytes, checkpoint_step=ckpt_step,
            ratio=ckpt_bytes / ctl._state_bytes(),
            step_wall_ms_by_positions={
                n: dict(median=statistics.median(w), all=w)
                for n, w in walls.items()},
            losses=losses, steps=[r["step"] for r in rows],
            plans=[dataclasses.asdict(p) for p in plans],
            outcomes=report["outcomes"], stragglers=report["stragglers"],
            replanner=report["replanner"], captures=tr.captures,
            step_time_at=times, sim_time=ctl.sim_time,
            audit_records=len(records))))
        launches = _elastic_launch_check("[manager]", tr.cfg, tr.data_cfg,
                                         rows)
        del tr, ctl
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[manager] launches over the controller's run: "
        f"{json.dumps(launches)}")
    return launches


def _manager_pipeline() -> dict:
    """(b) Telemetry on [pipeline]'s graphed ``[1, 1]`` pipeline
    (``attach_telemetry``): two pipelines from the same weights, one with
    a bus, TEL_PAIRS pairs of steps in turns after their warm-up and
    capture: the same losses bit for bit, the same graphs and the same
    launches a step; then the bus with a ``DetectorBank``, a
    ``RootCauseAnalyzer`` and a compute delay on stage 1 from step
    TEL_FAULT_STEP: no anomaly before it, a ``Straggler`` from a stage-1
    stream within TEL_DETECT_WITHIN steps, classified ``slow-chip`` on
    stage 1, and the reference's sample counts."""
    from repro_torch.dist import pipeline as pl
    from repro_torch.manager import EventBus, Straggler
    from repro_torch.telemetry import (DetectorBank, FaultInjector, FaultSpec,
                                       RootCauseAnalyzer, TelemetryBus)
    cfg = _pipe_cfg()
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(100 + i) for i in range(TEL_STEPS)]
    zones = ("stage0", "stage1")
    full = model_lib.init(cfg, 5, device="cuda")
    pipes = {"detached": _pipe(pl, cfg, ocfg, full, None),
             "attached": _pipe(pl, cfg, ocfg, full, None)}
    del full
    pipes["attached"].attach_telemetry(TelemetryBus(), zones=zones)
    ops.reset_launches()
    steps, same = 0, True
    runs = {k: [] for k in pipes}
    per_step = {k: [] for k in pipes}
    for j in range(2 + TEL_PAIRS):       # warm-up, capture, then in turns
        b = batches[j]
        order = tuple(pipes) if j % 2 == 0 else tuple(reversed(pipes))
        out = {}
        for kind in order:
            before = dict(ops.LAUNCHES)
            wall, dev, _, out[kind] = _timed_step(
                lambda: pipes[kind].train_step(b))
            per_step[kind].append({k: ops.LAUNCHES[k] - before[k]
                                   for k in before})
            if j >= 2:
                runs[kind].append((wall, dev))
            steps += 1
        same &= out["detached"] == out["attached"]
    graphs_of = {k: [sorted(map(str, g.graphs)) for g in p.graphs]
                 for k, p in pipes.items()}
    captured = {k: [g.capture_launches for g in p.graphs]
                for k, p in pipes.items()}
    if not (same and graphs_of["detached"] == graphs_of["attached"]
            and captured["detached"] == captured["attached"]
            and per_step["detached"] == per_step["attached"]):
        raise AssertionError(
            f"[manager] telemetry attached vs detached: losses equal "
            f"{same}, graphs {graphs_of}, launches a step {per_step}")
    turns = {k: dict(step_wall_ms=statistics.median(x[0] for x in r),
                     step_wall_ms_all=[x[0] for x in r],
                     step_device_ms=statistics.median(x[1] for x in r))
             for k, r in runs.items()}
    log(f"[manager] pipeline telemetry in turns ({TEL_PAIRS} pairs, no "
        f"fault; the graphed [1, 1] pipeline): " + json.dumps(dict(
            turns, bit_identical=same,
            wall_ratio=turns["attached"]["step_wall_ms"]
            / turns["detached"]["step_wall_ms"],
            samples_a_step=pipes["attached"]._telemetry.n_samples
            // (2 + TEL_PAIRS),
            graphs=graphs_of["attached"])))
    del pipes["detached"]
    torch.cuda.empty_cache()
    # the fault: a bus, the detectors and RCA, stage 1 slowed from
    # TEL_FAULT_STEP (the pipeline is warm: its graphs replay)
    pipe = pipes["attached"]
    bus, events = TelemetryBus(), EventBus()
    bank = DetectorBank(bus, events)
    rca = RootCauseAnalyzer(bank)
    pipe.attach_telemetry(bus, zones=zones, injector=FaultInjector([
        FaultSpec("compute_delay", zone="stage1", acc_type="host",
                  start_step=TEL_FAULT_STEP, factor=TEL_FAULT_FACTOR)]))
    losses = [pipe.train_step(batches[i]) for i in range(TEL_STEPS)]
    steps += TEL_STEPS
    early = [a for a in bank.anomalies if a.step < TEL_FAULT_STEP]
    stage1 = [a for a in bank.anomalies
              if a.metric in ("fwd_time", "bwd_time") and a.key == (1, 0)]
    stragglers = events.of_type(Straggler)
    verdict = rca.classify(stragglers[0]) if stragglers else None
    nm = dc.num_microbatches
    counts = dict(fwd=[len(bus.values("fwd_time", (i, 0))) for i in (0, 1)],
                  bwd=[len(bus.values("bwd_time", (i, 0))) for i in (0, 1)],
                  p2p=len(bus.values("p2p_time", (0, 1, 0, 0))),
                  step=len(bus.values("step_time", ())),
                  heartbeat=[len(bus.values("heartbeat", (i, 0)))
                             for i in (0, 1)])
    zone_of = bus.latest("fwd_time", (1, 0)).meta.get("zone")
    if (early or not stage1 or not stragglers
            or min(a.step for a in stage1)
            >= TEL_FAULT_STEP + TEL_DETECT_WITHIN
            or verdict.kind != "slow-chip" or verdict.target != (1, 0)
            or zone_of != "stage1"
            or counts != dict(fwd=[TEL_STEPS * nm] * 2,
                              bwd=[TEL_STEPS * nm] * 2,
                              p2p=2 * TEL_STEPS * nm, step=TEL_STEPS,
                              heartbeat=[TEL_STEPS] * 2)
            or not all(np.isfinite(losses))):
        raise AssertionError(
            f"[manager] fault on stage1 from step {TEL_FAULT_STEP}: "
            f"anomalies {bank.anomalies}, events "
            f"{[e.describe() for e in events.log]}, verdict {verdict}, "
            f"zone {zone_of}, sample counts {counts}, losses {losses}")
    log("[manager] compute delay on stage1 " + json.dumps(dict(
        fault_step=TEL_FAULT_STEP, factor=TEL_FAULT_FACTOR,
        anomalies=[dict(metric=a.metric, key=a.key, step=a.step,
                        value=a.value, baseline=a.baseline, factor=a.factor,
                        zone=a.meta.get("zone")) for a in bank.anomalies],
        events=[e.describe() for e in events.log],
        verdict=verdict.describe(), verdict_kind=verdict.kind,
        verdict_target=verdict.target, remediation=verdict.remediation,
        evidence=verdict.evidence, sample_counts=counts,
        step_time_ms=[v * 1e3 for v in bus.values("step_time", ())])))
    launches = _pipe_launch_check("manager telemetry", cfg, dc, steps,
                                  prefix="[manager]")
    del pipe, pipes
    torch.cuda.empty_cache()
    return launches


def phase_manager() -> tuple:
    """Sailor's control plane (``manager/``, ``telemetry/``) driving the
    runtime on the card: (a) the controller over the elastic trainer,
    (b) telemetry and fault injection on the graphed pipeline.  Each is a
    main path for the attention kernels (and (a) the fused norm), forward
    and backward; returns the launches over each."""
    t0 = time.perf_counter()
    out = _manager_controller(), _manager_pipeline()
    log(f"[manager] phase seconds {time.perf_counter() - t0:.1f}")
    return out


# --- [examples]: the user entry points ---------------------------------------------

def examples_shapes():
    """(kernel, label, shape, dtype, backward) of what the examples
    launch: quickstart's pipeline (``opt-350m``, a microbatch of
    ``FULL_BATCH`` on each stage's positions, heads split over its tp;
    its stages run the unfused norm, so attention only), train_e2e's
    step (``demo-100m`` fp32, a microbatch), the elastic loop's positions
    in [manager] (a) (smollm-360M, its 8 x 32 tokens over dp
    ``MANAGER_DP``; 15/5 heads divide no 'model' axis past 1, so a
    position holds them all) and the served prefills (qwen1.5-0.5B,
    batch 1 at the prompts' pow2 buckets, forward only)."""
    from repro_torch.examples import (elastic_reconfig, quickstart,
                                      serve_batched, train_e2e)
    bf16, f32 = torch.bfloat16, torch.float32
    q = quickstart.execute_config(False)
    _, mbs, seq = quickstart.FULL_BATCH
    for i, tp in enumerate(EXAMPLES_TPS):
        h, kh = _local_heads(q.n_heads, q.n_kv_heads, tp)
        yield ("flash_attention", f"examples_quickstart_stage{i}_tp{tp}",
               (mbs, seq, h, kh, q.hd), bf16, True)
    t = train_e2e.CFG
    mb, s_ = train_e2e.GLOBAL_BATCH // train_e2e.NUM_MICRO, train_e2e.SEQ_LEN
    yield ("flash_attention", "examples_train_e2e",
           (mb, s_, t.n_heads, t.n_kv_heads, t.hd), f32, True)
    yield ("fused_add_rmsnorm", f"examples_train_e2e_rows{mb * s_}",
           (mb * s_, t.d_model), f32, True)
    e = get_config(elastic_reconfig.ARCH)
    gb, s_ = (elastic_reconfig.DATA["global_batch"],
              elastic_reconfig.DATA["seq_len"])
    for dp in MANAGER_DP:
        b = gb // dp
        yield ("flash_attention", f"examples_elastic_dp{dp}",
               (b, s_, e.n_heads, e.n_kv_heads, e.hd), bf16, True)
        yield ("fused_add_rmsnorm", f"examples_elastic_dp{dp}_rows{b * s_}",
               (b * s_, e.d_model), bf16, True)
    v = get_config(serve_batched.ARCH)
    buckets = sorted({_next_pow2(len(r.prompt))
                      for r in serve_batched.requests(v)})
    for b_ in buckets:
        yield ("flash_attention", f"examples_serve_s{b_}",
               (1, b_, v.n_heads, v.n_kv_heads, v.hd), bf16, False)
        yield ("fused_add_rmsnorm", f"examples_serve_rows{b_}",
               (b_, v.d_model), bf16, False)


def _example(name: str, argv) -> tuple:
    """``repro_torch.examples.<name>.main(argv)``: its figures, host
    seconds and the launches it made."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    out = mod.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    log(f"[examples] {name} seconds {seconds:.1f}, launches "
        f"{json.dumps(launches)}")
    return out, seconds, launches


def _examples_want(q: dict, eager: dict, te: dict, sv: dict,
                   sv_eager: dict) -> dict:
    """The launches the examples' figures give: the pipeline's attention
    forward 3 x layers x positions x microbatches a step (the forward,
    and the backward's recompute under remat) and its backward once (no
    fused norm: its stages run the unfused seam); a trainer's step the
    attention forward and the fused norm 2 x layers x microbatches (the
    forward and its recompute under full remat) and each backward once;
    a served prefill each forward kernel once a layer."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    ex = q["execute"]
    steps = len(ex["losses"]) + len(eager["losses"])
    per = ex["n_layers"] // len(ex["tps"]) * sum(ex["tps"]) * ex["batch"][0]
    want["flash_attention"] += 3 * per * steps
    want["flash_attention_bwd"] += per * steps
    # train_e2e: its steps, the resumed trainer's and the first one's
    # over the same steps
    steps = len(te["losses"]) + 2 * len(te["resumed_losses"])
    per = te["n_layers"] * te["num_microbatches"] * steps
    for fwd, bwd in (("flash_attention", "flash_attention_bwd"),
                     ("fused_add_rmsnorm", "fused_add_rmsnorm_bwd")):
        want[fwd] += 2 * per
        want[bwd] += per
    prefills = sv["serve"]["stats"]["prefill_calls"] + \
        sv_eager["stats"]["prefill_calls"]
    want["flash_attention"] += sv["serve"]["n_layers"] * prefills
    want["fused_add_rmsnorm"] += sv["serve"]["n_layers"] * prefills
    return want


def _quickstart_eager(q: dict) -> dict:
    """quickstart's execute half again, eager, from the same seed-0
    weights on the same positions and batch."""
    from repro_torch.examples import quickstart
    from repro_torch.examples.common import positions
    cfg = quickstart.execute_config(False)
    return quickstart.execute(
        cfg, q["execute"]["tps"], positions("cuda", quickstart.POSITIONS),
        quickstart.tokens(cfg, quickstart.FULL_BATCH), graphed=False)


def _serve_eager(sv: dict) -> dict:
    """serve_batched's requests again on an eager server of the same
    seed-0 weights at the planned decode batch."""
    from repro_torch.examples import serve_batched
    cfg = get_config(serve_batched.ARCH)
    params = model_lib.init(cfg, 0, device="cuda")
    return serve_batched.serve_locally(cfg, params, sv["decode_batch"],
                                       graphed=False)


def phase_examples() -> dict:
    """The user entry points at their defaults on the card (the module
    docstring's ``examples``; ``elastic_reconfig``'s loop runs in
    [manager] (a)), ``_release`` between them; a main path for the
    attention and fused-norm kernels, forward and backward.  Returns the
    launches over the four and the eager runs they are held against."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="examples-")
    ops.reset_launches()
    try:
        geo, secs_geo, _ = _example("geo_cost_planning", [])
        if not (geo["dtfm"] and geo["sailor"]["throughput"]
                > geo["dtfm"]["throughput"] and len(geo["spot"]) == 3):
            raise AssertionError(f"[examples] geo_cost_planning {geo}")
        log("[examples] geo_cost_planning " + json.dumps(
            dict(geo, seconds=secs_geo)))
        _release()
        q, secs_q, _ = _example("quickstart", [])
        _release()
        eg = _quickstart_eager(q)
        ex = q["execute"]
        if not (ex["tps"] == EXAMPLES_TPS and ex["n_layers"] == 24
                and ex["positions"] == 8 and all(ex["graphed_stages"])
                and not any(eg["graphed_stages"])
                and eg["losses"] == ex["losses"]
                and ex["losses"][-1] < ex["losses"][0]):
            raise AssertionError(f"[examples] quickstart {q}, eager {eg}")
        log("[examples] quickstart plans " + json.dumps(
            {k: q[k] for k in ("throughput", "min_cost", "simulator")}))
        log("[examples] quickstart execute " + json.dumps(dict(
            model=ex["model"], tps=ex["tps"], batch=ex["batch"],
            losses=ex["losses"], eager_losses=eg["losses"],
            bit_identical=eg["losses"] == ex["losses"],
            step_wall_ms=[w * 1e3 for w in ex["step_wall_s"]],
            eager_step_wall_ms=[w * 1e3 for w in eg["step_wall_s"]],
            replay_over_eager=ex["step_wall_s"][-1]
            / statistics.median(eg["step_wall_s"]), seconds=secs_q)))
        _release()
        te, secs_te, _ = _example("train_e2e", [
            "--workdir", os.path.join(workdir, "train_e2e")])
        if not (te["bit_identical"] and te["resumed_at"]
                == te["latest_checkpoint"] == te["steps"]
                and all(np.isfinite(te["losses"]))):
            raise AssertionError(f"[examples] train_e2e {te}")
        walls = [w * 1e3 for w in te["step_wall_s"]]
        log("[examples] train_e2e " + json.dumps(dict(
            params=te["params"], steps=te["steps"],
            tokens_per_s=te["tokens_per_s"], seconds_training=te["seconds"],
            first_loss=te["losses"][0], last_loss=te["losses"][-1],
            step_wall_ms_median=statistics.median(walls),
            step_wall_ms_first=walls[:3], captures=te["captures"],
            resumed_at=te["resumed_at"],
            resumed_losses=te["resumed_losses"],
            uninterrupted_losses=te["uninterrupted_losses"],
            bit_identical=te["bit_identical"], seconds=secs_te)))
        _release()
        sv, secs_sv, _ = _example("serve_batched", [])
        sv_eager = _serve_eager(sv)
        equal = (sv_eager["outputs"] == sv["serve"]["outputs"]
                 and sv_eager["stats"] == sv["serve"]["stats"])
        if not (sv["serve"]["graphed"] and not sv_eager["graphed"]
                and equal):
            raise AssertionError(f"[examples] serve_batched {sv}, eager "
                                 f"{sv_eager}")
        log("[examples] serve_batched " + json.dumps(dict(
            plan=sv["plan"], decode_batch=sv["decode_batch"],
            ttft_p99=sv["ttft_p99"], tpot_p99=sv["tpot_p99"],
            tokens_per_s_planned=sv["tokens_per_s"],
            cost_per_token=sv["cost_per_token"],
            graphed=sv["serve"], eager=sv_eager,
            tokens_equal=equal, seconds=secs_sv)))
        launches = _path_launches("examples", EXAMPLES_KERNELS)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = _examples_want(q, eg, te, sv, sv_eager)
    if launches != want:
        raise AssertionError(f"[examples] launches {json.dumps(launches)}, "
                             f"expected {json.dumps(want)}")
    _release()
    log(f"[examples] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


# --- [autotune] and the MoE family ------------------------------------------------

def _release() -> int:
    """Free what dropped references held: a graphed server or pipeline
    sits in reference cycles (its graphs and their pools with it) until
    the collector runs, and a model of the MoE phases needs the card's
    memory back.  cuBLAS keeps a workspace for every stream it ran on
    (every graphed step's side stream), allocated where a free block
    was: each pins its segment, so they are freed too (PyTorch frees them
    at every capture's start; the next call on a stream makes its own
    again).  Returns the bytes still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _tuned_check(dtype: torch.dtype, op: str):
    """``kernels_bench.autotuned``'s check: the kernel at the winning tile
    against its plain version at that tile (phase 3's tolerances)."""
    def check(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            tol = SSD_TOL[dtype][i] if op == "ssd_scan" else TOL[dtype]
            check_close(f"[autotune] {op} {dtype} output {i}", g, w, dtype,
                        tol)
    return check


def phase_autotune(untuned: dict) -> dict:
    """The block autotuner (``kernels/autotune.py``) on the card: each
    tuner at the [calibrate] grid's held-out shapes (``AUTOTUNE_SHAPES``),
    bf16 and fp32, from an empty cache and again from another (does the
    second tune pick the same winner?), every candidate's ms, the winner's
    output against its plain version and its time against the default
    tile's; then ``calibrate_kernels(autotune_blocks=True)`` into a
    temporary cache directory and its table's held-out error (the tuned
    kernels measured) beside [calibrate]'s untuned table's.  A main path
    for the five calibrated kernels."""
    import tempfile
    ops.reset_launches()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="autotune-", dir=os.path.join(ROOT,
                                                                "build"))
    rows = []
    for dtype in ("bfloat16", "float32"):
        for op, shape in AUTOTUNE_SHAPES:
            r = kernels_bench.autotuned(
                op, shape, dtype, cache_dir=tmp, iters=AUTOTUNE_ITERS,
                device="cuda", check=_tuned_check(getattr(torch, dtype), op))
            row = dict(op=op, shape=list(shape), dtype=dtype,
                       winner=r["config"], default=r["default"],
                       candidates_ms=[[c["config"], c["s"] * 1e3]
                                      for c in r["candidates"]],
                       tuned_ms=r["tuned_s"] * 1e3,
                       default_ms=r["default_s"] * 1e3,
                       vs_default=r["vs_default"],
                       same_winner=r["same_winner"])
            rows.append(row)
            log(f"[autotune] {json.dumps(row)}")
    same = sum(r["same_winner"] for r in rows)
    log(f"[autotune] the second tune from an empty cache picked the same "
        f"winner in {same} of {len(rows)} tunes")
    old = os.environ.get("REPRO_KERNEL_CACHE_DIR")
    os.environ["REPRO_KERNEL_CACHE_DIR"] = os.path.join(tmp, "calibrate")
    at._shared_cache.cache_clear()
    try:
        t0 = time.perf_counter()
        cal = measured.calibrate_kernels(at.default_chip("cuda"),
                                         dtypes=("bfloat16", "float32"),
                                         iters=10, autotune_blocks=True,
                                         register=False, **CAL_GRID)
        t_cal = time.perf_counter() - t0
        acc = kernels_bench.cost_table_accuracy(
            cal.table, HELD_OUT, dtypes=("bfloat16", "float32"), iters=10,
            blocks="auto")
        with open(at.default_cache_path(at.default_chip("cuda"))) as f:
            winners = {k: v["config"] for k, v in json.load(f).items()}
    finally:
        if old is None:
            os.environ.pop("REPRO_KERNEL_CACHE_DIR", None)
        else:
            os.environ["REPRO_KERNEL_CACHE_DIR"] = old
        at._shared_cache.cache_clear()
    log(f"[autotune] calibrate_kernels(autotune_blocks=True): "
        f"{cal.table.n_points()} points in {t_cal:.1f}s, "
        f"{len(winners)} tuned shapes: {json.dumps(winners)}")
    for dtype, res in acc.items():
        keys = ("median_table_err", "suite_table_err", "median_roofline_err",
                "suite_roofline_err")
        log(f"[autotune] held-out error {dtype}: " + json.dumps(dict(
            tuned={k: res[k] for k in keys},
            untuned={k: untuned[dtype][k] for k in keys})))
        for r in res["rows"]:
            log(f"[autotune] accuracy {dtype} {json.dumps(r)}")
    launches = _path_launches("autotune", CALIBRATE_KERNELS)
    log(f"[autotune] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _moe_params(cfg):
    params = model_lib.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in opt_lib.tree_leaves(params))
    log(f"[moe] {cfg.name}, {cfg.n_layers} layers at published widths "
        f"({cfg.param_dtype}): {n / 1e9:.3f}B params, "
        f"{n * 2 / 1e9:.2f} GB")
    return params


def _serve_moe(label, cfg, params, reqs, warm, max_len, batch) -> dict:
    """``BatchedServer`` graphed and eager on the same requests, each after
    two warm runs of ``warm`` (a graph's shape runs eagerly first, is
    captured the second time, replayed after): the tokens equal; tok/s
    and the launches of each timed run."""
    out = {}
    runs = {}
    for graphed in (None, False):
        name = "graphed" if graphed is None else "eager"
        server = BatchedServer(cfg, params, max_len=max_len,
                               batch_size=batch, graphed=graphed)
        for _ in range(2):
            server.run(_fresh_requests(warm))
        before = dict(ops.LAUNCHES)
        got = _fresh_requests(reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run(got)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = got
        tokens = sum(len(r.output) for r in got)
        out[name] = dict(
            steady_s=wall, tokens=tokens, steady_tok_s=tokens / wall,
            launches={k: ops.LAUNCHES[k] - before[k]
                      for k in ("flash_attention", "fused_add_rmsnorm")})
        del server
    _same_tokens(label, runs["graphed"], runs["eager"])
    out["graphed_tokens_equal_eager"] = True
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe serve] {label}: {json.dumps(out)}")
    return out


def _window_prefill_check(label, cfg, params, toks, tol) -> None:
    """Mixtral's prefill logits through the served path (past the window:
    ``attn_window_linear``; the fused norm kernel) against the plain path
    (``attention(impl="naive", window=...)``, the full score matrix under
    the window mask; the unfused norm), on the same weights and tokens.
    In bf16 a hidden state that rounds otherwise can flip a token's
    experts, an O(1) change to its logits, so the bf16 row is reported
    (largest and 99.9th-percentile difference, top-1 agreement) and the
    fp32 row held to ``tol``."""
    with torch.no_grad():
        served = model_lib.forward(cfg, params, {"tokens": toks})
        plain = model_lib.forward(cfg, params, {"tokens": toks},
                                  attn_impl="naive")
    err = (served - plain).abs()
    per_pos = err.amax(-1).flatten().float()
    row = dict(shape=list(served.shape), dtype=cfg.dtype,
               max_abs_diff=err.max().item(),
               p999_position_max_abs_diff=torch.quantile(
                   per_pos, 0.999).item(),
               median_position_max_abs_diff=per_pos.median().item(),
               last_token_max_abs_diff=err[:, -1].max().item(),
               top1_agreement=(served.argmax(-1) == plain.argmax(-1))
               .float().mean().item(),
               logits_spread=served.std().item(), tol=tol)
    log(f"[moe serve] mixtral prefill logits {label}, window-linear + "
        f"kernels vs naive window attention + plain norm: "
        f"{json.dumps(row)}")
    if tol is not None and not row["max_abs_diff"] <= tol:
        raise AssertionError(f"[moe serve] mixtral {label} prefill logits "
                             f"differ from the plain path by "
                             f"{row['max_abs_diff']} (tol {tol})")


def phase_moe_serve() -> dict:
    """The MoE family served at published widths, cut to MOE_SERVE_LAYERS
    layers, bf16, seeded weights: dbrx-132b on [serve]'s requests, and
    mixtral-8x22b on MIXTRAL_ROWS prompts of MIXTRAL_PROMPT tokens (past
    its 4096-token window: the prefill runs ``attn_window_linear``, the
    cache is the 4096-slot ring) and MIXTRAL_NEW tokens, graphed and
    eager with equal tokens; mixtral's prefill logits against the plain
    path (``attention(impl="naive", window=4096)``, the unfused norm).
    A main path for the prefill kernels (dbrx: attention and the fused
    norm; mixtral: the fused norm, its attention routed to the window)."""
    ops.reset_launches()
    t_phase = time.perf_counter()
    log(f"[moe serve] allocated at the start: {_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("dbrx_132b"),
                              n_layers=MOE_SERVE_LAYERS)
    params = _moe_params(cfg)
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    # warmed on the same requests, so the timed run replays every prefill
    # and decode graph
    dbrx = _serve_moe(cfg.name, cfg, params, reqs, reqs,
                      PROMPT_MAX + MAX_NEW + 8, BATCH)
    if not all(dbrx[r]["launches"]["flash_attention"] for r in
               ("graphed", "eager")):
        raise AssertionError("[moe serve] dbrx: no attention kernel launch")
    del params
    _release()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              n_layers=MOE_SERVE_LAYERS)
    params = _moe_params(cfg)
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, MIXTRAL_PROMPT, dtype=np.int32),
        max_new_tokens=MIXTRAL_NEW) for i in range(MIXTRAL_ROWS)]
    mix = _serve_moe(cfg.name, cfg, params, reqs, reqs,
                     MIXTRAL_PROMPT + MIXTRAL_NEW + 8, MIXTRAL_ROWS)
    if any(mix[r]["launches"]["flash_attention"] for r in
           ("graphed", "eager")):
        raise AssertionError("[moe serve] mixtral: a prompt past the window "
                             "reached the attention kernel")
    # the servers' launches, read before the logit checks launch their own
    launches = _path_launches("moe serve", SERVE_KERNELS)
    toks = torch.from_numpy(np.stack([r.prompt for r in reqs])).cuda()
    _window_prefill_check("bf16 (served)", cfg, params, toks, None)
    del params
    _release()
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    _window_prefill_check("fp32", f32, model_lib.init(f32, 0, device="cuda"),
                          toks, MIXTRAL_F32_TOL)
    _release()
    log(f"[moe serve] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_moe_train() -> dict:
    """dbrx-132b at published widths, 1 layer, bf16, full remat, AdamW on
    MOE_TRAIN_DATA: MOE_GRAPH_STEPS eager steps from seeded weights, then
    the graphed step (``make_graphed_train_step``) from the same weights
    on the same batches, losses bit for bit (one copy of the model at a
    time: two do not fit beside their AdamW state); then the loss falling
    over MOE_FALL_STEPS graphed steps on one batch, MOE_TIMED steps timed,
    one profiled.  A main path for the attention and fused-norm kernels,
    forward and backward."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("dbrx_132b"),
                              n_layers=MOE_TRAIN_LAYERS, remat="full")
    dc = data_lib.DataConfig(**MOE_TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(200 + i) for i in range(MOE_GRAPH_STEPS + 1)]
    tokens = dc.global_batch * dc.seq_len
    ops.reset_launches()
    log(f"[moe train] allocated at the start: {_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    params = _moe_params(cfg)
    state = opt_lib.init_state(params)
    step = train_lib.make_train_step(cfg, ocfg)
    eager, e_wall = [], []
    for b in batches[:MOE_GRAPH_STEPS]:
        wall, _, _, (params, state, m) = _timed_step(
            lambda b=b: step(params, state, b))
        eager.append(m["loss"].clone())
        e_wall.append(wall)
    e_peak = torch.cuda.max_memory_allocated()
    resident = _resident_bytes(params, state)
    del params, state, m
    _release()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init(cfg, 0, device="cuda")
    state = opt_lib.init_state(params)
    g = train_lib.make_graphed_train_step(cfg, ocfg, params, state,
                                          batches[0])
    graphed = []
    for i, b in enumerate(batches[:MOE_GRAPH_STEPS]):
        _, _, m = g(params, state, b)
        graphed.append(m["loss"].clone())
        if i == 0:      # the capture's pool takes what the eager call freed
            torch.cuda.synchronize()
            _release()
    same = all(torch.equal(a, b) for a, b in zip(eager, graphed))
    row = dict(eager=[x.item() for x in eager],
               graphed=[x.item() for x in graphed], bit_identical=same)
    log(f"[moe train] losses, graphed vs eager: {json.dumps(row)}")
    if not same:
        raise AssertionError("[moe train] graphed losses differ from eager")
    fall = [g(params, state, batches[-1])[2]["loss"].item()
            for _ in range(MOE_FALL_STEPS)]
    if not all(np.isfinite(fall)) or not fall[-1] < fall[0]:
        raise AssertionError(f"[moe train] losses {fall}: not finite, or the "
                             f"last is not below the first")
    g_peak = torch.cuda.max_memory_allocated()
    walls, devs = [], []
    for _ in range(MOE_TIMED):
        wall, dev, _, _ = _timed_step(lambda: g(params, state, batches[-1]))
        walls.append(wall)
        devs.append(dev)
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, data=MOE_TRAIN_DATA,
        falling_losses=fall, eager_step_wall_ms=statistics.median(e_wall),
        eager_tokens_per_s=tokens / (statistics.median(e_wall) / 1e3),
        step_wall_ms=statistics.median(walls), step_wall_ms_all=walls,
        step_device_ms=statistics.median(devs),
        tokens_per_s=tokens / (statistics.median(walls) / 1e3),
        resident_bytes=resident, eager_peak_mem_gib=e_peak / 2**30,
        graphed_peak_mem_gib=g_peak / 2**30,
        capture_s=g.capture_seconds)
    log(f"[moe train] {json.dumps(stats)}")
    profile_window("moe_train_step", lambda: g(params, state, batches[-1]),
                   statistics.median(walls), 1)
    del params, state, g
    _release()
    launches = _path_launches("moe train", TRAIN_KERNELS)
    log(f"[moe train] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_moe_pipeline() -> dict:
    """``MPMDPipeline(family="moe")`` at dbrx's widths cut to
    MOE_PIPE_CUT (2 layers, 4 experts, top-2), bf16, untied, full remat,
    on MOE_PIPE_DATA:
    two one-device stages on the card, eager then graphed from the same
    weights (losses bit for bit), then ``tps=[2, 1]`` eager (stage 0 a (1,
    2) mesh: 4 experts on 2 positions, expert parallel); each pipeline's
    first loss against the one-device ``loss_and_grads`` of the same
    weights, its step wall and per-stage resident bytes.  A main path for
    the attention kernels, forward and backward."""
    from repro_torch.dist import pipeline as pl
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("dbrx_132b"), tie_embeddings=False,
                              remat="full", **MOE_PIPE_CUT)
    dc = data_lib.DataConfig(**MOE_PIPE_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(300 + i) for i in range(MOE_PIPE_STEPS)]
    log(f"[moe pipeline] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    full = _moe_params(cfg)
    want, grads = train_lib.loss_and_grads(cfg, full, batches[0])
    want = want.item()
    del grads
    ops.reset_launches()        # the pipelines' launches, not the check's
    rows, losses = {}, {}
    for label, tps, graphed in (("[1, 1] eager", (1, 1), False),
                                ("[1, 1] graphed", (1, 1), None),
                                ("[2, 1] eager", (2, 1), False)):
        _release()
        pipe = _pipe(pl, cfg, ocfg, full, graphed, tps=tps)
        if tps[0] == 2 and \
                pipe.params[0]["layers"]["we_up"].spec[1] != "model":
            raise AssertionError("[moe pipeline] stage 0's experts are not "
                                 "split over 'model'")
        out, walls = [], []
        # the compared steps (a graphed pipeline's first eager, its second
        # capturing), then MOE_PIPE_TIMED more on the last batch
        for b in batches + [batches[-1]] * MOE_PIPE_TIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(pipe.train_step(b))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        losses[label] = out[:len(batches)]
        rows[label] = dict(
            losses=out, first_vs_one_device=abs(out[0] - want) / abs(want),
            step_wall_ms_all=walls,
            step_wall_ms=statistics.median(walls[len(batches):]),
            tokens_per_s=dc.global_batch * dc.seq_len
            / (statistics.median(walls[len(batches):]) / 1e3),
            per_stage=_pipe_position_bytes(pipe))
        log(f"[moe pipeline] {label}: {json.dumps(rows[label])}")
        if not rows[label]["first_vs_one_device"] <= TRAIN_LOSS_TOL:
            raise AssertionError(f"[moe pipeline] {label}: first loss "
                                 f"{out[0]} against {want} on one device")
        del pipe
    if losses["[1, 1] eager"] != losses["[1, 1] graphed"]:
        raise AssertionError("[moe pipeline] graphed losses differ from "
                             "eager")
    log(f"[moe pipeline] one-device loss {want}; [1, 1] graphed losses "
        f"equal eager bit for bit")
    del full
    _release()
    launches = _path_launches("moe pipeline", ("flash_attention",
                                               "flash_attention_bwd"))
    log(f"[moe pipeline] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _ssm_params(cfg, label: str):
    params = model_lib.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in opt_lib.tree_leaves(params))
    log(f"[{label}] {cfg.name}, {cfg.n_layers} layers at published widths "
        f"({cfg.param_dtype}): {n / 1e9:.3f}B params, "
        f"{n * 2 / 1e9:.2f} GB")
    return params


def _serve_len(cfg) -> int:
    """The servers' ``max_len``: the longest prompt, the new tokens and 8,
    and before them a vlm's patch positions (``launch.serve``'s sizing)."""
    patches = cfg.n_patches if cfg.family == "vlm" else 0
    return patches + PROMPT_MAX + MAX_NEW + 8


def _serve_ssm(label, cfg, params, reqs, per_prefill: dict) -> dict:
    """``BatchedServer`` graphed and eager on ``reqs``, each after a warm
    run on the same requests (the timed graphed run replays every prefill
    and decode graph): equal tokens, ``steady_tok_s``, and each timed
    run's launches, which must be ``per_prefill`` a prefill and nothing
    else (the state-space and the stubbed-frontend phases)."""
    n_prefill = -(-len(reqs) // BATCH)
    out, runs = {}, {}
    for graphed in (None, False):
        name = "graphed" if graphed is None else "eager"
        server = BatchedServer(cfg, params, max_len=_serve_len(cfg),
                               batch_size=BATCH, graphed=graphed)
        server.run(_fresh_requests(reqs))
        got = _fresh_requests(reqs)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.run(got)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = {k: per_prefill.get(k, 0) * n_prefill for k in launches}
        if launches != want:
            raise AssertionError(f"[{label}] {name} launches {launches}, "
                                 f"expected {want}")
        runs[name] = got
        tokens = sum(len(r.output) for r in got)
        out[name] = dict(steady_s=wall, tokens=tokens,
                         steady_tok_s=tokens / wall, prefills=n_prefill,
                         decode_steps=server.decode_steps,
                         launches={k: v for k, v in launches.items() if v})
        if graphed is None:
            out[name]["graphs"] = dict(
                prefill=[list(k) for k in server.prefill_graph.graphs],
                decode=sorted(server.decode_graph.graphs))
        del server
        _release()
    _same_tokens(label, runs["graphed"], runs["eager"])
    out["graphed_tokens_equal_eager"] = True
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{label}] {json.dumps(out)}")
    return out


def _ssm_turns(label, cfg, params, reqs) -> dict:
    """The first batch's prefill and single decode steps, graphed and
    eager in turns from the same state (``_prefill_in_turns``,
    ``_decode_in_turns``: equal bit for bit after)."""
    batch = reqs[:BATCH]
    plen = max(len(r.prompt) for r in batch)
    toks = np.zeros((len(batch), plen), np.int64)
    for i, r in enumerate(batch):
        toks[i, plen - len(r.prompt):] = r.prompt
    state = serve_step.decode_state(cfg, BATCH, _serve_len(cfg),
                                    per_row=False, device="cuda")
    pre = _prefill_in_turns(label, cfg, params, serve_step.GraphedPrefill(
        cfg, params, state), state, toks)
    held = int(state["len"])        # the prefill's positions, patches too
    dec = _decode_in_turns(cfg, params, serve_step.GraphedDecodeStep(
        cfg, params, state), state, len(batch), held, label)
    row = dict(prefill_shape=list(toks.shape),
               prefill_graphed_ms=pre["graphed_ms"],
               prefill_eager_ms=pre["eager_ms"],
               decode_graphed_ms=dec["graphed_ms"],
               decode_eager_ms=dec["eager_ms"])
    profile_window(f"{cfg.name}_decode", lambda: dec["run"]("graphed", 4),
                   4 * dec["graphed_ms"], 4)
    del state, pre, dec
    _release()
    return row


def _route_check(label, cfg, params, shape, seed: int) -> dict:
    """An fp32 prefill of ``shape`` through the SSD kernel route and the
    ``"chunked"`` route (``ssd_chunked``) on the same weights and tokens:
    last-position logits within ROUTE_TOL, final SSM states within
    ROUTE_STATE_TOL, each as max |kernel - chunked|."""
    mod = model_lib.get_module(cfg)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
    res = {}
    with torch.no_grad():
        for impl in ("kernel", "chunked"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = mod.forward(cfg, params, {"tokens": toks},
                                        return_cache=True, ssd_impl=impl)
            torch.cuda.synchronize()
            res[impl] = (logits[:, -1].clone(), cache["ssm"].clone(),
                         (time.perf_counter() - t0) * 1e3)
            del logits, cache
    dl = (res["kernel"][0] - res["chunked"][0]).abs().max().item()
    ds = (res["kernel"][1] - res["chunked"][1]).abs().max().item()
    row = dict(shape=list(shape), layers=cfg.n_layers, dtype=cfg.dtype,
               logits_max_abs_diff=dl, state_max_abs_diff=ds,
               logits_spread=res["chunked"][0].std().item(),
               state_max_abs=res["chunked"][1].abs().max().item(),
               kernel_route_wall_ms=res["kernel"][2],
               chunked_route_wall_ms=res["chunked"][2],
               tol=[ROUTE_TOL, ROUTE_STATE_TOL])
    log(f"[{label}] fp32 prefill, kernel route vs chunked route: "
        f"{json.dumps(row)}")
    if not (dl <= ROUTE_TOL and ds <= ROUTE_STATE_TOL):
        raise AssertionError(f"[{label}] the SSD routes differ: logits "
                             f"{dl}, states {ds}")
    return row


def phase_ssm_serve() -> dict:
    """mamba2-130m served at published widths and depth (``[ssm serve]``),
    then its SSD routes held against each other in fp32.  A main path for
    the SSD kernel: 24 launches a prefill."""
    t_phase = time.perf_counter()
    log(f"[ssm serve] allocated at the start: {_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SSM_ARCH)
    params = _ssm_params(cfg, "ssm serve")
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    _serve_ssm("ssm serve", cfg, params, reqs, {"ssd_scan": cfg.n_layers})
    # the servers' launches: the timed eager run's (each run checked alike)
    launches = dict(ops.LAUNCHES)
    log(f"[ssm serve] in turns: "
        f"{json.dumps(_ssm_turns('ssm serve', cfg, params, reqs))}")
    _route_check("ssm serve", *_f32_copy(cfg, params), SSM_ROUTE_SHAPE, 3)
    del params
    _release()
    log(f"[ssm serve] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_hybrid_serve() -> dict:
    """zamba2-2.7b served at published widths and all 54 layers
    (``[hybrid serve]``), then its SSD routes in fp32 at 12 layers.  A
    main path for the SSD kernel (54 launches a prefill) and the attention
    kernel (9: the shared block's applications)."""
    t_phase = time.perf_counter()
    log(f"[hybrid serve] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID_ARCH)
    params = _ssm_params(cfg, "hybrid serve")
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    groups = cfg.n_layers // cfg.attn_every
    _serve_ssm("hybrid serve", cfg, params, reqs,
               {"ssd_scan": cfg.n_layers, "flash_attention": groups})
    launches = dict(ops.LAUNCHES)
    log(f"[hybrid serve] in turns: "
        f"{json.dumps(_ssm_turns('hybrid serve', cfg, params, reqs))}")
    del params
    _release()
    f32 = dataclasses.replace(cfg, n_layers=HYBRID_ROUTE_LAYERS,
                              dtype="float32", param_dtype="float32")
    _route_check("hybrid serve", f32, model_lib.init(f32, 0, device="cuda"),
                 HYBRID_ROUTE_SHAPE, 4)
    _release()
    log(f"[hybrid serve] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _ssm_train_case(cfg, data: dict, label: str = "ssm train") -> dict:
    """Eager steps from seeded weights, then the graphed step
    (``make_graphed_train_step``) from the same weights on the same
    batches (one copy of the model at a time), SSM_TRAIN_STEPS each:
    losses equal bit for bit, loss and gradient norm finite at every
    step, the graphed steps timed; ``capture_launches`` the graph's
    launches a step (the state-space and the stubbed-frontend phases)."""
    dc = data_lib.DataConfig(**data)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(300 + i) for i in range(SSM_TRAIN_STEPS)]
    tokens = dc.global_batch * dc.seq_len
    _release()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init(cfg, 0, device="cuda")
    state = opt_lib.init_state(params)
    step = train_lib.make_train_step(cfg, ocfg)
    eager, e_wall, e_dev = [], [], []
    for b in batches:
        wall, dev, _, (params, state, m) = _timed_step(
            lambda b=b: step(params, state, b))
        eager.append({k: m[k].clone() for k in ("loss", "grad_norm")})
        e_wall.append(wall)
        e_dev.append(dev)
    e_peak = torch.cuda.max_memory_allocated()
    resident = _resident_bytes(params, state)
    del params, state, m
    _release()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init(cfg, 0, device="cuda")
    state = opt_lib.init_state(params)
    g = train_lib.make_graphed_train_step(cfg, ocfg, params, state,
                                          batches[0])
    graphed, g_wall, g_dev = [], [], []
    for i, b in enumerate(batches):
        wall, dev, _, (_, _, m) = _timed_step(
            lambda b=b: g(params, state, b))
        graphed.append({k: m[k].clone() for k in ("loss", "grad_norm")})
        g_wall.append(wall)
        g_dev.append(dev)
    timed = [_timed_step(lambda: g(params, state, batches[-1]))[:2]
             for _ in range(SSM_TIMED)]
    g_peak = torch.cuda.max_memory_allocated()
    vals = [x[k].item() for x in eager + graphed for k in x]
    if not all(np.isfinite(vals)):
        raise AssertionError(f"[{label}] {cfg.name}: non-finite loss or "
                             f"gradient norm {vals}")
    same = all(torch.equal(a["loss"], b["loss"])
               for a, b in zip(eager, graphed))
    diff = max((a["loss"] - b["loss"]).abs().item()
               for a, b in zip(eager, graphed))
    if not same:
        raise AssertionError(f"[{label}] {cfg.name}: graphed losses differ "
                             f"from eager by {diff}: not bit for bit")
    # graphed: SSM_TIMED replays after the compared steps (the first of
    # those ran eagerly, the second captured); eager: steps 2.. (step 1
    # builds and loads)
    wall = statistics.median(t[0] for t in timed)
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, data=data,
        eager_losses=[x["loss"].item() for x in eager],
        graphed_losses=[x["loss"].item() for x in graphed],
        grad_norms=[x["grad_norm"].item() for x in graphed],
        losses_bit_identical=same, max_loss_diff=diff,
        step_wall_ms=wall, step_wall_ms_all=[t[0] for t in timed],
        step_device_ms=statistics.median(t[1] for t in timed),
        compared_graphed_wall_ms=g_wall, compared_graphed_device_ms=g_dev,
        tokens_per_s=tokens / (wall / 1e3),
        eager_step_wall_ms=statistics.median(e_wall[1:]),
        eager_step_device_ms=statistics.median(e_dev[1:]),
        eager_tokens_per_s=tokens / (statistics.median(e_wall[1:]) / 1e3),
        resident_bytes=resident, eager_peak_mem_gib=e_peak / 2**30,
        graphed_peak_mem_gib=g_peak / 2**30, capture_s=g.capture_seconds,
        capture_launches={k: v for k, v in g.capture_launches.items()
                          if v})
    log(f"[{label}] {json.dumps(stats)}")
    profile_window(f"{cfg.name}_train_step", lambda: g(params, state,
                                                       batches[-1]),
                   wall, 1)
    del params, state, g
    _release()
    return stats


def phase_ssm_train() -> dict:
    """mamba2-130m at 24 layers and zamba2-2.7b at 12 (``[ssm train]``),
    bf16, full remat, at published widths: the train path takes the
    differentiable ``"chunked"`` SSD (the kernel has no backward), so the
    SSD kernel must not launch; the hybrid's shared block runs the
    attention kernel forward and backward at head dim 80."""
    t_phase = time.perf_counter()
    ops.reset_launches()
    log(f"[ssm train] allocated at the start: {_release() / 2**30:.2f} GiB")
    _ssm_train_case(get_config(SSM_ARCH), SSM_TRAIN_DATA)
    mamba = dict(ops.LAUNCHES)
    _ssm_train_case(dataclasses.replace(get_config(HYBRID_ARCH),
                                        n_layers=HYBRID_TRAIN_LAYERS),
                    HYBRID_TRAIN_DATA)
    launches = dict(ops.LAUNCHES)
    if launches["ssd_scan"] or any(mamba.values()):
        raise AssertionError(f"[ssm train] kernel launches on the chunked "
                             f"path: mamba2 {mamba}, both {launches}")
    _path_launches("ssm train", ("flash_attention", "flash_attention_bwd"))
    log(f"[ssm train] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _ssm_mesh_cfg(arch: str, policy: str, **kw):
    """[ssm mesh]'s model: published widths, full remat, zamba2 at
    HYBRID_TRAIN_LAYERS."""
    if arch == HYBRID_ARCH:
        kw.setdefault("n_layers", HYBRID_TRAIN_LAYERS)
    return dataclasses.replace(get_config(arch), remat="full",
                               sharding=policy, **kw)


def _ssm_mesh_small_cfg(arch: str):
    cfg = _ssm_mesh_cfg(arch, "fsdp_tp", n_layers=2, dtype="float32",
                        param_dtype="float32")
    return dataclasses.replace(cfg, attn_every=2) if cfg.attn_every else cfg


def _position_heads(n: int, tp: int) -> int:
    """Heads a position holds: split over 'model' where it divides them."""
    return n // tp if n % tp == 0 else n


def ssm_mesh_shapes():
    """(kernel, label, shape, dtype, backward) of what [ssm mesh] runs:
    ``ssd_scan`` (b, S, heads, P, N) in the forward without a gradient on
    one microbatch, each bf16 mesh's position and the one device it is
    held against (in bf16 and in fp32, ``_f32_copy``); the attention (b, S,
    heads, K/V heads, D) of the hybrid's shared block on its mesh and on
    one device (bf16 and fp32) and in the fp32 2-layer check, on (2, 2)
    and on one device, forward and backward."""
    bf16, f32 = torch.bfloat16, torch.float32
    seen = set()
    for arch, policy, (dp, tp) in SSM_MESH_CASES:
        cfg = _ssm_mesh_cfg(arch, policy)
        data = SSM_TRAIN_DATA if arch == SSM_ARCH else HYBRID_TRAIN_DATA
        mb = data["global_batch"] // data["num_microbatches"]
        s = data["seq_len"]
        ssd = (cfg.ssm_headdim, cfg.ssm_state)
        attn = (cfg.n_heads, cfg.n_kv_heads)
        tags = [(f"ssm_mesh_{arch}_{dp}x{tp}", mb // dp, tp, (bf16,))]
        if arch not in seen:
            seen.add(arch)
            tags.append((f"ssm_mesh_{arch}_one_device", mb, 1, (bf16, f32)))
        for tag, b, t, dtypes in tags:
            for dt in dtypes:
                label = tag if dt == bf16 else f"{tag}_f32"
                yield ("ssd_scan", label,
                       (b, s, _position_heads(cfg.ssm_nheads, t), *ssd), dt,
                       False)
                if cfg.attn_every:
                    yield ("flash_attention", label,
                           (b, s, *(_position_heads(n, t) for n in attn),
                            cfg.hd), dt, True)
    small = _ssm_mesh_small_cfg(HYBRID_ARCH)
    d = SSM_MESH_SMALL_DATA
    mb = d["global_batch"] // d["num_microbatches"]
    yield ("flash_attention", "ssm_mesh_f32_2x2",
           (mb // 2, d["seq_len"], _position_heads(small.n_heads, 2),
            _position_heads(small.n_kv_heads, 2), small.hd), f32, True)
    yield ("flash_attention", "ssm_mesh_f32_one_device",
           (mb, d["seq_len"], small.n_heads, small.n_kv_heads, small.hd),
           f32, True)


def serve_mesh_cases():
    """(label, cfg, mesh shape, rows, prompt, buffer, steps) of [serve
    mesh]."""
    for policy, shape in MESH_CASES:
        yield (f"{ARCH} {shape[0]}x{shape[1]} {policy}",
               dataclasses.replace(get_config(ARCH), sharding=policy), shape,
               SERVE_MESH_ROWS, SERVE_MESH_PROMPT, SERVE_MESH_LEN,
               SERVE_MESH_STEPS)
    for arch, layers, policy, shape, rows, prompt, steps in \
            SERVE_MESH_OTHERS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  sharding=policy)
        yield (f"{arch} {shape[0]}x{shape[1]} {policy}", cfg, shape, rows,
               prompt, prompt + steps + 8, steps)


def _local_heads(h: int, kh: int, tp: int):
    """(query heads, K/V heads) a position's prefill attention runs
    (``spmd.layout`` and ``spmd._kv_heads`` under the ``tp`` rules):
    the query heads split where 'model' divides them, the K/V heads their
    block where it divides those, else the ones its query heads read."""
    if h % tp:
        return h, kh
    n, g = h // tp, h // kh
    if kh % tp == 0:
        return n, kh // tp
    return n, (n // g if n % g == 0 else 1 if g % n == 0 else n)


def serve_mesh_shapes():
    """(kernel, label, shape, dtype) of what [serve mesh]'s prefills launch:
    each mesh position's (attention (b, S, heads, K/V heads, D), the fused
    norm (rows, D), the SSD (b, S, heads, P, N)) in bf16 and the one-device
    fp32 prefill it is held against."""
    bf16, f32 = torch.bfloat16, torch.float32
    for label, cfg, (dp, tp), rows, prompt, _, _ in serve_mesh_cases():
        tag = "serve_mesh_" + label.split()[0] + f"_{dp}x{tp}"
        for name, b, t, dt in ((tag, rows // dp if rows % dp == 0 else rows,
                                tp, bf16), (tag + "_one_device_f32", rows, 1,
                                            f32)):
            if cfg.family in ("ssm", "hybrid"):
                yield ("ssd_scan", name,
                       (b, prompt, _position_heads(cfg.ssm_nheads, t),
                        cfg.ssm_headdim, cfg.ssm_state), dt)
            if cfg.family == "ssm" or cfg.window:
                continue          # no attention, or a window's plain path
            yield ("flash_attention", name,
                   (b, prompt, *_local_heads(cfg.n_heads, cfg.n_kv_heads, t),
                    cfg.hd), dt)
        if cfg.family in ("dense", "moe"):
            for name, b, dt in ((tag, rows // dp if rows % dp == 0 else rows,
                                 bf16),
                                (tag + "_one_device_f32", rows, f32)):
                yield ("fused_add_rmsnorm", f"{name}_rows{b * prompt}",
                       (b * prompt, cfg.d_model), dt)


def _f32_copy(cfg, params):
    """``cfg`` and ``params`` in fp32 (the same weights cast up)."""
    return (dataclasses.replace(cfg, dtype="float32", param_dtype="float32"),
            opt_lib.tree_unflatten([(k, v.float()) for k, v in
                                    opt_lib.tree_leaves(params)]))


def _grads_reference(cfg, full, batch) -> dict:
    """The one-device ``loss_and_grads`` of ``batch`` in bf16 and from the
    same weights in fp32 (``_f32_copy``: the bf16 step's own rounding):
    the bf16 loss and gradients, the fp32 loss, and each leaf's own
    bf16-vs-fp32 distance (of the fp32 max |g|); the fp32 gradients are
    not kept (internvl2's 2 layers are 7.7 GB of them)."""
    wl, wg = train_lib.loss_and_grads(cfg, full, batch)
    cfg32, full32 = _f32_copy(cfg, full)
    fl, fg = train_lib.loss_and_grads(cfg32, full32, batch)
    del full32
    grads = dict(opt_lib.tree_leaves(wg))
    own = {k: ((grads[k].float() - g).abs().max() / g.abs().max()).item()
           for k, g in opt_lib.tree_leaves(fg)}
    del fg
    _release()
    return dict(loss=wl.item(), loss32=fl.item(), grads=grads, own=own)


def _ssm_mesh_reference(cfg, full, batch, toks) -> dict:
    """What every mesh of a family is held against: ``_grads_reference``
    of ``batch`` and the last position's logits of the one-device forward
    without a gradient on ``toks``, in bf16 and from the same weights in
    fp32."""
    ref = _grads_reference(cfg, full, batch)
    cfg32, full32 = _f32_copy(cfg, full)
    with torch.no_grad():
        ref["logits"] = model_lib.forward(cfg, full, {"tokens": toks})[
            :, -1].clone()
        ref["logits32"] = model_lib.forward(cfg32, full32, {"tokens": toks})[
            :, -1].clone()
    del full32
    _release()
    return ref


def _ssm_mesh_grads(label, cfg, mesh, params, batch, ref,
                    phase="ssm mesh") -> dict:
    """The first step's loss and gradients on the mesh (unsharded leaf by
    leaf) against the one-device ones (``ref``, ``_grads_reference``'s):
    the loss within TRAIN_LOSS_TOL, each leaf's cosine at least
    TRAIN_COSINE and its max |dg| / max |g| within the larger of
    TRAIN_GRAD_TOL and twice the one-device bf16 gradient's own distance
    from the fp32 one's."""
    from repro_torch.dist import placement as pm
    gl, gg = train_lib.loss_and_grads(cfg, params, batch, mesh=mesh)
    worst, floor, min_cos = 0.0, 0.0, 1.0
    for k, x in pm.tree_items(gg):
        t, w = pm.unshard(x, "cuda").float(), ref["grads"][k].float()
        rel = ((t - w).abs().max() / w.abs().max()).item()
        own = ref["own"][k]
        cos = _cosine(t, w)
        worst, floor = max(worst, rel), max(floor, own)
        min_cos = min(min_cos, cos)
        if not (rel <= max(TRAIN_GRAD_TOL, 2 * own) and cos >= TRAIN_COSINE):
            raise AssertionError(
                f"[{phase}] {label} grad {k} vs single device: max |dg| / "
                f"max |g| {rel:.3e} (one device bf16 vs fp32 {own:.3e}), "
                f"cosine {cos:.6f}")
    if not abs(gl.item() - ref["loss"]) <= TRAIN_LOSS_TOL * abs(ref["loss"]):
        raise AssertionError(f"[{phase}] {label}: loss {gl.item()} vs "
                             f"single device {ref['loss']}")
    return dict(loss=gl.item(), single_loss=ref["loss"],
                fp32_loss=ref["loss32"], max_rel_grad_err=worst,
                single_bf16_vs_fp32=floor, min_cosine=min_cos,
                tol=TRAIN_GRAD_TOL, cosine_min=TRAIN_COSINE)


def _ssm_mesh_forward(label, cfg, mesh, params, toks, ref) -> dict:
    """The forward without a gradient on ``toks`` (one microbatch): every
    position launches the SSD kernel on its heads once a layer, and the
    hybrid's shared block the attention kernel once an application; the
    last position's logits against the one-device forward's (``ref``),
    within the larger of LOGITS_TOL and twice the one-device bf16 logits'
    distance from the fp32 ones'.  Returns the mesh forward's launches."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import P
    with torch.no_grad():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks, lay = spmd.forward(cfg, params, {"tokens": toks}, mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
    spec = P(lay.batch or None, None, "model" if lay.vocab_logits else None)
    got = pm.unshard(pm.Sharded((*toks.shape, cfg.vocab_size), spec, mesh,
                                blocks), "cuda")[:, -1]
    del blocks
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    want_launches = {k: 0 for k in launches}
    want_launches.update(ssd_scan=cfg.n_layers * mesh.size,
                         flash_attention=groups * mesh.size)
    want = ref["logits"]
    diff = (got - want).abs().max().item()
    floor = (want - ref["logits32"]).abs().max().item()
    tol = max(LOGITS_TOL, 2 * floor)
    row = dict(tokens=list(toks.shape), wall_ms=wall, ssm_heads=lay.ssm_heads,
               logits_max_abs_diff=diff, single_bf16_vs_fp32=floor,
               logits_spread=want.std().item(), tol=tol,
               finite=bool(torch.isfinite(got).all()),
               launches={k: v for k, v in launches.items() if v})
    log(f"[ssm mesh] {label} forward without a gradient vs one device: "
        + json.dumps(row))
    if launches != want_launches or not row["finite"] or not diff <= tol:
        raise AssertionError(f"[ssm mesh] {label} forward: {row}, expected "
                             f"launches {want_launches}")
    return launches


def _ssm_mesh_case(cfg, shape, full, batches, ref) -> dict:
    """One mesh at published widths: each position's memory, the first
    step's loss and gradients against one device (``_ssm_mesh_grads``),
    the forward without a gradient on the first batch's first microbatch
    (``_ssm_mesh_forward``), SSM_MESH_TIMED eager steps timed (the SSD on
    its differentiable route: no SSD launch; the hybrid's attention
    kernel forward and backward once an application, microbatch and
    position), replicas bit for bit, one step profiled.  Returns the
    launches of the forward and of the steps."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    data = SSM_TRAIN_DATA if cfg.family == "ssm" else HYBRID_TRAIN_DATA
    dc = data_lib.DataConfig(**data)
    mesh = _mesh_of(shape)
    label = (f"{cfg.name} {cfg.n_layers} layers {shape[0]}x{shape[1]} "
             f"{cfg.sharding}")
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg),
                                             cfg.sharding, mesh), mesh)
    state = opt_lib.init_sharded_state(params)
    log(f"[ssm mesh] {label} memory: "
        + json.dumps(_mesh_memory(cfg, mesh, params, state, data)))
    first = _ssm_mesh_grads(label, cfg, mesh, params, batches[0], ref)
    log(f"[ssm mesh] {label} first step vs the single-device loss_and_grads "
        f"(same weights and batch): " + json.dumps(first))
    toks = torch.as_tensor(batches[0]["tokens"][0], device="cuda")
    forward = _ssm_mesh_forward(label, cfg, mesh, params, toks, ref)
    del params, state
    graphed = (cfg.name, shape) in {(get_config(a).name, m)
                                    for a, m in GRAPHED_FAMILY_MESHES}
    n = GRAPHED_STEPS if graphed else SSM_MESH_TIMED
    got = _steps_in_turns(f"[ssm mesh] {label}", cfg, dc, mesh, full,
                          batches[1:1 + n], graphed)
    params, state, step = got["eager"]
    rows = got["rows"]["eager"]
    steps = got["total"]
    same = got["replicas"]
    per = (cfg.n_layers // cfg.attn_every if cfg.attn_every else 0) \
        * dc.num_microbatches * mesh.size
    n_runs = n * len(got["rows"])
    want = {k: 0 for k in steps}
    want.update(flash_attention=per * n_runs,
                flash_attention_bwd=per * n_runs)
    if steps != want:
        raise AssertionError(f"[ssm mesh] {label}: launches {steps} in "
                             f"{n_runs} steps, expected {want}")
    vals = [v for r in rows for v in r[3:]]
    if not (all(np.isfinite(vals)) and same):
        raise AssertionError(f"[ssm mesh] {label}: losses and gradient "
                             f"norms {vals}, replicas equal {same}")
    wall = statistics.median(r[0] for r in rows)
    tokens = dc.global_batch * dc.seq_len
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, mesh=dict(mesh.shape),
        policy=cfg.sharding, data=data, losses=[r[3] for r in rows],
        grad_norms=[r[4] for r in rows], step_wall_ms=wall,
        step_wall_ms_all=[r[0] for r in rows],
        step_device_ms=statistics.median(r[1] for r in rows),
        working_set_gib=max(r[2] for r in rows) / 2**30,
        tokens_per_s=tokens / (wall / 1e3),
        launches_per_step={k: v // n_runs for k, v in steps.items() if v},
        replicas_bit_identical=same)
    if graphed:
        stats.update(_graphed_stats(got, tokens))
    log(f"[ssm mesh] {label}: " + json.dumps(stats))
    name = cfg.name.replace("-", "_").replace(".", "_")
    dev_ms = profile_window(f"ssm_mesh_step_{name}_{shape[0]}x{shape[1]}",
                            lambda: step(params, state, batches[-1]), wall,
                            1)
    if dev_ms is not None:
        log(f"[ssm mesh] {label}: device ms of an eager step {dev_ms:.3f}, "
            f"busy {dev_ms / wall:.3f}")
    if graphed:
        gp, gs, gstep = got["graphed"]
        gwall = stats["graphed_step_wall_ms"]
        dev_ms = profile_window(
            f"ssm_mesh_step_graphed_{name}_{shape[0]}x{shape[1]}",
            lambda: gstep(gp, gs, batches[-1]), gwall, 1)
        if dev_ms is not None:
            log(f"[ssm mesh] {label}: device ms of a graphed step "
                f"{dev_ms:.3f}, busy {dev_ms / gwall:.3f}")
    del got
    return dict(forward=forward, steps=steps)


def _ssm_mesh_small_check(arch: str) -> dict:
    """fp32, 2 layers at published widths on (2, 2) ``fsdp_tp`` through
    the kernels: the sharded loss, gradients and one step against
    ``loss_and_grads`` and ``make_train_step`` from the same weights on
    the same batch, within SSM_MESH_F32_TOL (near-zero gradients' params:
    2 lr)."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    cfg = _ssm_mesh_small_cfg(arch)
    ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1)
    dc = data_lib.DataConfig(**SSM_MESH_SMALL_DATA)
    b = data_lib.SyntheticDataset(cfg, dc).batch(400)
    mesh = _mesh_of((2, 2))
    full = model_lib.init(cfg, 13, device="cuda")
    params = pm.shard_tree(full, param_specs(model_lib.decls(cfg),
                                             cfg.sharding, mesh), mesh)
    gl, gg = train_lib.loss_and_grads(cfg, params, b, mesh=mesh)
    wl, wg = train_lib.loss_and_grads(cfg, full, b)
    flat = dict(opt_lib.tree_leaves(wg))
    grad_err = max(((pm.unshard(x, "cuda") - flat[k]).abs().max()
                    / flat[k].abs().max()).item()
                   for k, x in pm.tree_items(gg))
    near = {k: g.abs() <= 1e-4 * g.abs().max() for k, g in flat.items()}
    del gg, wg, flat
    params, state, m2 = train_lib.jit_train_step(
        cfg, ocfg, mesh, dc.num_microbatches, dc.micro_batch,
        graphed=False)(params, opt_lib.init_sharded_state(params), b)
    full, _, m1 = train_lib.make_train_step(cfg, ocfg)(
        full, opt_lib.init_state(full), b)
    got = dict(opt_lib.tree_leaves(pm.unshard_tree(params, "cuda")))
    params_err = near_err = 0.0
    for k, w in opt_lib.tree_leaves(full):
        diff = (got[k] - w).abs()
        off = diff[~near[k]]
        if off.numel():
            params_err = max(params_err, off.max().item()
                             / max(1.0, w.abs().max().item()))
        if near[k].any():
            near_err = max(near_err, diff[near[k]].max().item())
    row = dict(arch=cfg.name, layers=cfg.n_layers, data=SSM_MESH_SMALL_DATA,
               loss=gl.item(), single_loss=wl.item(),
               step_loss=m2["loss"].item(), single_step_loss=m1["loss"].item(),
               grad_err=grad_err, params_err=params_err,
               near_zero_params_err=near_err, tol=SSM_MESH_F32_TOL,
               near_zero_bound=2 * ocfg.lr,
               replicas_bit_identical=_mesh_replicas_equal(params,
                                                           state["m"],
                                                           state["v"]))
    ok = (abs(row["loss"] - row["single_loss"])
          <= SSM_MESH_F32_TOL * abs(row["single_loss"])
          and abs(row["step_loss"] - row["single_step_loss"])
          <= SSM_MESH_F32_TOL * abs(row["single_step_loss"])
          and grad_err <= SSM_MESH_F32_TOL
          and params_err <= SSM_MESH_F32_TOL
          and near_err <= 2 * ocfg.lr and row["replicas_bit_identical"])
    if not ok:
        raise AssertionError(f"[ssm mesh] fp32 2 layers: {row}")
    del params, state, full, got
    _release()
    return row


def phase_ssm_mesh() -> dict:
    """The state-space families through the sharded (data, model) train
    step (``train_step.jit_train_step`` over ``dist/spmd_ssm.py``), every
    position on ``cuda:0``, eager and, on GRAPHED_FAMILY_MESHES, graphed
    beside it bit for bit, bf16 (``[ssm mesh]``): mamba2-130m on
    (2, 2) ``fsdp_tp`` and (1, 4) ``tp``, zamba2-2.7b at 12 layers on
    (1, 2) ``tp``, each family's meshes held against one device run once
    (``_ssm_mesh_reference``); then both in fp32 at 2 layers on (2, 2)
    against ``make_train_step``.  A main path for the SSD kernel (every
    position, every layer, in a forward without a gradient) and, through
    the hybrid's shared block, the attention kernel forward and backward.
    Returns the launches of the bf16 meshes' forwards and steps."""
    t_phase = time.perf_counter()
    log(f"[ssm mesh] allocated at the start: {_release() / 2**30:.2f} GiB")
    total: dict = {}
    by_mesh = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        meshes = [(p, s) for a, p, s in SSM_MESH_CASES if a == arch]
        cfg = _ssm_mesh_cfg(arch, meshes[0][0])
        data = SSM_TRAIN_DATA if arch == SSM_ARCH else HYBRID_TRAIN_DATA
        ds = data_lib.SyntheticDataset(cfg, data_lib.DataConfig(**data))
        batches = [ds.batch(300 + i) for i in range(GRAPHED_STEPS + 1)]
        full = model_lib.init(cfg, 0, device="cuda")  # [ssm train]'s weights
        ref = _ssm_mesh_reference(cfg, full, batches[0], torch.as_tensor(
            batches[0]["tokens"][0], device="cuda"))
        for policy, shape in meshes:
            got = _ssm_mesh_case(dataclasses.replace(cfg, sharding=policy),
                                 shape, full, batches, ref)
            by_mesh[f"{arch} {shape[0]}x{shape[1]} {policy}"] = {
                k: {n: c for n, c in v.items() if c} for k, v in got.items()}
            for v in got.values():
                _add_counts(total, v)
            _release()
        del full, ref
        _release()
    log(f"[ssm mesh] launches_ssm_mesh {json.dumps(by_mesh)}")
    missing = [n for n in ("ssd_scan", "flash_attention",
                           "flash_attention_bwd") if not total.get(n)]
    if missing:
        raise AssertionError(f"[ssm mesh] no launch of {missing} on the "
                             f"path ({total})")
    for arch in (SSM_ARCH, HYBRID_ARCH):
        log(f"[ssm mesh] fp32 2 layers on (2, 2) fsdp_tp vs make_train_step: "
            + json.dumps(_ssm_mesh_small_check(arch)))
    log(f"[ssm mesh] phase seconds {time.perf_counter() - t_phase:.1f}")
    return total


def _vlm_route_check(cfg, params) -> dict:
    """internvl2's fp32 prefill logits at VLM_ROUTE_SHAPE tokens after its
    patches (seeded, std 0.02 as the train data's): the kernel route (the
    attention kernel and the fused add + RMSNorm) against
    ``attn_impl="chunked"`` with the plain norm, on the same weights;
    within VLM_F32_TOL (the same fp32 terms summed in other orders)."""
    rng = np.random.default_rng(5)
    b, s = VLM_ROUTE_SHAPE
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab_size, (b, s))).cuda(),
             "patches": torch.from_numpy(0.02 * rng.standard_normal(
                 (b, cfg.n_patches, cfg.d_model)).astype(np.float32)).cuda()}
    res = {}
    with torch.no_grad():
        for impl in ("kernel", "chunked"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[impl] = model_lib.forward(cfg, params, batch, attn_impl=impl)
            torch.cuda.synchronize()
            res[impl + "_ms"] = (time.perf_counter() - t0) * 1e3
    err = (res["kernel"] - res["chunked"]).abs()
    row = dict(shape=list(res["kernel"].shape), layers=cfg.n_layers,
               dtype=cfg.dtype, max_abs_diff=err.max().item(),
               last_token_max_abs_diff=err[:, -1].max().item(),
               logits_spread=res["chunked"].std().item(),
               kernel_route_wall_ms=res["kernel_ms"],
               chunked_route_wall_ms=res["chunked_ms"], tol=VLM_F32_TOL)
    log(f"[vlm serve] fp32 prefill, kernel route vs chunked attention + "
        f"plain norm: {json.dumps(row)}")
    if not row["max_abs_diff"] <= VLM_F32_TOL:
        raise AssertionError(f"[vlm serve] the fp32 routes differ by "
                             f"{row['max_abs_diff']} (tol {VLM_F32_TOL})")
    return row


def phase_vlm_serve() -> dict:
    """internvl2-26b served at published widths and all 48 layers, bf16,
    on [serve]'s requests with the reference server's 256 zero patches
    before each prompt (``[vlm serve]``): graphed and eager with equal
    tokens, each timed run launching the attention kernel and the fused
    norm once a layer a prefill and nothing else; the first batch's
    prefill and decode steps in turns; then the fp32 route check at
    VLM_ROUTE_LAYERS layers.  A main path for both prefill kernels."""
    t_phase = time.perf_counter()
    log(f"[vlm serve] allocated at the start: {_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM_ARCH)
    params = _ssm_params(cfg, "vlm serve")
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    _serve_ssm("vlm serve", cfg, params, reqs,
               {name: cfg.n_layers for name in SERVE_KERNELS})
    # the servers' launches, read before the checks launch their own
    launches = _path_launches("vlm serve", SERVE_KERNELS)
    log(f"[vlm serve] in turns: "
        f"{json.dumps(_ssm_turns('vlm serve', cfg, params, reqs))}")
    del params
    _release()
    f32 = dataclasses.replace(cfg, n_layers=VLM_ROUTE_LAYERS,
                              dtype="float32", param_dtype="float32")
    _vlm_route_check(f32, model_lib.init(f32, 0, device="cuda"))
    _release()
    log(f"[vlm serve] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _encdec_cpu_check(cfg) -> dict:
    """whisper fp32 on the card against the port's CPU forward of the same
    weights, on seeded frames (std 1) and tokens of ENCDEC_CHECK_SHAPE:
    logits, every prefill cache leaf, then ENCDEC_CHECK_STEPS decode steps
    (logits each, the caches after) from the grown cache, all within
    ENCDEC_F32_TOL."""
    f32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    card = model_lib.init(f32, 0, device="cuda")
    host = opt_lib.tree_unflatten([(k, v.cpu()) for k, v in
                                   opt_lib.tree_leaves(card)])
    rng = np.random.default_rng(6)
    b, s = ENCDEC_CHECK_SHAPE
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (b, cfg.n_frames, cfg.d_model)).astype(np.float32))}
    nxt = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1)))
           for _ in range(ENCDEC_CHECK_STEPS)]
    worst: dict = {}

    def run(params, dev):
        out = []
        with torch.no_grad():
            logits, cache = model_lib.forward(
                f32, params, {k: v.to(dev) for k, v in batch.items()},
                return_cache=True)
            out.append(("prefill logits", logits))
            out += [(f"prefill {k}", cache[k]) for k in ("k", "v", "ck",
                                                         "cv")]
            cache = kv_cache.grow_cache(cache, model_lib.init_cache(
                f32, b, s + ENCDEC_CHECK_STEPS, device=dev))
            for i, t in enumerate(nxt):
                logits, cache = model_lib.decode(f32, params, cache, t.to(dev))
                out.append((f"decode {i} logits", logits))
            out += [(f"decoded {k}", cache[k]) for k in ("k", "v")]
        return out

    t0 = time.perf_counter()
    got = run(card, "cuda")
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = run(host, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for (name, g), (_, w) in zip(got, want):
        worst[name] = (g.cpu() - w).abs().max().item()
    row = dict(shape=[b, s], frames=cfg.n_frames, max_abs_diff=worst,
               logits_spread=want[0][1].std().item(), card_wall_ms=card_ms,
               cpu_wall_ms=cpu_ms, tol=ENCDEC_F32_TOL)
    log(f"[encdec serve] fp32 on the card vs the port on the CPU: "
        f"{json.dumps(row)}")
    bad = {k: v for k, v in worst.items() if not v <= ENCDEC_F32_TOL}
    if bad:
        raise AssertionError(f"[encdec serve] card vs CPU past "
                             f"{ENCDEC_F32_TOL}: {bad}")
    return row


def phase_encdec_serve() -> dict:
    """whisper-tiny served at its published size (4 + 4 layers, 1500
    frames), bf16, on [serve]'s requests with the reference server's zero
    frames (``[encdec serve]``): graphed and eager with equal tokens and
    no kernel launch (the family's attention is naive or chunked by
    length, in the reference too); the first batch's prefill and decode
    steps in turns; then fp32 on the card against the CPU."""
    t_phase = time.perf_counter()
    ops.reset_launches()
    log(f"[encdec serve] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(ENCDEC_ARCH)
    params = _ssm_params(cfg, "encdec serve")
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    _serve_ssm("encdec serve", cfg, params, reqs, {})
    launches = dict(ops.LAUNCHES)
    log(f"[encdec serve] in turns: "
        f"{json.dumps(_ssm_turns('encdec serve', cfg, params, reqs))}")
    del params
    _release()
    _encdec_cpu_check(cfg)
    _release()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"[encdec serve] kernel launches on a path "
                             f"that runs none: {dict(ops.LAUNCHES)}")
    log(f"[encdec serve] launches on the path: {json.dumps(launches)}")
    log(f"[encdec serve] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_vlm_train() -> dict:
    """internvl2-26b at published widths cut to VLM_TRAIN_LAYERS layers,
    bf16, full remat (``[vlm train]``): 4 x 1024 positions (256 patches,
    their labels masked, and 768 text tokens) in 2 microbatches, the
    graphed step against the eager one from the same weights on the same
    batches, losses bit for bit; the graph's launches a step are the
    attention and fused-norm kernels, forward twice (remat) and backward
    once a layer a microbatch."""
    t_phase = time.perf_counter()
    ops.reset_launches()
    log(f"[vlm train] allocated at the start: {_release() / 2**30:.2f} GiB")
    cfg = dataclasses.replace(get_config(VLM_ARCH),
                              n_layers=VLM_TRAIN_LAYERS, remat="full")
    stats = _ssm_train_case(cfg, VLM_TRAIN_DATA, "vlm train")
    per = cfg.n_layers * VLM_TRAIN_DATA["num_microbatches"]
    want = dict(flash_attention=2 * per, fused_add_rmsnorm=2 * per,
                flash_attention_bwd=per, fused_add_rmsnorm_bwd=per)
    if stats["capture_launches"] != want:
        raise AssertionError(f"[vlm train] launches a step "
                             f"{stats['capture_launches']}, expected {want}")
    launches = _path_launches("vlm train", TRAIN_KERNELS)
    log(f"[vlm train] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def phase_encdec_train() -> dict:
    """whisper-tiny at its published size, all layers, bf16, full remat
    (``[encdec train]``): 8 x 448 text tokens over 1500 frames in 2
    microbatches, the graphed step against the eager one, losses bit for
    bit; no kernel launches."""
    t_phase = time.perf_counter()
    ops.reset_launches()
    log(f"[encdec train] allocated at the start: "
        f"{_release() / 2**30:.2f} GiB")
    _ssm_train_case(get_config(ENCDEC_ARCH), ENCDEC_TRAIN_DATA,
                    "encdec train")
    launches = dict(ops.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"[encdec train] kernel launches on a path "
                             f"that runs none: {launches}")
    log(f"[encdec train] launches on the path: {json.dumps(launches)}")
    log(f"[encdec train] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


def _fit(cfg, label: str, kw: dict):
    """The ``"H100"`` entry fitted as ``measured.calibrate_cpu_host(cfg,
    **kw)`` fits it, step by step (``catalog_entry``, ``measure_block``,
    ``fit_rate``), so the rows printed are the ones fitted; with each
    point's effective FLOP/s."""
    t0 = time.perf_counter()
    seq = kw["seq_len"]
    base = measured.catalog_entry("cuda")
    rows = measured.measure_block(cfg, seq, BLOCK_MBS, dtype=kw["dtype"],
                                  device="cuda")
    spec = dataclasses.replace(base, peak_flops=measured.fit_rate(
        cfg, seq, rows), efficiency=1.0)
    if spec.name != "H100":
        raise AssertionError(f"[plan] {label}: fitted {spec.name!r}, not the "
                             f"H100 entry")
    fl_tok = 2 * cfg.layer_params()
    points = []
    for mbs, t_f, t_fb in rows:
        fl = fl_tok * mbs * seq
        points.append(dict(mbs=mbs, fwd_ms=t_f * 1e3, fwd_bwd_ms=t_fb * 1e3,
                           fwd_tflops=fl / t_f / 1e12,
                           fwd_bwd_tflops=3 * fl / t_fb / 1e12))
    log(f"[plan] fit {label}: " + json.dumps(dict(
        seq_len=seq, dtype=kw["dtype"], points=points,
        fitted_peak_tflops=spec.peak_flops / 1e12,
        efficiency_vs_datasheet=spec.peak_flops / H100.peak_flops,
        seconds=time.perf_counter() - t0)))
    return spec


def _plan_launch_check(n_fits: int) -> dict:
    """Every measure_block program launched the attention and fused-norm
    kernels (the gradient their backward ones too) once a layer a call;
    every other kernel none."""
    launches = dict(ops.LAUNCHES)
    calls = n_fits * len(BLOCK_MBS) * BLOCK_CALLS
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * calls, fused_add_rmsnorm=2 * calls,
                flash_attention_bwd=calls, fused_add_rmsnorm_bwd=calls)
    if launches != want:
        raise AssertionError(
            f"[plan] launches over the fits {json.dumps(launches)}, "
            f"expected {json.dumps(want)} ({n_fits} fits x "
            f"{len(BLOCK_MBS)} mbs x {BLOCK_CALLS} calls of the forward and "
            f"of the gradient, one layer)")
    log(f"[plan] launches over the fits: {json.dumps(launches)}")
    return launches


def _sim_step(cfg, seq: int, gbs: int, mbs: int, **kw):
    """``simulate`` of the graphed train step's own shape on one H100, on a
    fresh ``JobProfile`` (its prices are cached per profile); ``kw`` goes
    to ``simulate`` (``mem_cfg``)."""
    prof = JobProfile(TrainJob(cfg, seq_len=seq, global_batch=gbs,
                               remat="full"))
    plan = homogeneous_plan("H100", PLAN_ZONE, 1, 1, 1,
                            prof.n_partition_units, mbs, gbs)
    return simulate(prof, plan, single_zone("H100", 1, zone=PLAN_ZONE), **kw)


def _plans(cfg, entry: str) -> dict:
    """``plan_for`` on every fleet, both objectives, under the catalog's
    current ``"H100"`` entry (each call builds its own planner)."""
    out = {}
    for fleet, cluster in PLAN_FLEETS.items():
        for kind in (MAX_THROUGHPUT, MIN_COST):
            res = plan_for(cfg, cluster, Objective(kind),
                           seq_len=TRAIN_DATA["seq_len"],
                           global_batch=PLAN_GLOBAL_BATCH)
            if res.best is None or not res.best.valid:
                raise AssertionError(f"[plan] {entry} {fleet} {kind}: no "
                                     f"valid plan")
            out[(fleet, kind)] = res
    return out


def phase_plan(cfg, train: dict, table_path: str) -> dict:
    """Sailor's planner and simulator priced by the card's measurements:
    the ``"H100"`` entry fitted through the kernels (``calibrate_cpu_host``
    at the train path's bf16 and at the reference's fp32 call), the
    simulated graphed train step against the measured one three ways, and
    the plans on two fleets that hold H100s before and after the fit.
    The datasheet entry and an empty kernel-table registry are restored at
    the end.  Returns the launches over the fits."""
    datasheet = ACCELERATORS["H100"]
    kernel_costs.clear_kernel_tables()
    ops.reset_launches()
    fits = {label: _fit(cfg, label, kw) for label, kw in PLAN_FITS}
    launches = _plan_launch_check(len(fits))
    fit = fits[PLAN_FITS[0][0]]
    log("[plan] fitted rates (TFLOP/s): " + json.dumps(
        {label: spec.peak_flops / 1e12 for label, spec in fits.items()}
        | dict(datasheet_peak=datasheet.peak_flops / 1e12,
               datasheet_effective=datasheet.peak_flops
               * datasheet.efficiency / 1e12)))

    # the simulator against the graphed step, one H100
    seq, gbs = TRAIN_DATA["seq_len"], TRAIN_DATA["global_batch"]
    mbs = gbs // TRAIN_DATA["num_microbatches"]
    table = kernel_costs.KernelCostTable.load(table_path)
    step = train["graphed"]
    sims = {}
    try:
        sims["datasheet"] = _sim_step(cfg, seq, gbs, mbs)
        kernel_costs.register_kernel_table(table)
        sims["datasheet_with_table"] = _sim_step(cfg, seq, gbs, mbs)
        kernel_costs.clear_kernel_tables()
        measured.register_calibrated(fit, "H100")
        sims["fitted"] = _sim_step(cfg, seq, gbs, mbs)
        kernel_costs.register_kernel_table(table)
        sims["fitted_with_table"] = _sim_step(cfg, seq, gbs, mbs)
        kernel_costs.clear_kernel_tables()
        measured.register_calibrated(datasheet, "H100")
        rows = {}
        for name, r in sims.items():
            rows[name] = dict(
                t_iter_ms=r.t_iter * 1e3,
                rel_err_vs_graphed_wall=(r.t_iter * 1e3
                                         - step["step_wall_ms"])
                / step["step_wall_ms"],
                rel_err_vs_graphed_device=(r.t_iter * 1e3
                                           - step["step_device_ms"])
                / step["step_device_ms"],
                t_pp_ms=r.timing.t_pp * 1e3,
                t_update_ms=r.timing.t_update * 1e3)
        log("[plan] simulated vs measured train step (smollm-360M, "
            f"{gbs} x {seq} tokens, mbs {mbs}, full remat, bf16, one H100): "
            + json.dumps(dict(
                measured_graphed_wall_ms=step["step_wall_ms"],
                measured_graphed_device_ms=step["step_device_ms"],
                simulated=rows)))
        peak = sims["datasheet"].peak_mem[0][0]["peak"]
        log("[plan] simulated vs measured peak memory: " + json.dumps(dict(
            simulated_worker_peak_bytes=peak,
            simulated_worker_peak_gib=peak / 2**30,
            train_eager_peak_mem_gib=train["eager"]["peak_mem_gib"],
            train_graphed_peak_mem_gib=step["peak_mem_gib"],
            rel_err_vs_eager=(peak / 2**30 - train["eager"]["peak_mem_gib"])
            / train["eager"]["peak_mem_gib"])))

        # the planner, datasheet entry then fitted entry
        before = _plans(cfg, "datasheet")
        measured.register_calibrated(fit, "H100")
        after = _plans(cfg, "fitted")
        measured.register_calibrated(datasheet, "H100")
        for key, res in before.items():
            new = after[key]
            log(f"[plan] {key[0]} {key[1]}: " + json.dumps(dict(
                datasheet=_plan_row(res), fitted=_plan_row(new),
                plan_changed=res.best.plan != new.best.plan)))

        # one serving plan, the kernel table registered
        kernel_costs.register_kernel_table(table)
        job = ServeJob(cfg, **PLAN_SERVE)
        res = plan_serving(SailorPlanner(job), PLAN_FLEETS["hetero_zone"],
                           ServingObjective(**PLAN_SLO), horizon_s=60.0)
        if res.best is None or not res.best.valid:
            raise AssertionError("[plan] serving: no valid plan")
        b = res.best
        log("[plan] serving plan (smollm-360M, hetero_zone, datasheet H100 "
            "and the kernel table): " + json.dumps(dict(
                job=PLAN_SERVE, slo=PLAN_SLO, describe=b.plan.describe(),
                ttft_p99_s=b.ttft_p99, tpot_p99_s=b.tpot_p99,
                cost_per_token=b.cost_per_token,
                search_time_s=res.search_time_s,
                n_evaluated=res.n_evaluated)))
        kernel_costs.clear_kernel_tables()

        # the memory fit, the baselines beside Sailor under the fitted H100,
        # then the engine fit, which re-registers "H100" (fp32, seq 32):
        # the bf16 fit goes back after it
        _memory_fit(cfg, train)
        measured.register_calibrated(fit, "H100")
        _baselines(cfg, after)
        _engine_fit()
        measured.register_calibrated(fit, "H100")
    finally:
        measured.register_calibrated(datasheet, "H100")
        kernel_costs.clear_kernel_tables()
    return launches


def _memory_fit(cfg, train: dict) -> None:
    """``calibrate_memory`` over the train cell's shape on the untied model
    (graphed train steps at PLAN_MEM_MBS, 2 microbatches; the pipeline's
    two stage programs at the last), each point's raw and fitted relative
    error, and ``simulate``'s worker peak for [train]'s own shape under
    the fitted ``MemoryModelConfig`` and the default one, beside [train]'s
    measured peaks."""
    from repro_torch.core.simulator.memory import combine_peak
    t0 = time.perf_counter()
    seq = TRAIN_DATA["seq_len"]
    cal = measured.calibrate_memory([_pipe_cfg()], seq_len=seq,
                                    mbs_grid=PLAN_MEM_MBS, device="cuda")
    mc = cal.mem_cfg
    points = []
    for r in cal.points:
        fitted = combine_peak(r["static"], r["act"], mc)
        points.append(dict(
            kind=r["kind"], mbs=r["mbs"], stage=r.get("stage"),
            actual_gib=r["actual"] / 2**30, raw_pred_gib=r["raw_pred"] / 2**30,
            fitted_gib=fitted / 2**30,
            raw_rel_err=(r["raw_pred"] - r["actual"]) / r["actual"],
            fitted_rel_err=(fitted - r["actual"]) / r["actual"]))
    log("[plan] memory fit (calibrate_memory, smollm-360M untied, bf16, seq "
        f"{seq}, full remat; the allocator's peak over a graphed program's "
        "capture): " + json.dumps(dict(
            fragmentation=mc.fragmentation,
            act_fragmentation=mc.act_fragmentation,
            runtime_overhead=mc.runtime_overhead,
            base=dict(param_bytes=mc.param_bytes, grad_bytes=mc.grad_bytes,
                      opt_bytes=mc.opt_bytes, act_bytes=mc.act_bytes),
            points=points, seconds=time.perf_counter() - t0)))
    gbs = TRAIN_DATA["global_batch"]
    mbs = gbs // TRAIN_DATA["num_microbatches"]
    rows = {}
    for label, kw in (("default", {}), ("fitted", dict(mem_cfg=mc))):
        peak = _sim_step(cfg, seq, gbs, mbs, **kw).peak_mem[0][0]["peak"]
        rows[label] = dict(
            simulated_worker_peak_gib=peak / 2**30,
            rel_err_vs_eager=(peak / 2**30 - train["eager"]["peak_mem_gib"])
            / train["eager"]["peak_mem_gib"],
            rel_err_vs_graphed=(peak / 2**30
                                - train["graphed"]["peak_mem_gib"])
            / train["graphed"]["peak_mem_gib"])
    log("[plan] simulated vs measured peak memory of [train]'s step, "
        "default and fitted MemoryModelConfig: " + json.dumps(dict(
            rows, train_eager_peak_mem_gib=train["eager"]["peak_mem_gib"],
            train_graphed_peak_mem_gib=train["graphed"]["peak_mem_gib"])))


def _baselines(cfg, sailor: dict) -> None:
    """The paper's comparison with a measured H100: each of the 7 baseline
    planners on the one-zone fleet under the fitted ``"H100"``, its first
    plan valid under Sailor's simulator (``evaluate_ranked``), t_iter and
    $/iteration, beside Sailor's max-throughput plan there."""
    from repro_torch.core.planner.baselines import REGISTRY
    from repro_torch.core.planner.baselines.common import evaluate_ranked
    cluster = PLAN_FLEETS["hetero_zone"]
    job = TrainJob(cfg=cfg, seq_len=TRAIN_DATA["seq_len"],
                   global_batch=PLAN_GLOBAL_BATCH)
    prof = JobProfile(job)
    ours = sailor[("hetero_zone", MAX_THROUGHPUT)].best
    rows = {}
    for name in sorted(REGISTRY):
        kw = {"time_cap_s": PLAN_METIS_CAP_S} if name == "metis" else {}
        res = REGISTRY[name](job, cluster, **kw)
        best, n_oom = evaluate_ranked(res, prof, cluster,
                                      Objective(MAX_THROUGHPUT))
        row = dict(n_plans=len(res.ranked_plans), n_oom=n_oom,
                   search_time_s=res.search_time_s, meta=res.meta)
        if best is not None:
            row.update(describe=best.plan.describe(), t_iter_s=best.t_iter,
                       cost_per_iter=best.cost_per_iter,
                       t_iter_vs_sailor=best.t_iter / ours.t_iter,
                       cost_vs_sailor=best.cost_per_iter
                       / ours.cost_per_iter)
        rows[name] = row
    log("[plan] baselines vs Sailor (smollm-360M, "
        f"{PLAN_GLOBAL_BATCH} x {TRAIN_DATA['seq_len']} tokens, hetero_zone, "
        "fitted H100, max throughput; a baseline with no plan has none "
        "valid here: FlashFlex needs a depth divisible by the fleet's GPU "
        "types): " + json.dumps(dict(
            sailor=dict(describe=ours.plan.describe(), t_iter_s=ours.t_iter,
                        cost_per_iter=ours.cost_per_iter),
            baselines=rows)))


def _engine_fit() -> None:
    """``calibrate_engine`` at the reference's defaults (seq 32, mbs 2,
    n_micro 1, 2, 4, pp up to 2 but the card count: 1) on smollm-360M
    untied in fp32, the dtype its ``calibrate_cpu_host`` rate is fitted
    in: the fitted overheads a and b and each point; then one graphed step
    of the n_micro 2 point profiled (``[profile] engine_step``), which
    says whether the residual the overheads absorb is the host's or the
    card's."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(_pipe_cfg(), dtype="float32",
                              param_dtype="float32")
    cal = measured.calibrate_engine(cfg, seq_len=PLAN_ENGINE_SEQ,
                                    device="cuda")
    e = cal.engine_cfg
    log("[plan] engine fit (calibrate_engine, smollm-360M untied, fp32, "
        f"seq {PLAN_ENGINE_SEQ}, mbs 2, graphed pipeline, host clock): "
        + json.dumps(dict(
            fixed_overhead_s=e.fixed_overhead_s,
            per_task_overhead_s=e.per_task_overhead_s,
            fitted_peak_tflops=cal.accelerator.peak_flops / 1e12,
            points=[dict(r, residual_s=r["t_measured"] - r["t_raw_pred"])
                    for r in cal.points],
            seconds=time.perf_counter() - t0)))
    # where the residual goes: one graphed step of the n_micro 2 point, as
    # measure_pipeline_step builds it, timed by the host clock and profiled
    from repro_torch.dist import pipeline as pl
    pipe = pl.MPMDPipeline(cfg, pl.even_stages(cfg, [1]),
                           opt_lib.OptimizerConfig(lr=1e-3))
    pipe.init_params(0)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, PLAN_ENGINE_SEQ)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    for _ in range(2):               # warm, then capture
        pipe.train_step(batch)
    walls = [_timed_step(lambda: pipe.train_step(batch))[0]
             for _ in range(3)]
    profile_window("engine_step", lambda: pipe.train_step(batch),
                   statistics.median(walls), 1, breakdown=True)


def _plan_row(res) -> dict:
    b = res.best
    return dict(describe=b.plan.describe(), t_iter_s=b.t_iter,
                cost_per_iter=b.cost_per_iter, chips=b.plan.chips_by_type(),
                search_time_s=res.search_time_s)


def main() -> int:
    t_run = time.perf_counter()
    smi = phase_card()
    phase_build()
    cfg = get_config(ARCH)
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    warm = serve_requests(cfg, 1, BATCH)
    rows = phase_kernels(batch_lengths(reqs))
    phase_small_reference()
    phase_reduced()
    serve_launches, serve_dev, params = phase_serve(reqs, warm)
    phase_serve_continuous(params)
    del params
    cal_launches, cal_accuracy = phase_calibrate(serve_dev)
    fused_launches = phase_fused()
    train_launches, train = phase_train()
    pipeline_launches, pipe_mesh_launches = phase_pipeline(train)
    mesh_launches, mesh_replay = phase_mesh(train)
    dryrun_launches, dryrun_chunked_launches, dry = phase_dryrun(mesh_replay)
    phase_audit(dry)
    del dry
    serve_mesh_launches = phase_serve_mesh(smi)
    mesh_families_launches = phase_mesh_families(smi)
    elastic_launches = phase_elastic()
    manager_launches, tel_launches = phase_manager()
    examples_launches = phase_examples()
    autotune_launches = phase_autotune(cal_accuracy)
    moe_serve_launches = phase_moe_serve()
    moe_train_launches = phase_moe_train()
    moe_pipeline_launches = phase_moe_pipeline()
    ssm_serve_launches = phase_ssm_serve()
    hybrid_serve_launches = phase_hybrid_serve()
    ssm_train_launches = phase_ssm_train()
    ssm_mesh_launches = phase_ssm_mesh()
    vlm_serve_launches = phase_vlm_serve()
    encdec_serve_launches = phase_encdec_serve()
    vlm_train_launches = phase_vlm_train()
    encdec_train_launches = phase_encdec_train()
    plan_launches = phase_plan(cfg, train, table_path())
    # launches: each kernel's count on the main path that runs it, which
    # also runs the timed case's shape
    path_of = {"flash_attention": "serve", "fused_add_rmsnorm": "serve",
               "flash_attention_decode": "calibrate", "rmsnorm": "calibrate",
               "ssd_scan": "calibrate", "add": "fused",
               "flash_attention_bwd": "train",
               "fused_add_rmsnorm_bwd": "train"}
    counts = {"serve": serve_launches, "calibrate": cal_launches,
              "fused": fused_launches, "train": train_launches}
    kernels = []
    for name, row in rows.items():
        kernels.append(dict(
            name=name, route="cuda", **SOURCES[name], path=path_of[name],
            launches=counts[path_of[name]][name],
            launches_plan=plan_launches[name],
            launches_pipeline=pipeline_launches[name],
            launches_mesh=mesh_launches.get(name, 0),
            launches_dryrun=dryrun_launches.get(name, 0),
            launches_dryrun_chunked=dryrun_chunked_launches.get(name, 0),
            launches_serve_mesh=serve_mesh_launches.get(name, 0),
            launches_mesh_families=mesh_families_launches.get(name, 0),
            launches_pipeline_mesh=pipe_mesh_launches.get(name, 0),
            launches_elastic=elastic_launches.get(name, 0),
            launches_manager=manager_launches.get(name, 0),
            launches_pipeline_telemetry=tel_launches.get(name, 0),
            launches_examples=examples_launches.get(name, 0),
            launches_autotune=autotune_launches.get(name, 0),
            launches_moe_serve=moe_serve_launches.get(name, 0),
            launches_moe_train=moe_train_launches.get(name, 0),
            launches_moe_pipeline=moe_pipeline_launches.get(name, 0),
            launches_ssm_serve=ssm_serve_launches.get(name, 0),
            launches_hybrid_serve=hybrid_serve_launches.get(name, 0),
            launches_ssm_train=ssm_train_launches.get(name, 0),
            launches_ssm_mesh=ssm_mesh_launches.get(name, 0),
            launches_vlm_serve=vlm_serve_launches.get(name, 0),
            launches_encdec_serve=encdec_serve_launches.get(name, 0),
            launches_vlm_train=vlm_train_launches.get(name, 0),
            launches_encdec_train=encdec_train_launches.get(name, 0),
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"],
            **{key: row[key] for key in ("share_of_bound", "tflops",
                                         "earlier_ms", "calibrate",
                                         "passes_ms", "sequential_plain_ms",
                                         "blocks_ms",
                                         "calibrate_f32", "rows16384",
                                         "more", "plan", "f32", "blocks",
                                         "plan_f32")
               if key in row}))
    print(json.dumps({"kernels": kernels}))
    log(f"[run] wall seconds {time.perf_counter() - t_run:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
