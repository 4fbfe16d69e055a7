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
             mesh, three positions on ``cuda:0``, eager, from the same
             weights: the first step's loss and gradients (gathered whole)
             against ``loss_and_grads`` and the ``[1, 1]`` pipeline's
             first step (phase 8's bounds), the loss falling over 4 steps,
             3 steps timed beside the ``[1, 1]`` pipeline's eager step,
             one profiled (``[profile] pipeline_mesh_step``), the launches
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
             single-device ``loss_and_grads`` (phase 8's bounds); the loss
             falling over 4 steps; 3 eager steps timed (median) beside
             phase 8's eager step; the launches a step (each position the
             attention forward and the fused norm 2 x 32 x 2 times, each
             backward 32 x 2); every replica of a block, of params, ``m``
             and ``v``, equal bit for bit; one step profiled
             (``[profile] mesh_step_*``).  Then an fp32 2-layer model on
             (2, 2) against ``make_train_step`` (1e-4).  Phase 3 holds
             each position's attention and norm shapes (``mesh_*``).
   elastic   ``train/elastic.ElasticTrainer`` (kill-free reshards and
             rollbacks to ``train/checkpoint.CheckpointManager``'s async
             checkpoints) on phase 8's model, data and optimizer (tied,
             full remat), ``devices=[cuda:0] * 4``, the default all-data-
             parallel plan, a checkpoint every 3 steps in a temporary
             directory: ``build(1)``, then 8 steps with a kill-free resize
             to 4 positions at step 3 and a failure down to 2 at step 7
             (rollback to step 6): the state after the reshard and after
             the restore equal, gathered whole, to the state before and to
             the saved one, bit for bit; 9 log rows; step 6's replay
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
             monitor, incremental replanner on smollm-360M at seq 1024 on
             H100s, transition model, ``hysteresis_s`` 120) over the
             elastic phase's trainer on ``[cuda:0] * 4``, a step every 60
             feed seconds, 11 steps, a checkpoint every 3: 4 H100s, 3 at
             t = 120, 4 at 240, 2 at 480 (a bulk preemption), 4 at 540 and
             2 at 600 (a blip).  The decisions (without straggler rows)
             must be the reference controller's on this feed
             (``MANAGER_OUTCOMES``, pinned on the CPU by
             ``tests/test_torch_manager.py``), the reconfigurations follow
             them, the rollback resumes at the last checkpoint's step,
             every loss is finite, one ``step_time`` a step on the sim
             clock, the audit file equals the decision log, and every
             runtime plan is one of phase 3's ``elastic_*`` shapes.
             Prints each decision (event, action, reason, search ms,
             cache), each priced transition beside the measured
             ``reconfig_s`` (a rollback's priced restore, setup and lost
             work beside its measured replay), ``_state_bytes()`` beside
             the checkpoint's bytes, and the step wall at each position
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
elastic, manager's two paths, autotune and the three MoE phases too) is
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

import ctypes
import dataclasses
import gc
import json
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
from repro_torch.serve import serve_step  # noqa: E402
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
MESH_LEARN = 4          # steps on one repeated batch: the loss must fall
MESH_TIMED = 3          # eager steps timed (median) beside [train]'s
MESH_SMALL_STEPS = 3    # fp32 2 layers on (2, 2) against make_train_step
# pipeline phase, mesh stages: even_stages(cfg, [2, 1]), stage 0 on a
# (1, 2) fsdp_tp mesh, three positions all on cuda:0, eager; fp32 2-layer
# checks on [2, 1] and on [1, 1] at dp 2
PIPE_MESH_TPS, PIPE_MESH_POLICY = (2, 1), "fsdp_tp"
PIPE_MESH_TIMED = 3     # eager steps timed (median), then the [1, 1]'s
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
# manager phase (a): Sailor's controller over [elastic]'s trainer on
# [cuda:0] * 4, a step every MANAGER_STEP_S feed seconds; the feed's
# (time_s, H100s available): a graceful drop to 3 (runs on 2), the 4 back
# (clears the hysteresis at t = 360), a bulk preemption to 2, and a blip
# to 4 that reverts before the hysteresis ends.  The outcomes and
# reconfigurations are the reference Controller's on this feed
# (tests/test_torch_manager.py pins them on a stub trainer).
MANAGER_START, MANAGER_STEPS, MANAGER_EVERY = 4, 11, 3
MANAGER_STEP_S, MANAGER_HYSTERESIS_S = 60.0, 120.0
MANAGER_FEED = ((120.0, 3), (240.0, 4), (480.0, 2), (540.0, 4), (600.0, 2))
MANAGER_OUTCOMES = ("start", "reshard", "defer", "reshard", "rollback",
                    "defer", "defer")
MANAGER_RECONFIGS = (("kill-free", 2), ("kill-free", 4), ("rollback", 2))
# manager phase (b): [pipeline]'s graphed [1, 1] pipeline, pairs of steps
# detached and attached (no fault) in turns; then the bus with the
# detectors and RCA, a compute delay on stage 1 from step 14 (after the
# detectors' warm-up of 12), 20 steps
TEL_STEPS, TEL_FAULT_STEP, TEL_FAULT_FACTOR = 20, 14, 2.0
TEL_DETECT_WITHIN = 4       # steps from the fault to its Straggler
TEL_PAIRS = 4


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
    serve_row = attn[0]
    serve_row["earlier_ms"] = attn[1]["ms"]
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
    operators count too).  ``busy`` is that device time over ``wall_ms``,
    the same work's wall time measured without the profiler.
    ``breakdown`` also prints the "elementwise/other" group by kernel
    name: the 10 largest, ms and launches a step (or call).  Returns the
    device ms, or None when the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def _decode_in_turns(cfg, params, graph, state, rows, plen):
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
    need = plen + 2 + DECODE_PAIRS + DECODE_PROFILED
    size = state["k"].shape[2]
    if need > size:
        raise ValueError(f"[serve] decode in turns: a {plen}-token prefill "
                         f"and {need - plen} steps write past the cache's "
                         f"{size} slots")
    steps = {"graphed": lambda: graph(params, state, rows)}
    for _ in range(2):
        steps["graphed"]()
    other = {k: v.clone() for k, v in state.items()}
    steps["eager"] = lambda: serve_step.decode_on_device(
        cfg, params, serve_step.rows_of(other, rows))
    times = _in_turns(steps, DECODE_PAIRS)
    for key in ("k", "v", "len", "cur"):
        a, b = serve_step.rows_of(state, rows)[key], \
            serve_step.rows_of(other, rows)[key]
        if not torch.equal(a, b):
            raise AssertionError(f"[serve] decode in turns: graphed and "
                                 f"eager {key} differ after {DECODE_PAIRS} "
                                 f"steps each")

    def run(kind, n):
        for _ in range(n):
            steps[kind]()
    out = {f"{kind}_ms": statistics.median(t) for kind, t in times.items()}
    log("[serve] decode in turns (" + f"{DECODE_PAIRS} pairs, batch {rows}, "
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
    a (1, 2) ``fsdp_tp`` mesh, every position on the one card, eager.  The
    first step's loss and gradients (gathered whole) against the
    single-device ``loss_and_grads`` (phase 8's bounds) and against the
    ``[1, 1]`` pipeline's first step on the same weights; the loss falling
    over PIPE_LEARN steps; PIPE_MESH_TIMED steps timed beside the ``[1,
    1]`` pipeline's eager step; one profiled; the launches a step (each
    position the attention forward 3 x its layers x microbatches, its
    backward layers x microbatches, no fused norm); the resident bytes a
    position.  Returns the launches over the mesh pipeline's steps."""
    mesh = _pipe(pl, cfg, ocfg, full, None, PIPE_MESH_TPS)
    label = f"{list(PIPE_MESH_TPS)} {PIPE_MESH_POLICY}"
    if mesh.graphs[0] is not None or mesh.graphs[1] is None:
        raise AssertionError(f"[pipeline] {label}: the mesh stage must run "
                             f"eagerly, the one-device stage graphed")
    log(f"[pipeline] {label} memory: "
        + json.dumps(_pipe_position_bytes(mesh)))
    ops.reset_launches()
    gl, grads = mesh.grad_step(batches[0])
    first = [{k: t.clone() for k, t in _stage_leaves(g)} for g in grads]
    mesh.apply_grads(grads)
    learn = [mesh.train_step(batches[PIPE_STEPS])
             for _ in range(PIPE_LEARN)]
    if not all(np.isfinite(learn)) or not learn[-1] < learn[0]:
        raise AssertionError(f"[pipeline] {label}: losses {learn}: not "
                             f"finite, or the last is not below the first")
    rows = []
    for i in range(PIPE_MESH_TIMED):
        wall, dev, extra, loss = _timed_step(
            lambda: mesh.train_step(batches[PIPE_STEPS + 1 + i]))
        rows.append((wall, dev, extra, loss))
    wall = statistics.median(r[0] for r in rows)
    dev_ms = profile_window("pipeline_mesh_step",
                            lambda: mesh.train_step(batches[-1]), wall, 1)
    n_steps = 1 + PIPE_LEARN + PIPE_MESH_TIMED + 1
    launches = dict(ops.LAUNCHES)
    want = {name: 0 for name in launches}
    for st in mesh.stages:
        n = st.n_layers * dc.num_microbatches * st.n_devices
        want["flash_attention"] += 3 * n
        want["flash_attention_bwd"] += n
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(
            f"[pipeline] {label}: launches {json.dumps(launches)} in "
            f"{n_steps} steps, expected {json.dumps(want)} a step")
    del mesh
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
        timed_losses=[r[3] for r in rows], step_wall_ms=wall,
        step_wall_ms_all=[r[0] for r in rows],
        step_device_ms=statistics.median(r[1] for r in rows),
        working_set_gib=max(r[2] for r in rows) / 2**30,
        tokens_per_s=tokens / (wall / 1e3),
        one_device_eager_step_wall_ms=one_eager,
        one_device_eager_step_device_ms=statistics.median(
            r[1] for r in one_rows),
        ratio_to_one_device_eager=wall / one_eager,
        one_device_graphed_step_wall_ms=one_wall,
        launches_per_step={k: v // n_steps for k, v in launches.items()
                           if v})
    if dev_ms is not None:
        stats.update(profiled_device_ms=dev_ms, busy=dev_ms / wall)
    log(f"[pipeline] {label} (smollm-360M untied, stages of "
        f"{[s.n_layers for s in stages]} layers on one card, eager): "
        + json.dumps(stats))
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


def _mesh_memory(cfg, mesh, params, state) -> dict:
    """Each position's elements and resident bytes (its params, ``m`` and
    ``v`` blocks) beside the simulator's ``params / tp`` for the same
    (dp, tp) (``core/simulator/memory.py``: ``M_model = params / tp *
    mul_factor``, the fp32 gradient included)."""
    from repro_torch.core.simulator.memory import DEFAULT_MEM
    from repro_torch.dist import placement as pm
    tp = mesh.shape["model"]
    prof = JobProfile(TrainJob(cfg, seq_len=TRAIN_DATA["seq_len"],
                               global_batch=TRAIN_DATA["global_batch"]))
    total = prof.stage_params(0, len(prof.layer_kinds()))
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


def _mesh_case(policy, shape, full, batches, train) -> dict:
    """One mesh at full width: the first step against the single device,
    the loss falling, replicas bit for bit, the launches, the eager step
    timed beside [train]'s and profiled, each position's memory.  Returns
    the launches over the mesh's steps."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    cfg = dataclasses.replace(get_config(ARCH), remat="full",
                              sharding=policy)
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
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
    step = train_lib.jit_train_step(cfg, ocfg, mesh, dc.num_microbatches,
                                    dc.micro_batch)
    ops.reset_launches()
    learn = []
    for _ in range(MESH_LEARN):
        params, state, m = step(params, state, batches[0])
        learn.append(m["loss"].item())
    if not all(np.isfinite(learn)) or not learn[-1] < learn[0]:
        raise AssertionError(f"[mesh] {label}: losses {learn}: not finite, "
                             f"or the last is not below the first")
    rows = []
    for i in range(MESH_TIMED):
        wall, dev, extra, (params, state, m) = _timed_step(
            lambda: step(params, state, batches[1 + i]))
        rows.append((wall, dev, extra, m["loss"].item()))
    launches = _mesh_launch_check(label, cfg, dc, mesh,
                                  MESH_LEARN + MESH_TIMED)
    same = _mesh_replicas_equal(params, state["m"], state["v"])
    if not same:
        raise AssertionError(f"[mesh] {label}: replicas of a block differ "
                             f"after {MESH_LEARN + MESH_TIMED} steps")
    wall = statistics.median(r[0] for r in rows)
    train_wall = train["eager"]["step_wall_ms"]
    tokens = dc.global_batch * dc.seq_len
    stats = dict(
        mesh=dict(mesh.shape), policy=policy, losses_learn=learn,
        timed_losses=[r[3] for r in rows], step_wall_ms=wall,
        step_wall_ms_all=[r[0] for r in rows],
        step_device_ms=statistics.median(r[1] for r in rows),
        working_set_gib=max(r[2] for r in rows) / 2**30,
        tokens_per_s=tokens / (wall / 1e3),
        train_eager_step_wall_ms=train_wall,
        ratio_to_train_eager=wall / train_wall,
        launches_per_step={k: v // (MESH_LEARN + MESH_TIMED)
                           for k, v in launches.items() if v},
        replicas_bit_identical=same)
    log(f"[mesh] {label}: " + json.dumps(stats))
    dev_ms = profile_window(f"mesh_step_{shape[0]}x{shape[1]}",
                            lambda: step(params, state, batches[-1]), wall, 1)
    if dev_ms is not None:
        log(f"[mesh] {label}: device ms of an eager step {dev_ms:.3f}, busy "
            f"{dev_ms / wall:.3f}")
    return launches


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
    and (1, 5) ``tp`` (3/1 heads, d_ff 512 a position, vocab replicated);
    then an fp32 2-layer model on (2, 2) against ``make_train_step``.  A
    main path for the attention and fused-norm kernels, forward and
    backward.  Returns the launches over the bf16 meshes' steps."""
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(500 + i) for i in range(MESH_TIMED + 2)]
    full = model_lib.init(cfg, 0, device="cuda")     # [train]'s weights
    total: dict = {}
    for policy, shape in MESH_CASES:
        _add_counts(total, _mesh_case(policy, shape, full, batches, train))
        torch.cuda.empty_cache()
    del full
    log("[mesh] fp32 2 layers on (2, 2) fsdp_tp vs make_train_step: "
        + json.dumps(_mesh_small_check()))
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
        if (kinds != ["kill-free", "rollback"] or back != 6
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
            reconfigs=tr.reconfigs, checks=checks, losses=losses,
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


def _manager_controller() -> dict:
    """(a) Sailor's control loop (``manager.Controller``: the availability
    monitor, the incremental replanner, the transition model) driving
    [elastic]'s trainer on [cuda:0] * MANAGER_START through MANAGER_FEED:
    the decisions must be the reference controller's on this feed
    (MANAGER_OUTCOMES, MANAGER_RECONFIGS), the rollback must resume at
    the last checkpoint's step, every loss finite, a ``step_time`` sample
    a step on the controller's sim clock, the audit file equal to the
    decision log.  Prints each decision, each priced transition beside
    the trainer's measured ``reconfig_s``, ``_state_bytes()`` beside the
    checkpoint's bytes and the step wall at each position count."""
    import shutil
    import tempfile
    from repro_torch.manager import (AvailabilityMonitor, Controller,
                                     ControllerConfig, IncrementalReplanner,
                                     ListFeed, TransitionConfig,
                                     TransitionModel)
    from repro_torch.telemetry import TelemetryBus, read_jsonl
    from repro_torch.train.elastic import ElasticTrainer
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ocfg = opt_lib.OptimizerConfig(**TRAIN_OPT)
    workdir = tempfile.mkdtemp(prefix="manager-")
    audit = os.path.join(workdir, "audit.jsonl")
    ops.reset_launches()
    try:
        tr = ElasticTrainer(cfg, ocfg, dc, os.path.join(workdir, "ckpt"),
                            checkpoint_every=MANAGER_EVERY,
                            devices=[torch.device("cuda", 0)] * MANAGER_START)
        tr.ckpt.keep = 1        # the latest is all a rollback reads
        job = TrainJob(cfg=get_config(ARCH), seq_len=TRAIN_DATA["seq_len"],
                       global_batch=TRAIN_DATA["global_batch"])
        feed = ListFeed([(t, single_zone("H100", n))
                         for t, n in MANAGER_FEED])
        ctl = Controller(
            tr, AvailabilityMonitor(single_zone("H100", MANAGER_START),
                                    [feed]),
            IncrementalReplanner(job, Objective(MAX_THROUGHPUT)),
            transition=TransitionModel(TransitionConfig(
                hysteresis_s=MANAGER_HYSTERESIS_S)),
            config=ControllerConfig(step_time_s=MANAGER_STEP_S,
                                    max_devices=MANAGER_START,
                                    audit_path=audit))
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
        rows = ctl.run(MANAGER_STEPS)
        ckpt_step = tr.ckpt.latest_step()
        ckpt_bytes = os.path.getsize(os.path.join(
            workdir, "ckpt", f"step-{ckpt_step}", "state.npz"))
        records = read_jsonl(audit)
        decisions = [d for d in ctl.decisions if not d.get("straggler")]
        outcomes = [d["action"] for d in decisions]
        reconfigs = [(r["kind"], r["n_devices"]) for r in tr.reconfigs]
        losses = [r["loss"] for r in rows]
        times = [s.time_s for s in bus.series("step_time", ())]
        rollback = [r for r in tr.reconfigs if r["kind"] == "rollback"]
        audit_ok = [{k: v for k, v in r.items()
                     if k not in ("kind", "wall_time_s")} for r in records] \
            == json.loads(json.dumps(ctl.decisions))
        if (outcomes != list(MANAGER_OUTCOMES)
                or reconfigs != list(MANAGER_RECONFIGS)
                or not rollback or rollback[-1]["resumed_at"]
                != rollback[-1]["step"] // MANAGER_EVERY * MANAGER_EVERY
                or not all(np.isfinite(losses))
                or len(times) != len(rows) or max(times) > ctl.sim_time
                or not audit_ok
                or any(p.tp != 1 or p.dp not in ELASTIC_DEVICES
                       for p in plans)):
            raise AssertionError(
                f"[manager] outcomes {outcomes} (want "
                f"{list(MANAGER_OUTCOMES)}), reconfigs {tr.reconfigs}, "
                f"losses {losses}, step_time at {times} (sim clock "
                f"{ctl.sim_time}), audit equal {audit_ok}, plans {plans} "
                f"(phase 3 holds dp {ELASTIC_DEVICES} at tp 1)\n"
                + ctl.summary())
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
        for p, r in zip(commits, tr.reconfigs):
            row = dict(kind=r["kind"], at_step=r["step"],
                       resumed_at=r["resumed_at"], n_devices=r["n_devices"],
                       priced_s=p["cost_s"],
                       reshard_cost_s=p["details"]["reshard_cost_s"],
                       measured_reconfig_s=r["reconfig_s"])
            if r["kind"] == "rollback":
                lost = p["details"]["lost_steps"]
                start = max(i for i, x in enumerate(rows)
                            if x["step"] == r["resumed_at"])
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
            state_bytes_priced=ctl._state_bytes(),
            checkpoint_bytes=ckpt_bytes, checkpoint_step=ckpt_step,
            ratio=ckpt_bytes / ctl._state_bytes(),
            step_wall_ms_by_positions={
                n: dict(median=statistics.median(w), all=w)
                for n, w in walls.items()},
            losses=losses, steps=[r["step"] for r in rows],
            plans=[dataclasses.asdict(p) for p in plans],
            replanner=ctl.replanner.stats,
            step_time_at=times, sim_time=ctl.sim_time,
            audit_records=len(records))))
        launches = _elastic_launch_check("[manager]", cfg, dc, rows)
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


# --- [autotune] and the MoE family ------------------------------------------------

def _release() -> int:
    """Free what dropped references held: a graphed server or pipeline
    sits in reference cycles (its graphs and their pools with it) until
    the collector runs, and a model of the MoE phases needs the card's
    memory back.  Returns the bytes still allocated."""
    gc.collect()
    torch.cuda.synchronize()
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
    mesh_launches = phase_mesh(train)
    elastic_launches = phase_elastic()
    manager_launches, tel_launches = phase_manager()
    autotune_launches = phase_autotune(cal_accuracy)
    moe_serve_launches = phase_moe_serve()
    moe_train_launches = phase_moe_train()
    moe_pipeline_launches = phase_moe_pipeline()
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
            launches_pipeline_mesh=pipe_mesh_launches.get(name, 0),
            launches_elastic=elastic_launches.get(name, 0),
            launches_manager=manager_launches.get(name, 0),
            launches_pipeline_telemetry=tel_launches.get(name, 0),
            launches_autotune=autotune_launches.get(name, 0),
            launches_moe_serve=moe_serve_launches.get(name, 0),
            launches_moe_train=moe_train_launches.get(name, 0),
            launches_moe_pipeline=moe_pipeline_launches.get(name, 0),
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
