"""Measured profiling and calibration on the card (paper §4.1): the
block-time fit and the kernel leg of ``repro/core/profiler/measured.py``.

``measure_block`` times the forward and the gradient of ONE decoder block
of a config (the repeated layers reduced to one instance, the paper's
trick) for a grid of microbatch sizes, and ``calibrate_cpu_host`` fits an
accelerator's effective FLOP/s to those times with the reference's
arithmetic: on the CPU the ``cpu-host`` entry, as in the reference, and
on the H100 SXM the ``"H100"`` entry (another card, an H100 PCIe or NVL
too, has no entry and is refused).  On the card each program runs as a CUDA
graph (the counterpart of the reference's ``jax.jit``), and its replays
are timed on the device's clock: the fit prices the card's kernels, not
the host that launches them.

``calibrate_kernels`` times the port's kernels into a per-(op, shape,
dtype, chip) :class:`kernel_costs.KernelCostTable`, which
``analytic.JobProfile.cost`` and ``.decode_cost`` then consult before the
roofline.

``calibrate_engine`` fits the event engine's overheads (``a + b ops``)
to the wall-clock of the port's ``MPMDPipeline`` steps, and
``calibrate_memory`` the memory model's fragmentation and overhead to the
card allocator's peak over the graphed train step and the pipeline's
stage programs (where the reference reads XLA's ``memory_analysis``).

Each runs on ``cuda`` unless the caller passes ``device="cpu"`` (where
the kernel wrappers take their plain versions), and raises without a
card; ``calibrate_memory`` raises on the CPU, which has no allocator
peak.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.hw_specs import (ACCELERATORS, AcceleratorSpec,
                                                get_accelerator)
from repro_torch.device import (DeviceArg, device_of, resolve_device,
                                torch_dtype)
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops as kops
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib


def _time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Mean host seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` (the reference's timer; on the CPU a call has finished its
    work when it returns)."""
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def _replay_time(replay: Callable[[], Any], warmup: int = 1,
                 iters: int = 3) -> float:
    """``_time_fn`` of a CUDA graph's replay on the device's clock: mean
    seconds of ``iters`` back-to-back replays after ``warmup``, from a pair
    of CUDA events around them."""
    for _ in range(warmup):
        replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def one_layer(cfg: ModelConfig, dtype: str = "float32") -> ModelConfig:
    """The reference's one-layer model of ``cfg`` (``n_layers=1``,
    ``vocab_size`` at most 1024, ``remat="none"``), params and activations
    in ``dtype`` (the reference's is always float32)."""
    return dataclasses.replace(cfg, n_layers=1,
                               vocab_size=min(cfg.vocab_size, 1024),
                               remat="none", dtype=dtype, param_dtype=dtype)


def block_batch(one: ModelConfig, mbs: int, seq_len: int,
                device: DeviceArg = None) -> Dict[str, torch.Tensor]:
    """``measure_block``'s batch, the reference's: all-zero tokens and
    labels, and the stubbed frontends' zero ``frames`` (encdec) or
    ``patches`` (vlm, ``model.stub_inputs``).  A vlm's labels also cover
    its ``n_patches`` patch positions, as ``IGNORE_LABEL`` (the train
    data's layout): the reference's labels cover the text alone, so its
    loss cannot broadcast them against the logits and its
    ``measure_block`` raises on the family (ROADMAP §3, fault R10)."""
    dev = resolve_device(device)
    out = {k: torch.zeros((mbs, seq_len), dtype=torch.int32, device=dev)
           for k in ("tokens", "labels")}
    out.update(model_lib.stub_inputs(one, mbs, dev))
    if one.family == "vlm":
        ign = torch.full((mbs, one.n_patches), model_lib.IGNORE_LABEL,
                         dtype=torch.int32, device=dev)
        out["labels"] = torch.cat([ign, out["labels"]], dim=1)
    return out


def block_programs(one: ModelConfig, params, batch
                   ) -> Tuple[Callable[[], Any], Callable[[], Any]]:
    """The two programs ``measure_block`` times on ``batch``: the
    forward's logits, and the gradient of ``loss_fn``'s loss (the
    reference's ``jax.grad``) as a tuple of leaves in
    ``graphs.tree_leaves(params)`` order.  Neither syncs with the host, so
    both can be captured as CUDA graphs."""
    paths = [k for k, _ in graphs.tree_leaves(params)]

    def fwd():
        with torch.no_grad():
            return model_lib.forward(one, params, batch)

    def grad():
        # detached leaves sharing the params' storage, as the train step's
        leaves = [p.detach().requires_grad_()
                  for _, p in graphs.tree_leaves(params)]
        tree = opt_lib.tree_unflatten(zip(paths, leaves))
        loss = model_lib.loss_fn(one, tree, batch)[0]
        return torch.autograd.grad(loss, leaves)

    return fwd, grad


def graphed_program(fn: Callable[[], Any], params) -> Callable[[], Any]:
    """``fn`` as one CUDA graph, the counterpart of the reference's
    ``jax.jit``: run once eagerly on a side stream (every kernel it
    launches loads, and the stream's ticket counters, the fused norm's and
    the fp32 attention backward's, exist before the capture), captured on
    that stream, and returned as its
    replay, which returns the graph's output tensors (the next replay
    overwrites them) and adds the capture's launches to ``ops.LAUNCHES``
    (``graphs.Captured``)."""
    step = graphs.GraphedStep(params, "measure_block")
    fused_mod.ticket_counters(step.device, step.stream)
    fa.bwd_ticket_counters(step.device, step.stream)
    step.eager(fn)
    return step.capture(fn).replay


def measure_block(cfg: ModelConfig, seq_len: int, mbs_grid=(1, 2, 4), *,
                  dtype: str = "float32", device: DeviceArg = None
                  ) -> List[Tuple[int, float, float]]:
    """Measure (mbs, fwd_s, fwd+bwd_s) for ONE decoder block of ``cfg``.

    The reference's one-layer model (``n_layers=1``, ``vocab_size`` at
    most 1024, ``remat="none"``), its params and activations in ``dtype``
    (the reference's is always float32; the H100's catalog rate is the
    bf16 tensor cores', so a bf16 plan is fitted in bf16; ``one_layer``),
    weights from ``model.init(one, seed=0)``, on the reference's all-zero
    batch (``block_batch``).  On a CUDA device each program is a CUDA
    graph and its replays are timed with CUDA events
    (``graphed_program``, ``_replay_time``); on the CPU it runs eagerly
    under the host clock (``_time_fn``)."""
    dev = resolve_device(device)
    one = one_layer(cfg, dtype)
    params = model_lib.init(one, 0, device=dev)
    out = []
    for mbs in mbs_grid:
        fwd, both = block_programs(one, params,
                                   block_batch(one, mbs, seq_len, dev))
        if dev.type == "cuda":
            t_f = _replay_time(graphed_program(fwd, params))
            t_fb = _replay_time(graphed_program(both, params))
        else:
            t_f = _time_fn(fwd)
            t_fb = _time_fn(both)
        out.append((mbs, t_f, t_fb))
    return out


def catalog_entry(device: DeviceArg = None) -> AcceleratorSpec:
    """The catalog entry ``calibrate_cpu_host`` fits for the device,
    ``ACCELERATORS[autotune.default_chip(device)]``: ``"cpu-host"`` on
    the CPU, ``"H100"`` on the H100 SXM (``autotune.H100_SXM_NAME``, the
    card the entry's data sheet describes); another card, an H100 PCIe or
    NVL too, has none, and raises."""
    chip = at.default_chip(resolve_device(device))
    if chip not in ACCELERATORS:
        raise ValueError(f"calibrate_cpu_host: the catalog holds no entry "
                         f"for {chip!r} to fit; its entries are "
                         f"{sorted(ACCELERATORS)}")
    return ACCELERATORS[chip]


def fit_rate(cfg: ModelConfig, seq_len: int,
             rows: List[Tuple[int, float, float]]) -> float:
    """The effective FLOP/s of ``measure_block``'s rows, the reference's
    arithmetic: the median of ``fl / t_f`` and ``3 fl / t_fb`` over the
    grid, ``fl = 2 layer_params mbs seq_len``."""
    flops_per_tok = 2 * cfg.layer_params()
    effs = []
    for mbs, t_f, t_fb in rows:
        fl = flops_per_tok * mbs * seq_len
        effs.append(fl / max(t_f, 1e-9))
        effs.append(3 * fl / max(t_fb, 1e-9))
    return float(np.median(effs))


def calibrate_cpu_host(cfg: ModelConfig, seq_len: int = 128, *,
                       dtype: str = "float32",
                       device: DeviceArg = None) -> AcceleratorSpec:
    """Fit the effective FLOP/s of the device ``measure_block`` runs on
    (``fit_rate``) into its catalog entry (``catalog_entry``, looked up
    before anything is measured).  Returns the entry with ``peak_flops``
    the fit and ``efficiency`` 1.0; registering it
    (``register_calibrated(spec, name)``) is the caller's."""
    dev = resolve_device(device)
    base = catalog_entry(dev)
    rows = measure_block(cfg, seq_len, dtype=dtype, device=dev)
    return dataclasses.replace(base, peak_flops=fit_rate(cfg, seq_len, rows),
                               efficiency=1.0)


def register_calibrated(spec: AcceleratorSpec, name: str = "cpu-host") -> None:
    ACCELERATORS[name] = dataclasses.replace(spec, name=name)


# --- event-engine calibration (paper §4.1 + §4.3) -----------------------------

@dataclasses.dataclass
class EngineCalibration:
    """Calibrated accelerator profile + engine overhead coefficients.

    ``engine_cfg`` carries the fitted ``fixed_overhead_s`` (per-iteration
    dispatch cost) and ``per_task_overhead_s`` (per stage program
    call / per transfer), fitted against real ``MPMDPipeline`` wall-clock.
    """

    accelerator: AcceleratorSpec
    engine_cfg: "EngineConfig"
    points: List[Dict]              # measured grid: pp/mbs/n_micro/t rows


def _pipeline_ops(pp: int, n_micro: int) -> int:
    """Dispatched programs per MPMDPipeline.train_step: fwd+bwd per stage
    per microbatch, two transfers per boundary per microbatch, one update
    per stage."""
    return n_micro * pp * 2 + 2 * (pp - 1) * n_micro + pp


def measure_pipeline_step(cfg: ModelConfig, pp: int, n_micro: int, mbs: int,
                          seq_len: int, iters: int = 3, *,
                          device: DeviceArg = None) -> float:
    """Wall-clock seconds of one ``MPMDPipeline`` train step (params from
    ``init_params(0)``, the reference's seeded uniform tokens).

    On a CUDA device the pipeline is graphed, stage i on ``cuda:i``, and
    each step is timed by the host clock up to ``torch.cuda.synchronize()``
    on every stage's device, after a warm step and the capturing one; on
    the CPU the eager pipeline, its stages on the CPU in turn, after one
    warm step (the reference's ``_time_fn``)."""
    from repro_torch.dist.pipeline import MPMDPipeline, even_stages

    dev = resolve_device(device)
    pipe = MPMDPipeline(cfg, even_stages(cfg, tps=[1] * pp, dp=1),
                        opt_lib.OptimizerConfig(lr=1e-3),
                        devices=None if dev.type == "cuda" else [dev] * pp)
    pipe.init_params(0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size,
                        (n_micro, mbs, seq_len)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if dev.type != "cuda":
        return _time_fn(pipe.train_step, batch, iters=iters)

    def step():
        pipe.train_step(batch)
        for d in set(pipe.devices):
            torch.cuda.synchronize(d)

    return _time_fn(step, warmup=2, iters=iters)


# --- memory calibration (paper §4.3 / Fig. 3) ---------------------------------

@dataclasses.dataclass
class MemoryCalibration:
    """Fitted memory-model coefficients + the measured grid behind them.

    ``mem_cfg`` carries the fitted ``fragmentation`` (allocator
    multiplier) and ``runtime_overhead`` (fixed bytes) on top of a base
    config matching the measured runtime's dtypes.  ``points`` rows hold
    the per-program raw prediction vs the allocator's peak.
    """

    mem_cfg: "MemoryModelConfig"
    points: List[Dict]


def program_peak_bytes(run: Callable[[], Any], base: int,
                       device: DeviceArg) -> int:
    """The card allocator's peak for one program, the counterpart of the
    reference's ``xla_peak_bytes`` (arguments + outputs + temporaries −
    aliases; the in-place update stands for donation): ``run()`` once
    (warm), ``torch.cuda.reset_peak_memory_stats``, ``run()`` once more,
    and ``max_memory_allocated`` minus ``base``, what was allocated before
    the program's params, optimizer state and inputs were made.  For a
    graphed program the second run is its capture, whose allocations are
    the graph's working set (a replay allocates nothing).  The CPU has no
    allocator peak: it raises ``ValueError``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"program_peak_bytes: the memory truth is the CUDA "
                         f"allocator's peak; {dev} has none")
    run()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev) - base)


def _host_mem_base(cfg: ModelConfig) -> "MemoryModelConfig":
    """Memory config matching the dtypes the measured runtime stores, with
    the calibratable coefficients zeroed so the kernel returns the *raw*
    structural bytes: params in ``cfg.param_dtype``, gradients summed in
    fp32 (the train step's and the pipeline's buffers), AdamW's ``m`` and
    ``v`` in fp32, activations in ``cfg.dtype``.  The reference's base is
    all fp32 because its host runtime is; for an fp32 config the two are
    equal, and for a bf16 one the port's stores 2-byte params and
    activations (a divergence, ``ROADMAP.md`` §3)."""
    from repro_torch.core.simulator.memory import MemoryModelConfig
    return MemoryModelConfig(param_bytes=torch_dtype(cfg.param_dtype).itemsize,
                             grad_bytes=4, opt_bytes=8,
                             act_bytes=torch_dtype(cfg.dtype).itemsize,
                             fragmentation=1.0, act_fragmentation=1.0,
                             runtime_overhead=0.0, dp_bucket_frac=0.0)


def _release(dev: torch.device) -> int:
    """Free what earlier points left and return the bytes still
    allocated: the next point's base."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def _train_peak(cfg: ModelConfig, seq_len: int, mbs: int, n_micro: int,
                device: DeviceArg) -> int:
    """``program_peak_bytes`` of the graphed train step
    (``make_graphed_train_step``) on an all-zero (n_micro, mbs, seq) batch."""
    from repro_torch.train.train_step import make_graphed_train_step

    dev = resolve_device(device)
    base = _release(dev)
    params = model_lib.init(cfg, 0, device=dev)
    state = opt_lib.init_state(params)
    batch = {k: torch.zeros((n_micro, mbs, seq_len), dtype=torch.int32,
                            device=dev) for k in ("tokens", "labels")}
    step = make_graphed_train_step(cfg, opt_lib.OptimizerConfig(lr=1e-3),
                                   params, state, batch)
    return program_peak_bytes(lambda: step(params, state, batch), base, dev)


def _stage_peak(cfg: ModelConfig, stage, seq_len: int, mbs: int,
                device: DeviceArg) -> int:
    """``program_peak_bytes`` of one pipeline stage's step for one
    microbatch, as ``MPMDPipeline`` runs it, graphed: the stage backward
    (recomputing the forward), its gradients into the stage's fp32
    buffers, and the in-place update, on all-zero inputs."""
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist.sharding import init_from_decls

    dev = resolve_device(device)
    base = _release(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_from_decls(pl.stage_decls(cfg, stage), gen, cfg.param_dtype,
                        dev)
    o = opt_lib.init_state(p)
    acc = {k: torch.zeros(t.shape, dtype=torch.float32, device=dev)
           for k, t in graphs.tree_leaves(p)}
    hidden = (mbs, seq_len, cfg.d_model)
    x = (torch.zeros((mbs, seq_len), dtype=torch.int32, device=dev)
         if stage.first else
         torch.zeros(hidden, dtype=torch_dtype(cfg.dtype), device=dev))
    y = (torch.zeros((mbs, seq_len), dtype=torch.int32, device=dev)
         if stage.last else
         torch.zeros(hidden, dtype=torch_dtype(cfg.dtype), device=dev))
    progs = pl.stage_programs(cfg, stage, opt_lib.OptimizerConfig(lr=1e-3))
    acc_tree = opt_lib.tree_unflatten(acc.items())

    def body():
        out = progs["bwd"](p, x, y)
        grads = out[1] if stage.last else out if stage.first else out[0]
        with torch.no_grad():
            for k, g in graphs.tree_leaves(grads):
                acc[k].copy_(g)
        progs["update"](p, o, acc_tree)
        return out

    step = graphs.GraphedShapes(p, "calibrate_memory")
    fused_mod.ticket_counters(step.device, step.stream)
    fa.bwd_ticket_counters(step.device, step.stream)
    return program_peak_bytes(
        lambda: step.run("stage", body, f" at stage {stage.index}"), base,
        dev)


def _train_memory_points(cfg: ModelConfig, seq_len: int, mbs_grid,
                         device: DeviceArg = None) -> List[Dict]:
    """Graphed single-device train steps (grad accumulation over 2
    microbatches, like the runtime): raw model prediction vs the
    allocator's peak (``_train_peak``)."""
    from repro_torch.core.profiler.analytic import JobProfile, TrainJob
    from repro_torch.core.simulator import memory as mem_mod

    base = _host_mem_base(cfg)
    rows = []
    for mbs in mbs_grid:
        n_micro = 2
        gbs = n_micro * mbs
        job = TrainJob(cfg=cfg, seq_len=seq_len, global_batch=gbs,
                       remat=cfg.remat)
        profile = JobProfile(job)
        actual = _train_peak(cfg, seq_len, mbs, n_micro, device)
        comp = mem_mod.stage_memory_components(
            profile, 0, profile.n_partition_units, mbs, 1,
            in_flight=1.0, mem_cfg=base)   # grad accumulation: 1 in flight
        rows.append({"kind": "train", "arch": cfg.name, "mbs": mbs,
                     "static": comp["static"], "act": comp["act"],
                     "raw_pred": comp["static"] + comp["act"],
                     "actual": actual})
    return rows


def _stage_memory_points(cfg: ModelConfig, seq_len: int, mbs: int,
                         pp: int = 2, device: DeviceArg = None
                         ) -> List[Dict]:
    """The pipeline's stage programs (``_stage_peak``: backward + update
    in one graph), one point per stage — this is what grounds the
    per-stage accounting the planner's feasibility check runs on."""
    from repro_torch.core.profiler.analytic import JobProfile, TrainJob
    from repro_torch.core.simulator import memory as mem_mod
    from repro_torch.dist.pipeline import even_stages

    base = _host_mem_base(cfg)
    job = TrainJob(cfg=cfg, seq_len=seq_len, global_batch=mbs,
                   remat=cfg.remat)
    profile = JobProfile(job)
    stages = even_stages(cfg, tps=[1] * pp, dp=1)
    rows = []
    for st in stages:
        actual = _stage_peak(cfg, st, seq_len, mbs, device)
        # profile-layer range of this stage: embed rides with stage 0,
        # the head with the last stage (MPMDPipeline's ownership rule)
        lo = 0 if st.first else st.start + 1
        hi = profile.n_partition_units if st.last else st.stop + 1
        comp = mem_mod.stage_memory_components(profile, lo, hi, mbs, 1,
                                               in_flight=1.0, mem_cfg=base)
        rows.append({"kind": "stage", "arch": cfg.name, "mbs": mbs,
                     "stage": st.index, "pp": pp,
                     "static": comp["static"], "act": comp["act"],
                     "raw_pred": comp["static"] + comp["act"],
                     "actual": actual})
    return rows


def fit_memory(rows: List[Dict], base: "MemoryModelConfig"
               ) -> "MemoryModelConfig":
    """The reference's least-squares fit of

        actual ~= frag * static + frag * act_frag * act + overhead

    over ``rows`` in relative residuals, its four clamped candidates
    (``frag >= 1``, ``act_frag >= 1``, ``overhead >= 0``) scored after
    clamping; the best one's coefficients on ``base``."""
    A = np.asarray([[r["static"], r["act"], 1.0] for r in rows])
    y = np.asarray([r["actual"] for r in rows], dtype=float)
    # minimize RELATIVE residuals (the feasibility gate cares about
    # percent error, and absolute least squares would let the largest
    # programs dominate): divide each row by its ground truth.
    W = A / y[:, None]
    ones = np.ones_like(y)

    def _clamped(a, b, c):
        a = max(a, 1.0)
        return a, max(b, a), max(c, 0.0)

    candidates = []
    free, *_ = np.linalg.lstsq(W, ones, rcond=None)        # a, b, c free
    candidates.append(_clamped(*(float(v) for v in free)))
    noc, *_ = np.linalg.lstsq(W[:, :2], ones, rcond=None)  # c = 0
    candidates.append(_clamped(float(noc[0]), float(noc[1]), 0.0))
    tied = W[:, 0] + W[:, 1]                               # b = a
    eq, *_ = np.linalg.lstsq(np.stack([tied, W[:, 2]], 1), ones, rcond=None)
    candidates.append(_clamped(float(eq[0]), float(eq[0]), float(eq[1])))
    one = float((tied @ ones) / (tied @ tied))             # b = a, c = 0
    candidates.append(_clamped(one, one, 0.0))
    # small grids can make the unconstrained solution infeasible in a way
    # naive clamping turns into a systematic over-prediction — evaluate
    # every candidate AFTER clamping and keep the best actual fit.
    a, b, c = min(candidates,
                  key=lambda abc: float(np.sum((W @ abc - ones) ** 2)))
    return dataclasses.replace(base, fragmentation=a,
                               act_fragmentation=b / a, runtime_overhead=c)


def calibrate_memory(cfgs, seq_len: int = 64, mbs_grid=(1, 2, 4), *,
                     device: DeviceArg = None) -> MemoryCalibration:
    """Fit the memory model's ``fragmentation`` / ``act_fragmentation`` /
    ``runtime_overhead`` against the card allocator's peak
    (``program_peak_bytes``).

    Grid: single-device graphed *training* steps for every config x mbs,
    plus 2-stage *pipeline-stage* programs for untied dense configs; the
    fit is ``fit_memory``'s, on the base of the configs' dtypes
    (``_host_mem_base``: every config must share them).  Raises
    ``ValueError`` on the CPU, before anything is measured.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"calibrate_memory: the memory truth is the CUDA "
                         f"allocator's peak (max_memory_allocated); {dev} "
                         f"has none")
    bases = [_host_mem_base(cfg) for cfg in cfgs]
    if any(b != bases[0] for b in bases):
        raise ValueError("calibrate_memory: the configs store different "
                         "dtypes; fit them one dtype at a time")
    rows: List[Dict] = []
    for cfg in cfgs:
        rows.extend(_train_memory_points(cfg, seq_len, mbs_grid, dev))
        if cfg.family == "dense" and not cfg.tie_embeddings:
            rows.extend(_stage_memory_points(cfg, seq_len, mbs_grid[-1],
                                             device=dev))
    return MemoryCalibration(mem_cfg=fit_memory(rows, bases[0]), points=rows)


# --- kernel calibration (the third leg: per-op cost tables) -------------------

@dataclasses.dataclass
class KernelCalibration:
    """Measured kernel cost table + the raw grid behind it.

    ``table`` maps (op, shape, dtype) -> seconds on ``table.chip``;
    registering it (done by default) makes ``analytic.JobProfile.cost``
    consult the measurements before the roofline.  ``points`` rows keep
    the per-shape measured vs roofline times for reporting.
    """

    table: kernel_costs.KernelCostTable
    points: List[Dict]


# the reference's small default grids (sized for its CPU interpret mode);
# a card run passes full-width grids (see chip_smoke.py)
_ATTN_SHAPES = ((4, 128, 64), (4, 256, 64), (4, 512, 64))      # (bh, s, d)
_DECODE_SHAPES = ((4, 256, 64), (4, 1024, 64))                 # (bh, sk, d)
_NORM_SHAPES = ((512, 256), (2048, 256), (8192, 256))          # (rows, d)
_SSD_SHAPES = ((1, 128, 2, 32, 16), (1, 512, 2, 32, 16))       # (b,s,h,p,n)


def calibrate_kernels(chip: Optional[str] = None, *,
                      dtypes=("float32",),
                      attn_shapes=_ATTN_SHAPES,
                      decode_shapes=_DECODE_SHAPES,
                      norm_shapes=_NORM_SHAPES,
                      ssd_shapes=_SSD_SHAPES,
                      iters: int = 3, autotune_blocks: bool = False,
                      register: bool = True,
                      path: Optional[str] = None,
                      device: DeviceArg = None) -> KernelCalibration:
    """Time the port's kernels into a per-(op, shape, dtype, chip) cost
    table: device time from CUDA events on the card, host time for the
    plain versions on the CPU (``at.bench_time``).

    Same grids, op names, shape keys and input draws as the reference
    (``np.random.default_rng(0)``, in its order).  With ``autotune_blocks``
    the autotuner picks each kernel's tile first (``block="auto"``, the
    winner cached on disk, ``kernels/autotune.py``), so the table prices
    the tuned kernels; the decode kernel has no tuner and keeps its
    default, as in the reference.  The table is registered
    into :mod:`kernel_costs` (``register=False`` to skip) and optionally
    saved to ``path`` (JSON, loadable by either package).
    """
    dev = resolve_device(device)
    chip = chip or at.default_chip(dev)
    acc = get_accelerator(chip) if chip in ACCELERATORS else None
    table = kernel_costs.KernelCostTable(chip=chip)
    points: List[Dict] = []
    rng = np.random.default_rng(0)

    def _arr(shape, dtype):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, torch_dtype(dtype))

    def _f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def _add(op, shape, dtype, fn):
        t = at.bench_time(fn, iters=iters, device=dev)
        table.add(op, shape, dtype, t)
        row = {"op": op, "shape": tuple(shape), "dtype": dtype,
               "time_s": t}
        if acc is not None:
            row["roofline_s"] = kernel_costs.roofline_time(
                op, shape, dtype, acc)
        points.append(row)

    blocks = "auto" if autotune_blocks else None
    for dtype in dtypes:
        for bh, s, d in attn_shapes:
            q = _arr((1, s, bh, d), dtype)
            k, v = _arr(q.shape, dtype), _arr(q.shape, dtype)
            _add("flash_attention", (bh, s, s, d, 1), dtype,
                 lambda q=q, k=k, v=v: kops.flash_attention(
                     q, k, v, causal=True, block_q=blocks, block_k=blocks))
        for bh, sk, d in decode_shapes:
            q = _arr((1, 1, bh, d), dtype)
            k, v = _arr((1, sk, bh, d), dtype), _arr((1, sk, bh, d), dtype)
            n = torch.tensor(sk, dtype=torch.int32, device=dev)
            _add("flash_decode", (bh, sk, d), dtype,
                 lambda q=q, k=k, v=v, n=n: kops.flash_attention_decode(
                     q, k, v, cache_len=n))
        for rows, d in norm_shapes:
            x, sc = _arr((rows, d), dtype), _arr((d,), dtype)
            _add("rmsnorm", (rows, d), dtype,
                 lambda x=x, sc=sc: kops.rmsnorm(x, sc, block_rows=blocks))
            r = _arr((rows, d), dtype)
            _add("fused_add_rmsnorm", (rows, d), dtype,
                 lambda x=x, r=r, sc=sc: kops.fused_add_rmsnorm(
                     x, r, sc, block_rows=blocks))
        for bs, s, h, p, n in ssd_shapes:
            x = _arr((bs, s, h, p), dtype)
            dt = _f32(rng.uniform(0.001, 0.1, (bs, s, h)))
            a = -_f32(rng.uniform(0.5, 2.0, (h,)))
            bb = _arr((bs, s, n), dtype)
            cc = _arr((bs, s, n), dtype)
            _add("ssd_scan", (bs, s, h, p, n), dtype,
                 lambda x=x, dt=dt, a=a, bb=bb, cc=cc: kops.ssd_scan(
                     x, dt, a, bb, cc, chunk=blocks))
    if register:
        kernel_costs.register_kernel_table(table)
    if path:
        table.save(path)
    return KernelCalibration(table=table, points=points)


def calibrate_engine(cfg: ModelConfig, seq_len: int = 32, mbs: int = 2,
                     n_micro_grid=(1, 2, 4), max_pp: int = 2, *,
                     dtype: str = "float32", device: DeviceArg = None
                     ) -> EngineCalibration:
    """Fit the event engine's overhead coefficients on this device.

    1. Calibrate the device's effective FLOP/s from single-block times
       (:func:`calibrate_cpu_host`, at ``dtype``) and register it under the
       device's catalog key (``autotune.default_chip``: ``"cpu-host"`` on
       the CPU, ``"H100"`` on the H100 SXM), so compute terms are measured;
    2. run real ``MPMDPipeline`` steps over a (pp, n_micro) grid
       (:func:`measure_pipeline_step`), fitting the residual against the
       raw engine prediction as ``a + b * n_dispatched_programs`` (least
       squares, clamped >= 0): ``a`` is per-iteration host overhead,
       ``b`` per-task dispatch.

    ``pp`` runs to ``max_pp`` and to the count of distinct devices
    (``torch.cuda.device_count()``; 1 on the CPU): the simulator prices
    stages as overlapping on separate devices, so two stages on one
    device would put the lost overlap into the overheads.  Returns the
    calibrated AcceleratorSpec (already registered) and an
    ``EngineConfig`` carrying the fitted overheads.
    """
    from repro_torch.core.cluster import single_zone
    from repro_torch.core.planner.plan import homogeneous_plan
    from repro_torch.core.profiler.analytic import JobProfile, TrainJob
    from repro_torch.core.simulator import timing as timing_mod
    from repro_torch.core.simulator.engine import EngineConfig

    dev = resolve_device(device)
    chip = at.default_chip(dev)
    cfg = dataclasses.replace(cfg, tie_embeddings=False)
    spec = calibrate_cpu_host(cfg, seq_len=seq_len, dtype=dtype, device=dev)
    register_calibrated(spec, chip)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    pps = [p for p in range(1, max_pp + 1) if p <= n_dev]
    cluster = single_zone(chip, max(pps))
    zone = cluster.zones[0].name
    rows, A, y = [], [], []
    raw = EngineConfig()                        # zero overheads
    for pp in pps:
        for n_micro in n_micro_grid:
            gbs = n_micro * mbs
            job = TrainJob(cfg=cfg, seq_len=seq_len, global_batch=gbs)
            profile = JobProfile(job)
            plan = homogeneous_plan(chip, zone, pp, 1, 1,
                                    profile.n_partition_units, mbs, gbs)
            pred = timing_mod.iteration_time(profile, plan, cluster,
                                             raw).t_iter
            meas = measure_pipeline_step(cfg, pp, n_micro, mbs, seq_len,
                                         device=dev)
            ops = _pipeline_ops(pp, n_micro)
            rows.append({"pp": pp, "n_micro": n_micro, "mbs": mbs,
                         "t_measured": meas, "t_raw_pred": pred,
                         "n_ops": ops})
            A.append([1.0, float(ops)])
            y.append(max(meas - pred, 0.0))
    coef, *_ = np.linalg.lstsq(np.asarray(A), np.asarray(y), rcond=None)
    a, b = float(coef[0]), float(coef[1])
    if b < 0:
        b = 0.0
        a = float(np.mean(y))
    a = max(a, 0.0)
    return EngineCalibration(
        accelerator=spec,
        engine_cfg=EngineConfig(fixed_overhead_s=a, per_task_overhead_s=b),
        points=rows)
