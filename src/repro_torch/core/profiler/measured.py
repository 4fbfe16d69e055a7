"""Measured profiling and calibration on the card (paper §4.1): the
block-time fit and the kernel leg of ``repro/core/profiler/measured.py``.

``measure_block`` times the forward and the gradient of ONE decoder block
of a config (the repeated layers reduced to one instance, the paper's
trick) for a grid of microbatch sizes, and ``calibrate_cpu_host`` fits an
accelerator's effective FLOP/s to those times with the reference's
arithmetic: on the CPU the ``cpu-host`` entry, as in the reference, and
on an H100 the ``"H100"`` entry.  On the card each program runs as a CUDA
graph (the counterpart of the reference's ``jax.jit``), and its replays
are timed on the device's clock: the fit prices the card's kernels, not
the host that launches them.

``calibrate_kernels`` times the port's kernels into a per-(op, shape,
dtype, chip) :class:`kernel_costs.KernelCostTable`, which
``analytic.JobProfile.cost`` and ``.decode_cost`` then consult before the
roofline.

Each runs on ``cuda`` unless the caller passes ``device="cpu"`` (where
the kernel wrappers take their plain versions), and raises without a
card.  ``calibrate_engine`` and ``calibrate_memory`` need the port's
pipeline and are not ported yet.
"""
from __future__ import annotations

import dataclasses
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
    labels (the port's models are dense, so no frames or patches)."""
    dev = resolve_device(device)
    return {k: torch.zeros((mbs, seq_len), dtype=torch.int32, device=dev)
            for k in ("tokens", "labels")}


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
    launches loads, and the stream's fused-norm ticket counters exist
    before the capture), captured on that stream, and returned as its
    replay, which returns the graph's output tensors (the next replay
    overwrites them) and adds the capture's launches to ``ops.LAUNCHES``
    (``graphs.Captured``)."""
    step = graphs.GraphedStep(params, "measure_block")
    fused_mod.ticket_counters(step.device, step.stream)
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
    the CPU, ``"H100"`` on an H100; another card has none, and raises."""
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
    (``np.random.default_rng(0)``, in its order).  The table is registered
    into :mod:`kernel_costs` (``register=False`` to skip) and optionally
    saved to ``path`` (JSON, loadable by either package).
    """
    if autotune_blocks:
        raise NotImplementedError("calibrate_kernels(autotune_blocks=True): "
                                  "the block autotuner is not ported yet")
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

    for dtype in dtypes:
        for bh, s, d in attn_shapes:
            q = _arr((1, s, bh, d), dtype)
            k, v = _arr(q.shape, dtype), _arr(q.shape, dtype)
            _add("flash_attention", (bh, s, s, d, 1), dtype,
                 lambda q=q, k=k, v=v: kops.flash_attention(
                     q, k, v, causal=True))
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
                 lambda x=x, sc=sc: kops.rmsnorm(x, sc))
            r = _arr((rows, d), dtype)
            _add("fused_add_rmsnorm", (rows, d), dtype,
                 lambda x=x, r=r, sc=sc: kops.fused_add_rmsnorm(x, r, sc))
        for bs, s, h, p, n in ssd_shapes:
            x = _arr((bs, s, h, p), dtype)
            dt = _f32(rng.uniform(0.001, 0.1, (bs, s, h)))
            a = -_f32(rng.uniform(0.5, 2.0, (h,)))
            bb = _arr((bs, s, n), dtype)
            cc = _arr((bs, s, n), dtype)
            _add("ssd_scan", (bs, s, h, p, n), dtype,
                 lambda x=x, dt=dt, a=a, bb=bb, cc=cc: kops.ssd_scan(
                     x, dt, a, bb, cc))
    if register:
        kernel_costs.register_kernel_table(table)
    if path:
        table.save(path)
    return KernelCalibration(table=table, points=points)
