"""Kernel benchmarks of the port: sections 3 and 4 of
``benchmarks/kernels_bench.py``, as functions that return their numbers.

``fused_vs_unfused``     the fused residual-add + RMSNorm kernel against the
                         unfused pipeline (the add kernel writes y, the
                         RMSNorm kernel reads it back): both produce both
                         outputs, both through the port's kernels.
``cost_table_accuracy``  a calibrated cost table scored on held-out shapes:
                         per-op and median relative error of the table's
                         (interpolated) time and of the roofline-only guess,
                         against the measured time, plus the error of their
                         sums over the suite (what ``JobProfile``'s measured
                         delta corrects per layer).

``autotuned``            section 2 (the reference's ``_autotune``): one
                         op's tuner from an empty cache, every candidate's
                         time, the winner against the default tile
                         (``vs_default``) and whether a second tune from
                         another empty cache picks the same winner.

Times come from ``kernels.autotune.bench_time``: CUDA-event device time on
the card, host time on the CPU.  Section 1 of the reference (attention
implementations) waits for the mamba2 model.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod


def _inputs(rng: np.random.Generator, dev: torch.device, dtype: str):
    def arr(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, torch_dtype(dtype))
    return arr


def fused_vs_unfused(rows: int = 4096, d: int = 512, dtype: str = "float32",
                     *, iters: int = 5,
                     device: DeviceArg = None) -> Dict[str, float]:
    """Seconds of the fused kernel and of add + rmsnorm, and their ratio
    (the reference's ``_fused`` at its 4096 x 512 float32 by default)."""
    dev = resolve_device(device)
    arr = _inputs(np.random.default_rng(0), dev, dtype)
    x, r, sc = arr(rows, d), arr(rows, d), arr(d)

    def unfused():
        y = kops.add(x, r)
        return kops.rmsnorm(y, sc), y

    t_un = at.bench_time(unfused, iters=iters, device=dev)
    t_fu = at.bench_time(lambda: kops.fused_add_rmsnorm(x, r, sc),
                         iters=iters, device=dev)
    return {"fused_s": t_fu, "unfused_s": t_un, "speedup": t_un / t_fu}


def _op_inputs(arr, rng, dev, op: str, shape: Tuple[int, ...]):
    """The inputs of ``op``'s kernel at its cost-table shape key, in its
    wrapper's argument order."""
    if op == "flash_attention":
        bh, s, s2, d, _ = shape
        return arr(1, s, bh, d), arr(1, s2, bh, d), arr(1, s2, bh, d)
    if op == "flash_decode":
        bh, sk, d = shape
        return (arr(1, 1, bh, d), arr(1, sk, bh, d), arr(1, sk, bh, d),
                torch.tensor(sk, dtype=torch.int32, device=dev))
    if op == "rmsnorm":
        rows, d = shape
        return arr(rows, d), arr(d)
    if op == "fused_add_rmsnorm":
        rows, d = shape
        x, sc = arr(rows, d), arr(d)
        return x, arr(rows, d), sc
    if op == "ssd_scan":
        bs, s, h, p, n = shape
        x = arr(bs, s, h, p)
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (bs, s, h)).astype(
            np.float32)).to(dev)
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (h,)).astype(
            np.float32)).to(dev)
        return x, dt, a, arr(bs, s, n), arr(bs, s, n)
    raise ValueError(f"unknown kernel op {op!r}")


def _op_call(arr, rng, dev, op: str, shape: Tuple[int, ...], blocks=None):
    """A call of ``op``'s kernel at its cost-table shape key; ``blocks``
    its tile argument (None: the default, "auto": the tuned tile)."""
    args = _op_inputs(arr, rng, dev, op, shape)
    if op == "flash_attention":
        return lambda: kops.flash_attention(*args, causal=bool(shape[4]),
                                            block_q=blocks, block_k=blocks)
    if op == "flash_decode":
        return lambda: kops.flash_attention_decode(*args[:3],
                                                   cache_len=args[3])
    if op == "rmsnorm":
        return lambda: kops.rmsnorm(*args, block_rows=blocks)
    if op == "fused_add_rmsnorm":
        return lambda: kops.fused_add_rmsnorm(*args, block_rows=blocks)
    return lambda: kops.ssd_scan(*args, chunk=blocks)


def cost_table_accuracy(table: kernel_costs.KernelCostTable,
                        held: Iterable[Tuple[str, Tuple[int, ...]]], *,
                        dtypes: Sequence[str] = ("float32",),
                        iters: int = 5, device: DeviceArg = None,
                        blocks=None) -> Dict:
    """Score ``table`` against measured truth on the ``held`` (op, shape)
    pairs, which must lie inside the table's work range, and against the
    roofline of the table's chip.  ``blocks="auto"`` measures the tuned
    kernels (a table from ``calibrate_kernels(autotune_blocks=True)``).

    Returns, per dtype: ``rows`` (op, shape, measured, table and roofline
    seconds and relative errors), ``median_table_err``,
    ``median_roofline_err``, and ``suite_table_err`` /
    ``suite_roofline_err`` (relative error of the summed times)."""
    dev = resolve_device(device)
    acc = get_accelerator(table.chip)
    rng = np.random.default_rng(0)
    held = list(held)
    out: Dict = {}
    for dtype in dtypes:
        arr = _inputs(rng, dev, dtype)
        rows = []
        for op, shape in held:
            pred_t = table.lookup(op, shape, dtype)
            if pred_t is None:
                raise ValueError(f"cost_table_accuracy: {op} {shape} "
                                 f"{dtype} lies outside the table's range")
            actual = at.bench_time(_op_call(arr, rng, dev, op, shape,
                                            blocks),
                                   iters=iters, device=dev)
            pred_r = kernel_costs.roofline_time(op, shape, dtype, acc)
            rows.append({"op": op, "shape": list(shape), "actual_s": actual,
                         "table_s": pred_t, "roofline_s": pred_r,
                         "table_err": abs(pred_t - actual) / actual,
                         "roofline_err": abs(pred_r - actual) / actual})
        total = sum(r["actual_s"] for r in rows)
        out[dtype] = {
            "rows": rows,
            "median_table_err": float(np.median(
                [r["table_err"] for r in rows])),
            "median_roofline_err": float(np.median(
                [r["roofline_err"] for r in rows])),
            "suite_table_err": abs(sum(r["table_s"] for r in rows) - total)
            / total,
            "suite_roofline_err": abs(sum(r["roofline_s"] for r in rows)
                                      - total) / total}
    return out


def _tuned_op(arr, rng, dev, op: str, shape: Tuple[int, ...]):
    """(tune(cache) -> config, run(config), plain(config), the default
    config) for ``op`` at its cost-table shape key; ``run`` calls the
    kernel at the given tile whatever ``REPRO_KERNEL_AUTOTUNE`` says,
    ``plain`` its plain version at that tile."""
    eps = 1e-5
    if op not in ("flash_attention", "rmsnorm", "fused_add_rmsnorm",
                  "ssd_scan"):
        raise ValueError(f"no tuner for kernel op {op!r}")
    args = _op_inputs(arr, rng, dev, op, shape)
    if op == "flash_attention":
        causal = bool(shape[4])
        return (lambda cache: at.tune_flash_attention(*args, causal=causal,
                                                      cache=cache),
                lambda c: kops.flash_attention(*args, causal=causal, **c),
                lambda c: fa.flash_attention_plain(*args, causal=causal,
                                                   **c),
                {"block_q": fa.default_block_q(args[0].dtype),
                 "block_k": fa.BLOCK_K})
    if op == "rmsnorm":
        return (lambda cache: at.tune_rmsnorm(*args, eps=eps, cache=cache),
                lambda c: kops._rmsnorm(*args, eps, c["block_rows"]),
                lambda c: rn.rmsnorm_plain(*args, eps=eps),
                {"block_rows": None})
    if op == "fused_add_rmsnorm":
        route = kops._route(*args)
        return (lambda cache: at.tune_fused_add_rmsnorm(*args, eps=eps,
                                                        cache=cache),
                lambda c: kops._fused_fwd(*args, eps, c["block_rows"], route),
                lambda c: fused_mod.fused_add_rmsnorm_plain(*args, eps=eps),
                {"block_rows": None})
    return (lambda cache: at.tune_ssd_scan(*args, cache=cache),
            lambda c: kops.ssd_scan(*args, **c),
            lambda c: ssd_mod.ssd_scan_passes_plain(*args, **c),
            {"chunk": ssd_mod.CHUNK})


def autotuned(op: str, shape: Tuple[int, ...], dtype: str = "float32", *,
              cache_dir: str, iters: int = 5, device: DeviceArg = None,
              check=None) -> Dict:
    """Tune ``op`` at its cost-table ``shape`` key into an empty cache
    under ``cache_dir``, then again into a second one: ``config`` (the
    first tune's winner), ``candidates`` (every candidate's config and
    seconds, from the first tune), ``same_winner`` (the second tune's
    winner equals the first's), ``tuned_s`` / ``default_s`` (``bench_time``
    of the winner and of the default tile) and ``vs_default``
    (default / tuned: above 1 the tune paid).  ``check(got, want)``, if
    given, is called on the kernel's output at the winning tile and its
    plain version's at that tile (each a tensor or a tuple of them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    tune, run, plain, default = _tuned_op(_inputs(rng, dev, dtype), rng, dev,
                                          op, shape)
    tag = f"{op}-{dtype}-" + "x".join(map(str, shape))
    first = at.AutotuneCache(os.path.join(cache_dir, f"{tag}-a.json"))
    cfg = tune(first)
    (entry,) = first._data.values()
    again = tune(at.AutotuneCache(os.path.join(cache_dir, f"{tag}-b.json")))
    if check is not None:
        check(run(cfg), plain(cfg))
    t_tuned = at.bench_time(lambda: run(cfg), iters=iters, device=dev)
    t_def = at.bench_time(lambda: run(default), iters=iters, device=dev)
    return {"op": op, "shape": list(shape), "dtype": dtype, "config": cfg,
            "default": default,
            "candidates": [{"config": c, "s": t} for c, t in entry["tuned"]],
            "same_winner": again == cfg, "tuned_s": t_tuned,
            "default_s": t_def, "vs_default": t_def / t_tuned}
