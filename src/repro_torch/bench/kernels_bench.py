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

Times come from ``kernels.autotune.bench_time``: CUDA-event device time on
the card, host time on the CPU.  Sections 1-2 of the reference (attention
implementations, autotuned blocks) wait for SWA, the mamba2 model and the
autotuner.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops as kops


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


def _op_call(arr, rng, dev, op: str, shape: Tuple[int, ...]):
    """A call of ``op``'s kernel at its cost-table shape key."""
    if op == "flash_attention":
        bh, s, s2, d, _ = shape
        q, k, v = arr(1, s, bh, d), arr(1, s2, bh, d), arr(1, s2, bh, d)
        return lambda: kops.flash_attention(q, k, v, causal=True)
    if op == "flash_decode":
        bh, sk, d = shape
        q, k, v = arr(1, 1, bh, d), arr(1, sk, bh, d), arr(1, sk, bh, d)
        n = torch.tensor(sk, dtype=torch.int32, device=dev)
        return lambda: kops.flash_attention_decode(q, k, v, cache_len=n)
    if op in ("rmsnorm", "fused_add_rmsnorm"):
        rows, d = shape
        x, sc = arr(rows, d), arr(d)
        if op == "rmsnorm":
            return lambda: kops.rmsnorm(x, sc)
        r = arr(rows, d)
        return lambda: kops.fused_add_rmsnorm(x, r, sc)
    if op == "ssd_scan":
        bs, s, h, p, n = shape
        x = arr(bs, s, h, p)
        dt = torch.from_numpy(rng.uniform(0.001, 0.1, (bs, s, h)).astype(
            np.float32)).to(dev)
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (h,)).astype(
            np.float32)).to(dev)
        b, c = arr(bs, s, n), arr(bs, s, n)
        return lambda: kops.ssd_scan(x, dt, a, b, c)
    raise ValueError(f"unknown kernel op {op!r}")


def cost_table_accuracy(table: kernel_costs.KernelCostTable,
                        held: Iterable[Tuple[str, Tuple[int, ...]]], *,
                        dtypes: Sequence[str] = ("float32",),
                        iters: int = 5, device: DeviceArg = None) -> Dict:
    """Score ``table`` against measured truth on the ``held`` (op, shape)
    pairs, which must lie inside the table's work range, and against the
    roofline of the table's chip.

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
            actual = at.bench_time(_op_call(arr, rng, dev, op, shape),
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
