"""Measured profiling and calibration on the card (paper §4.1): the kernel
leg of ``repro/core/profiler/measured.py``.

``calibrate_kernels`` times the port's kernels into a per-(op, shape,
dtype, chip) :class:`kernel_costs.KernelCostTable`, which
``analytic.JobProfile.cost`` and ``.decode_cost`` then consult before the
roofline.  It runs on ``cuda`` unless the caller passes ``device="cpu"``
(where the wrappers take the kernels' plain versions), and raises without
a card.  ``calibrate_cpu_host``, ``calibrate_engine`` and
``calibrate_memory`` need the port's train step and pipeline, and wait for
the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.hw_specs import (ACCELERATORS, AcceleratorSpec,
                                                get_accelerator)
from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops as kops


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
