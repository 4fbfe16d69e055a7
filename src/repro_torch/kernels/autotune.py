"""Chip identity and kernel timing (the part of ``repro/kernels/autotune.py``
that kernel calibration needs).

``default_chip`` names the device the kernels run on, as the key of the
accelerator catalog and of cost tables; ``bench_time`` times one call.  The
block-size autotuner itself (``autotune``, the candidate grids, the
per-kernel tuners and their on-disk cache) is not ported yet, so
``block="auto"`` raises in ``kernels/ops.py``.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Union

import torch

DeviceArg = Union[str, torch.device, None]
_SLEEP_CYCLES = 20_000_000    # ~10 ms of device clock, longer than the enqueue
_FLUSH_BYTES = 128 << 20      # over twice the H100's 50 MB L2


# the one card the catalog's "H100" entry describes: the SXM part's data
# sheet (core/profiler/hw_specs.py), under the name the card reports
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"


def default_chip(device: DeviceArg = None) -> str:
    """Cache identity of the device the kernels run on: ``"H100"`` for the
    card the catalog's ``"H100"`` entry describes (the SXM part,
    ``H100_SXM_NAME``; the key ``JobProfile.cost(..., "H100", ...)`` looks
    up), any other card's name lowercased with ``-`` for spaces (the
    reference's rule for a device kind: ``nvidia-h100-pcie``,
    ``nvidia-h100-nvl``, which the catalog does not hold), and
    ``"cpu-host"`` for the CPU."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type != "cuda":
        return "cpu-host"
    name = torch.cuda.get_device_name(dev)
    if name == H100_SXM_NAME:
        return "H100"
    return name.replace(" ", "-").lower()


def bench_time(fn: Callable[[], Any], *, warmup: int = 1, iters: int = 3,
               device: DeviceArg = None) -> float:
    """Median seconds of one ``fn()`` call.

    On a CUDA device each call is timed alone with a pair of CUDA events
    (device time: what ``JobProfile`` adds to its compute term; host
    dispatch belongs to the engine's overheads), and starts with a cold L2:
    a 128 MB read queued before it evicts what earlier calls left there, so
    its bytes come from device memory and the time can be held against the
    memory-rate bound.  A sleep kernel queued first keeps the device busy
    while the host enqueues the calls, so the host's launch gaps do not
    count where the host keeps ahead.  On the CPU the host clock times each
    call, as the reference times its interpret-mode kernels."""
    dev = torch.device(device or "cpu")
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        # read before each call: the last call's inputs leave the L2, and
        # its outputs are written back outside the timed window
        flush = torch.ones(_FLUSH_BYTES // 4, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(_SLEEP_CYCLES)
        pairs = []
        for _ in range(iters):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]
