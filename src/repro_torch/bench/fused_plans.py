"""Every instantiation of the fused add + RMSNorm kernel, timed at the
shapes its paths run.

    python3 -m repro_torch.bench.fused_plans     # from src/, on a GPU

For each shape it launches the kernel with each plan whose lanes hold a
row exactly once over (values a lane x warps a row = the row's 16-byte
vectors over 32, to a power of two), at one row a warp and at four, and
holds each against the plain version (y bit for bit, h at 2e-2 bf16 /
2e-5 fp32).  Beside them it times the unfused pipeline (the add kernel,
then the RMSNorm kernel), which the fused kernel has to beat.  Times are
``autotune.bench_time`` (cold L2, median of 20); one JSON line a shape.
``fused.WARP_VALS`` (how many values a lane before a row takes more
warps) is read from these lines and ``chip_smoke.py``'s ``[build]``
registers.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

SHAPES = ((4096, 960, torch.bfloat16), (16384, 960, torch.bfloat16),
          (4096, 512, torch.float32), (4096, 960, torch.float32))
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def plans(d: int, dtype: torch.dtype):
    """(values a lane, warps a row) pairs that cover d with no slot to
    spare beyond the power of two."""
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    slots = 1 << (-(-d // (32 * per)) - 1).bit_length()   # vals x wpr
    return [(v, slots // v) for v in (1, 2, 4, 8)
            if v <= slots and slots // v <= rn.WARPS]


def launch(fn, x, r, sc, h, y, vals, wpr, rpb):
    rc = fn(x.data_ptr(), r.data_ptr(), sc.data_ptr(), h.data_ptr(),
            y.data_ptr(), fused_mod._DTYPE_CODE[x.dtype], x.device.index,
            x.shape[0], x.shape[1], 1, vals, wpr, rpb, 1e-5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_add_rmsnorm plan ({vals}, {wpr}, {rpb}): "
                           f"launch returned {rc}")


def main() -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = _build.load("fused_add_rmsnorm")
    fn = lib.repro_fused_add_rmsnorm
    fn.argtypes, fn.restype = fused_mod._ARGTYPES, ctypes.c_int
    for rows, d, dtype in SHAPES:
        x, r = (torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        sc = torch.randn(d, generator=gen, device="cuda").to(dtype)
        wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
        h, y = torch.empty_like(x), torch.empty_like(x)
        out = dict(shape=[rows, d], dtype=str(dtype).replace("torch.", ""),
                   planned=tuple(fused_mod.plan(x, r, sc)), ms={})
        for vals, wpr in plans(d, dtype):
            for rpb in (rn.WARPS // wpr, 4 * rn.WARPS // wpr):
                launch(fn, x, r, sc, h, y, vals, wpr, rpb)
                torch.cuda.synchronize()
                if not torch.equal(y, wy):
                    raise AssertionError(f"plan ({vals}, {wpr}, {rpb}): y")
                torch.testing.assert_close(h.float(), wh.float(),
                                           rtol=TOL[dtype], atol=TOL[dtype])
                out["ms"][f"vals{vals}_wpr{wpr}_rows{rpb}"] = at.bench_time(
                    lambda: launch(fn, x, r, sc, h, y, vals, wpr, rpb),
                    iters=20, device="cuda") * 1e3
        out["unfused_ms"] = at.bench_time(
            lambda: ops.rmsnorm(ops.add(x, r), sc), iters=20,
            device="cuda") * 1e3
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
