"""Fused residual-add + RMSNorm: the CUDA kernel's launcher and its plain
version.

The kernel (``csrc/fused_add_rmsnorm.cu``) replaces the Pallas
``repro/kernels/fused.py::_kernel`` and keeps its order of rounding, not
the model's jnp path: ``y = fp32(x) + fp32(res)`` is stored once in the
input dtype, and the norm is taken from the fp32 ``y``,
``h = (y * rsqrt(mean(y^2) + eps)) * fp32(scale)``, cast once.  It reads
x and res once and writes ``h`` and ``y`` once, one warp (or, past 512
bf16 / 256 fp32 elements, a few warps) a row; ``plan`` picks the
instantiation with the RMSNorm kernel's planner.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import MAX_D, Plan

BLOCK_ROWS = None     # rows a CUDA block takes; None: one a warp (or warp group)
# 16-byte values a lane holds before a row takes more warps: half RMSNorm's,
# since x, res and the scale are three rows of registers (see the source)
WARP_VALS = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "plan / block_rows", -3: "16-byte alignment"}
LAST_PLAN: Optional[Plan] = None   # the instantiation the last launch ran


def check_args(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
               block_rows: Optional[int]) -> None:
    """What the kernel takes, held for the plain version too."""
    d = x.shape[-1] if x.dim() else 0
    if x.shape != res.shape or x.dim() < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"fused_add_rmsnorm: x/res (..., d) and scale (d,) "
                         f"expected, got {tuple(x.shape)}, {tuple(res.shape)}"
                         f", {tuple(scale.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_add_rmsnorm: d={d}; the kernel takes "
                         f"1..{MAX_D}")
    if x.dtype not in _DTYPE_CODE or res.dtype != x.dtype \
            or scale.dtype != x.dtype:
        raise ValueError(f"fused_add_rmsnorm: dtypes {x.dtype}, {res.dtype}, "
                         f"{scale.dtype}; the kernel takes one of "
                         f"{list(_DTYPE_CODE)} for all three")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"fused_add_rmsnorm: block_rows={block_rows}")


def fused_add_rmsnorm_plain(x: torch.Tensor, res: torch.Tensor,
                            scale: torch.Tensor, *, eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, res: (..., d); scale: (d,).  Returns (normed, x + res)."""
    y = x.float() + res.float()
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    h = (y * torch.rsqrt(var + eps)) * scale.float()
    return h.to(x.dtype), y.to(x.dtype)


def plan(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor) -> Plan:
    """The instantiation for these inputs: ``rmsnorm.plan`` over x, res and
    scale (all three must start on 16-byte boundaries for 16-byte accesses)
    at ``WARP_VALS`` values a lane."""
    return rn.plan(x, res, scale, warp_vals=WARP_VALS)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def fused_add_rmsnorm_cuda(x: torch.Tensor, res: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-5,
                           block_rows: Optional[int] = BLOCK_ROWS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    global LAST_PLAN
    for t in (x, res, scale):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("fused_add_rmsnorm_cuda: x, res, scale must be "
                             "CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("fused_add_rmsnorm_cuda: tensors must be "
                             "contiguous")
    d = x.shape[-1]
    rows = x.numel() // d
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    if rows == 0:
        return h, y
    pl = plan(x, res, scale)
    rpb = block_rows or rn.WARPS // pl.warps_per_row
    lib = _build.load("fused_add_rmsnorm")
    fn = lib.repro_fused_add_rmsnorm
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), res.data_ptr(), scale.data_ptr(), h.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], x.device.index, rows, d,
            int(pl.vector), pl.vals, pl.warps_per_row, rpb, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fused_add_rmsnorm", _ERRORS)
    LAST_PLAN = pl
    return h, y
