"""Fused residual-add + RMSNorm: the CUDA kernel's launcher and its plain
version.

The kernel (``csrc/fused_add_rmsnorm.cu``) replaces the Pallas
``repro/kernels/fused.py::_kernel`` and keeps its order of rounding, not
the model's jnp path: ``y = fp32(x) + fp32(res)`` is stored once in the
input dtype, and the norm is taken from the fp32 ``y``,
``h = (y * rsqrt(mean(y^2) + eps)) * fp32(scale)``, cast once.  It reads
x and res once and writes ``h`` and ``y`` once.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

BLOCK_ROWS = 1        # rows each CUDA block normalises, one after another
MAX_D = 8192
_VALS = 8             # row elements each thread holds (kVals in the source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "block width / block_rows"}


def check_args(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
               block_rows: int) -> None:
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
    if block_rows < 1:
        raise ValueError(f"fused_add_rmsnorm: block_rows={block_rows}")


def fused_add_rmsnorm_plain(x: torch.Tensor, res: torch.Tensor,
                            scale: torch.Tensor, *, eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, res: (..., d); scale: (d,).  Returns (normed, x + res)."""
    y = x.float() + res.float()
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    h = (y * torch.rsqrt(var + eps)) * scale.float()
    return h.to(x.dtype), y.to(x.dtype)


def block_threads(d: int) -> int:
    """Threads per block: the power of two that lets ``_VALS`` elements a
    thread cover d, between one warp and 1024."""
    need = -(-d // _VALS)
    return min(1024, max(32, 1 << (need - 1).bit_length()))


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def fused_add_rmsnorm_cuda(x: torch.Tensor, res: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-5,
                           block_rows: int = BLOCK_ROWS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
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
    lib = _build.load("fused_add_rmsnorm")
    fn = lib.repro_fused_add_rmsnorm
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), res.data_ptr(), scale.data_ptr(), h.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], x.device.index, rows, d,
            block_threads(d), block_rows, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fused_add_rmsnorm", _ERRORS)
    return h, y
