"""RMSNorm: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas
``repro/kernels/rmsnorm.py::_kernel`` and keeps its order of rounding:
``out = (x * rsqrt(mean(x^2) + eps)) * fp32(scale)`` from the fp32 ``x``,
cast once.  The model's ``layers.rms_norm`` casts before it scales; this is
the kernel's function, not that one.  It reads ``x`` once and writes the
output once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused import MAX_D, block_threads

BLOCK_ROWS = 1        # rows each CUDA block normalises, one after another
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "block width / block_rows"}


def check_args(x: torch.Tensor, scale: torch.Tensor, block_rows: int) -> None:
    """What the kernel takes, held for the plain version too."""
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: x (..., d) and scale (d,) expected, got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm: d={d}; the kernel takes 1..{MAX_D}")
    if x.dtype not in _DTYPE_CODE or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}, {scale.dtype}; the "
                         f"kernel takes one of {list(_DTYPE_CODE)} for both")
    if block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows={block_rows}")


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                 block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    for t in (x, scale):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("rmsnorm_cuda: x, scale must be CUDA tensors on "
                             "one device")
        if not t.is_contiguous():
            raise ValueError("rmsnorm_cuda: tensors must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load("rmsnorm")
    fn = lib.repro_rmsnorm
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], x.device.index, rows, d, block_threads(d),
            block_rows, eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rmsnorm", _ERRORS)
    return out
