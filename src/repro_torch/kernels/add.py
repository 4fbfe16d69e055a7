"""Elementwise add: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/add.cu``) replaces the Pallas
``benchmarks/kernels_bench.py::_pallas_add``: ``y = x + r`` in the inputs'
dtype, the materialise-y pass of the unfused add-then-RMSNorm pipeline that
``bench.kernels_bench.fused_vs_unfused`` measures the fused kernel against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "empty tensor"}


def check_args(x: torch.Tensor, r: torch.Tensor) -> None:
    """What the kernel takes, held for the plain version too."""
    if x.shape != r.shape:
        raise ValueError(f"add: shapes {tuple(x.shape)} and {tuple(r.shape)} "
                         "differ")
    if x.dtype not in _DTYPE_CODE or r.dtype != x.dtype:
        raise ValueError(f"add: dtypes {x.dtype}, {r.dtype}; the kernel takes "
                         f"one of {list(_DTYPE_CODE)} for both")


def add_plain(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fp32 sum of each pair, rounded once to the inputs' dtype."""
    return (x.float() + r.float()).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_void_p])


def add_cuda(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    for t in (x, r):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("add_cuda: x, r must be CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError("add_cuda: tensors must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load("add")
    fn = lib.repro_add
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), r.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
            x.device.index, x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "add", _ERRORS)
    return y
