"""RMSNorm: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/rmsnorm.cu``) replaces the Pallas
``repro/kernels/rmsnorm.py::_kernel`` and keeps its order of rounding:
``out = (x * rsqrt(mean(x^2) + eps)) * fp32(scale)`` from the fp32 ``x``,
cast once.  The model's ``layers.rms_norm`` casts before it scales; this is
the kernel's function, not that one.  It reads ``x`` once and writes the
output once, one warp (or, past 1024 bf16 / 512 fp32 elements, a few
warps) a row; ``plan`` picks the instantiation.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

BLOCK_ROWS = None     # rows a CUDA block takes; None: one a warp (or warp group)
MAX_D = 8192          # widest row the norm kernels take
WARPS = 8             # warps a block (kWarps in the source)
WARP_VALS = 4         # 16-byte values a lane holds before a row takes more warps
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "plan / block_rows", -3: "16-byte alignment"}
LAST_PLAN: Optional["Plan"] = None   # the instantiation the last launch ran


class Plan(NamedTuple):
    """Which instantiation of the kernel a call runs: 16-byte loads or one
    element a load, 16-byte values a lane, warps a row."""
    vector: bool
    vals: int
    warps_per_row: int


def check_args(x: torch.Tensor, scale: torch.Tensor,
               block_rows: Optional[int]) -> None:
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
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows={block_rows}")


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(x: torch.Tensor, *aligned: torch.Tensor,
         warp_vals: int = WARP_VALS) -> Plan:
    """The instantiation for x's width, dtype and storage: 16-byte loads
    when d is a multiple of the vector (8 bf16, 4 fp32) and x and every
    tensor of ``aligned`` (the other inputs; outputs are new allocations)
    start on 16-byte boundaries; one warp a row up to ``32 * warp_vals``
    vectors (``WARP_VALS``: 1024 bf16, 512 fp32 elements), else 2-8 warps
    of ``warp_vals`` values a lane, and past that 8 warps of as many values
    as cover d (8 for fp32 rows wider than 4096).  The fused add + RMSNorm
    kernel shares this planner with its own ``warp_vals``."""
    d = x.shape[-1]
    per = 16 // x.element_size()
    vector = d % per == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, *aligned))
    units = -(-d // per)
    if units <= 32 * warp_vals:
        return Plan(vector, _pow2_at_least(-(-units // 32)), 1)
    warps = _pow2_at_least(-(-units // (32 * warp_vals)))
    if warps <= WARPS:
        return Plan(vector, warp_vals, warps)
    return Plan(vector, _pow2_at_least(-(-units // (32 * WARPS))), WARPS)


_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                 block_rows: Optional[int] = BLOCK_ROWS) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    global LAST_PLAN
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
    pl = plan(x, scale)
    rpb = block_rows or WARPS // pl.warps_per_row
    lib = _build.load("rmsnorm")
    fn = lib.repro_rmsnorm
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[x.dtype], x.device.index, rows, d, int(pl.vector),
            pl.vals, pl.warps_per_row, rpb, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rmsnorm", _ERRORS)
    LAST_PLAN = pl
    return out
