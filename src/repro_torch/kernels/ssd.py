"""Mamba-2 SSD chunked scan: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas
``repro/kernels/ssd.py::_kernel``.  Both functions here take the reference's
layout: x (B, S, H, P); dt (B, S, H) fp32; a (H,) fp32 < 0; b, c (B, S, N).
They return y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in
fp32.  The chunk is ``max(1, min(chunk, S))`` as in the reference; a ragged
tail is shorter than the chunk, which the reference's zero pad makes an
exact no-op on the recurrence (dt = 0 steps).

``ssd_scan_plain`` repeats the kernel's chunked algorithm in PyTorch, with
the fp32 state carried from chunk to chunk and the decay evaluated only on
the lower triangle.  The CPU path and the tests use it; on the card it is
what the kernel is held against.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 128           # the reference's default chunk
MAX_CHUNK = 128       # rows of the kernel's chunk buffers
MAX_N = 128           # state width the kernel's shared-memory plan admits
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "chunk", -3: "state width", -5: "shape"}
_MAX_GRID_YZ = 65535


def check_args(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, chunk: int) -> None:
    """What the kernel takes; the plain version is held to the same rule."""
    if x.dim() != 4 or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(f"ssd_scan: x (B,S,H,P) and b/c (B,S,N) expected, "
                         f"got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bs, s, h, p = x.shape
    if tuple(dt.shape) != (bs, s, h) or tuple(a.shape) != (h,) \
            or tuple(b.shape[:2]) != (bs, s):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, b, c dtypes {x.dtype}, {b.dtype}, "
                         f"{c.dtype}; the kernel takes one of "
                         f"{list(_DTYPE_CODE)} for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and a must be float32, got "
                         f"{dt.dtype}, {a.dtype}")
    if min(bs, s, h, p) < 1:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}")
    if not 1 <= b.shape[-1] <= MAX_N:
        raise ValueError(f"ssd_scan: state width {b.shape[-1]}; the kernel "
                         f"takes 1..{MAX_N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk={chunk}; the kernel takes "
                         f"1..{MAX_CHUNK}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int = CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    bs, s, h, p = x.shape
    n = b.shape[-1]
    q = max(1, min(chunk, s))
    xf, bf, cf = x.float(), b.float(), c.float()
    af = a.float()[None, :, None]
    state = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((bs, s, h, p), dtype=torch.float32, device=x.device)
    idx = torch.arange(q, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    for c0 in range(0, s, q):
        ln = min(q, s - c0)
        xc = xf[:, c0:c0 + ln].permute(0, 2, 1, 3)          # (B, H, L, P)
        dtc = dt[:, c0:c0 + ln].float().permute(0, 2, 1)    # (B, H, L)
        bc, cc = bf[:, c0:c0 + ln], cf[:, c0:c0 + ln]       # (B, L, N)
        cum = torch.cumsum(dtc * af, dim=-1)                # (B, H, L)
        low = lower[:ln, :ln]
        li = torch.where(low, cum[..., :, None] - cum[..., None, :], 0.0)
        ldec = torch.where(low, torch.exp(li), 0.0)         # no exp above
        scores = cc @ bc.transpose(-1, -2)                  # (B, L, L)
        w = scores[:, None] * ldec * dtc[..., None, :]
        y_diag = w @ xc
        c_dec = cc[:, None] * torch.exp(cum)[..., None]     # (B, H, L, N)
        y_off = c_dec @ state.transpose(-1, -2)
        y[:, c0:c0 + ln] = (y_diag + y_off).permute(0, 2, 1, 3)
        dec_end = torch.exp(cum[..., -1:] - cum) * dtc
        upd = (xc * dec_end[..., None]).transpose(-1, -2) @ bc[:, None]
        state = torch.exp(cum[..., -1])[..., None, None] * state + upd
    return y.to(x.dtype), state


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *, chunk: int = CHUNK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    for t in (x, dt, a, b, c):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("ssd_scan_cuda: x, dt, a, b, c must be CUDA "
                             "tensors on one device")
        if not t.is_contiguous():
            raise ValueError("ssd_scan_cuda: tensors must be contiguous")
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if h > _MAX_GRID_YZ or bs > _MAX_GRID_YZ:
        raise ValueError(f"ssd_scan_cuda: B={bs}, H={h} exceed the grid "
                         f"limit {_MAX_GRID_YZ}")
    y = torch.empty_like(x)
    state = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            _DTYPE_CODE[x.dtype], x.device.index, bs, s, h, p, n,
            max(1, min(chunk, s)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ssd_scan", _ERRORS)
    return y, state
