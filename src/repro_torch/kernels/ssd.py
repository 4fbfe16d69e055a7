"""Mamba-2 SSD chunked scan: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas
``repro/kernels/ssd.py::_kernel``.  Both functions here take the reference's
layout: x (B, S, H, P); dt (B, S, H) fp32; a (H,) fp32 < 0; b, c (B, S, N).
They return y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in
fp32.  The chunk is ``max(1, min(chunk, S))`` as in the reference; a ragged
tail is shorter than the chunk, which the reference's zero pad makes an
exact no-op on the recurrence (dt = 0 steps).

The kernel runs in four passes (see ``csrc/ssd_scan.cu``); each has a
plain PyTorch version here (``ssd_cb_plain``, ``ssd_chunk_state_plain``,
``ssd_state_pass_plain``, ``ssd_chunk_scan_plain``), and their composition
``ssd_scan_passes_plain`` is the kernel's plain version: the CPU path takes
it, and on the card the kernel is held against it.  ``ssd_scan_plain`` is
the reference's algorithm itself, the fp32 state carried from chunk to chunk
in order, with the decay evaluated only on the lower triangle; the tests
hold the passes' entering states against it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 128           # the reference's default chunk
MAX_CHUNK = 128       # rows of the kernel's chunk buffers
MAX_N = 128           # state width the kernel's shared-memory plan admits
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "chunk", -3: "state width", -4: "pass",
           -5: "shape"}
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


def _padded(chunk: int, s: int) -> Tuple[int, int, int]:
    """(q, qp, nc): the chunk the scan uses, that chunk zero-filled to a
    multiple of 16 rows, and the number of chunks."""
    q = max(1, min(chunk, s))
    return q, -(-q // 16) * 16, -(-s // q)


def _chunked(t: torch.Tensor, q: int, qp: int, nc: int) -> torch.Tensor:
    """(B, S, ...) -> (B, nc, qp, ...) fp32: the sequence cut in chunks of q,
    each zero-filled to qp rows (the tail chunk too)."""
    t = t.float()
    bs, s = t.shape[:2]
    rest = t.shape[2:]
    t = torch.nn.functional.pad(t.reshape(bs, s, -1), (0, 0, 0, nc * q - s))
    t = t.reshape(bs, nc, q, -1)
    t = torch.nn.functional.pad(t, (0, 0, 0, qp - q))
    return t.reshape(bs, nc, qp, *rest)


def _lower(qp: int, device) -> torch.Tensor:
    idx = torch.arange(qp, device=device)
    return idx[:, None] >= idx[None, :]


def ssd_cb_plain(b: torch.Tensor, c: torch.Tensor, *, chunk: int = CHUNK
                 ) -> torch.Tensor:
    """Pass 1: C B^T per (batch, chunk), (B, nc, Qp, Qp) fp32, zero above
    the diagonal (the kernel leaves that part unwritten)."""
    q, qp, nc = _padded(chunk, b.shape[1])
    bc, cc = _chunked(b, q, qp, nc), _chunked(c, q, qp, nc)
    return torch.where(_lower(qp, b.device), cc @ bc.transpose(-1, -2), 0.0)


def ssd_chunk_state_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, *, chunk: int = CHUNK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: cum = cumsum(dt a) per chunk, (B, H, nc, Qp), and each
    chunk's own state contribution x^T (exp(cum_last - cum) dt * B),
    (B, H, nc, P, N) fp32."""
    q, qp, nc = _padded(chunk, x.shape[1])
    xc = _chunked(x, q, qp, nc)                          # (B, nc, Qp, H, P)
    dtc = _chunked(dt, q, qp, nc).permute(0, 3, 1, 2)    # (B, H, nc, Qp)
    bc = _chunked(b, q, qp, nc)                          # (B, nc, Qp, N)
    cum = torch.cumsum(dtc * a.float()[None, :, None, None], dim=-1)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    states = torch.einsum("bcjhp,bhcj,bcjn->bhcpn", xc, w, bc)
    return cum, states


def ssd_state_pass_plain(states: torch.Tensor, cum: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 3: (the state entering each chunk, (B, H, nc, P, N); the final
    state, (B, H, P, N)) from pass 2's outputs."""
    run = torch.zeros_like(states[:, :, 0])
    entering = torch.empty_like(states)
    decay = torch.exp(cum[..., -1])                      # (B, H, nc)
    for ci in range(states.shape[2]):
        entering[:, :, ci] = run
        run = decay[:, :, ci, None, None] * run + states[:, :, ci]
    return entering, run


def ssd_chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, c: torch.Tensor,
                         cb: torch.Tensor, cum: torch.Tensor,
                         entering: torch.Tensor, *, chunk: int = CHUNK
                         ) -> torch.Tensor:
    """Pass 4: y = W x + exp(cum_i) (C state_in^T), with
    W = CB exp(cum_i - cum_j) dt_j on the lower triangle (the exponential is
    taken only there), cast once to x's dtype."""
    bs, s, h, p = x.shape
    q, qp, nc = _padded(chunk, s)
    xc = _chunked(x, q, qp, nc).permute(0, 3, 1, 2, 4)   # (B, H, nc, Qp, P)
    dtc = _chunked(dt, q, qp, nc).permute(0, 3, 1, 2)    # (B, H, nc, Qp)
    cc = _chunked(c, q, qp, nc)                          # (B, nc, Qp, N)
    low = _lower(qp, x.device)
    li = torch.where(low, cum[..., :, None] - cum[..., None, :], 0.0)
    w = torch.where(low, cb[:, None] * torch.exp(li) * dtc[..., None, :], 0.0)
    y = w @ xc + torch.exp(cum)[..., None] * (
        cc[:, None] @ entering.transpose(-1, -2))
    y = y[:, :, :, :q].permute(0, 2, 3, 1, 4).reshape(bs, nc * q, h, p)
    return y[:, :s].to(x.dtype)


def ssd_scan_passes_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor, *,
                          chunk: int = CHUNK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four passes composed: what the kernel computes, and what it is
    held against.  Returns (y, final_state) as ``ssd_scan_plain`` does."""
    cb = ssd_cb_plain(b, c, chunk=chunk)
    cum, states = ssd_chunk_state_plain(x, dt, a, b, chunk=chunk)
    entering, final = ssd_state_pass_plain(states, cum)
    return ssd_chunk_scan_plain(x, dt, c, cb, cum, entering,
                                chunk=chunk), final


PASSES = {"all": 0, "cb": 1, "chunk_state": 2, "state_pass": 3,
          "chunk_scan": 4}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def ssd_buffers(x: torch.Tensor, b: torch.Tensor, *, chunk: int = CHUNK
                ) -> Dict[str, torch.Tensor]:
    """The kernel's outputs and the intermediates its passes hand on, empty:
    y, state, cb (B, nc, Qp, Qp), cum (B, H, nc, Qp), states (B, H, nc, P,
    N), all fp32 but y."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    _, qp, nc = _padded(chunk, s)
    f32 = dict(dtype=torch.float32, device=x.device)
    return {"y": torch.empty_like(x),
            "state": torch.empty((bs, h, p, n), **f32),
            "cb": torch.empty((bs, nc, qp, qp), **f32),
            "cum": torch.empty((bs, h, nc, qp), **f32),
            "states": torch.empty((bs, h, nc, p, n), **f32)}


def ssd_run_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, bufs: Dict[str, torch.Tensor],
                 *, chunk: int = CHUNK, which: str = "all") -> None:
    """Launch one pass (``which`` a key of ``PASSES``) or all four, in
    order, on PyTorch's current stream, reading and writing ``bufs``;
    raises on any tensor the kernel does not take and on a refused
    launch."""
    for t in (x, dt, a, b, c, *bufs.values()):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("ssd_scan_cuda: x, dt, a, b, c must be CUDA "
                             "tensors on one device")
        if not t.is_contiguous():
            raise ValueError("ssd_scan_cuda: tensors must be contiguous")
    bs, s, h, p = x.shape
    if h > _MAX_GRID_YZ or bs > _MAX_GRID_YZ:
        raise ValueError(f"ssd_scan_cuda: B={bs}, H={h} exceed the grid "
                         f"limit {_MAX_GRID_YZ}")
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (x, dt, a, b, c)),
            *(bufs[k].data_ptr() for k in ("y", "state", "cb", "cum",
                                           "states")),
            _DTYPE_CODE[x.dtype], x.device.index, bs, s, h, p, b.shape[-1],
            max(1, min(chunk, s)), PASSES[which],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "ssd_scan", _ERRORS)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, *, chunk: int = CHUNK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four passes on the card: returns (y, final_state)."""
    bufs = ssd_buffers(x, b, chunk=chunk)
    ssd_run_cuda(x, dt, a, b, c, bufs, chunk=chunk)
    return bufs["y"], bufs["state"]
