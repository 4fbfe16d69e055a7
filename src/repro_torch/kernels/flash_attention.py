"""Flash attention forward: the CUDA kernels' launcher and their plain version.

The kernels (``csrc/flash_attention.cu``) replace the Pallas
``repro/kernels/flash_attention.py::_kernel``: FlashAttention-2 forward
with fp32 online softmax, scores scaled by 1/sqrt(d) after the product, a
top-left aligned causal mask and the KV tail past ``sk`` masked.  Both
functions here take the model's (B, S, H, D) layout and GQA
(``H % KH == 0``) directly.  The dtype picks the kernel:

- bfloat16 -> ``"wgmma"``: both products on the tensor cores, q tiles of 64
  or 128 rows (one or two warpgroups); P enters P V as two bf16 parts, its
  rounding ``hi`` and the rounding of ``p - hi``.
- float32 -> ``"cuda_core"``: fp32 products on the CUDA cores, as the Pallas
  kernel computes them, q tiles of 64 or 128 rows (two threads a row, each
  thread an 8-row register tile of S and of O), K/V double-buffered by
  16-byte ``cp.async`` copies.

Both kernels copy 16 bytes at a time, so q, k and v must start on 16-byte
boundaries with 16-byte multiples for their batch, seq and head strides;
the wrapper raises otherwise, for either dtype.

``impl="cuda_core"`` on ``flash_attention_cuda`` and the plain version pins
the CUDA-core kernel for bf16 too, so a run can time the two on one card.

``flash_attention_plain`` repeats the kernels' block algorithm in PyTorch:
q tiles of ``block_q`` rows, a loop over ``block_k``-key tiles that stops
at the tile's causal limit, the same online-softmax update and, for the
``"wgmma"`` kernel, the same split of P.  The CPU path and the tests use
it; on the card it is what the kernels are held against.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_K = 64                  # keys per K/V tile staged in shared memory
BLOCK_K_CHOICES = (64,)
# q rows per CUDA block, by kernel: the tiles each is compiled for and the
# default (wgmma: one or two 64-row warpgroups; cuda_core: 4 or 8 warps,
# each 16 rows)
BLOCK_Q_CHOICES = {"wgmma": (64, 128), "cuda_core": (64, 128)}
BLOCK_Q = {"wgmma": 128, "cuda_core": 64}
HEAD_DIMS = tuple(range(16, 129, 16))   # one kernel instantiation each
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPL_CODE = {None: 0, "cuda_core": 1}
_ERRORS = {-1: "dtype", -2: "block_q", -3: "head dim", -4: "block_k",
           -5: "impl"}
_MAX_GRID_YZ = 65535
H100_SMS = 132                # the grids sized from shapes alone assume it


def kernel_for(dtype: torch.dtype, impl: Optional[str] = None) -> str:
    """The kernel a call of ``dtype`` runs: bf16 ``"wgmma"``, any other
    ``"cuda_core"``; ``impl="cuda_core"`` pins the CUDA-core kernel."""
    if impl not in _IMPL_CODE:
        raise ValueError(f"flash_attention: impl={impl!r}; None (by dtype) "
                         f"or 'cuda_core'")
    return impl or ("wgmma" if dtype == torch.bfloat16 else "cuda_core")


def default_block_q(dtype: torch.dtype, impl: Optional[str] = None) -> int:
    return BLOCK_Q[kernel_for(dtype, impl)]


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int, block_k: int) -> None:
    """What the kernels take; the plain version is held to the same rule so
    a shape that passes on the CPU also runs on the card.  ``block_q``
    must be one of the tiles of q's dtype's kernel."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Sq,H,D) and k/v (B,Sk,KH,D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (need H % KH == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported; "
                         f"the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes one of "
                         f"{list(_DTYPE_CODE)} for all three")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    kern = kernel_for(q.dtype)
    if block_q not in BLOCK_Q_CHOICES[kern] or block_k not in BLOCK_K_CHOICES:
        raise ValueError(f"flash_attention: block_q={block_q}, "
                         f"block_k={block_k}; the {kern} kernel ({q.dtype}) "
                         f"is built for block_q in {BLOCK_Q_CHOICES[kern]}, "
                         f"block_k in {BLOCK_K_CHOICES}")


def _rounded(x: torch.Tensor, dtype: torch.dtype, split: bool
             ) -> torch.Tensor:
    """fp32 ``x`` as a tensor-core A operand: its ``dtype`` rounding
    ``hi``, plus with ``split`` the rounding of ``x - hi`` (exact in
    fp32)."""
    hi = x.to(dtype).float()
    return hi + (x - hi).to(dtype).float() if split else hi


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          block_q: Optional[int] = None,
                          block_k: int = BLOCK_K,
                          impl: Optional[str] = None,
                          return_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.
    ``block_q`` None takes the kernel's default tile; the ``"wgmma"``
    kernel's P enters P V as ``hi + lo``, each rounded to q's dtype (its
    sum l is taken before the split).  ``return_lse`` also returns each
    row's fp32 log-sum-exp of its scaled, masked scores, ``m + log(l)``,
    shaped (B, H, Sq): what the backward needs to recompute P."""
    split_p = kernel_for(q.dtype, impl) == "wgmma"
    block_q = block_q or default_block_q(q.dtype, impl)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    kv_head = torch.arange(h, device=q.device) // (h // kh)
    qf = q.float().transpose(1, 2)                      # (B, H, Sq, D)
    kf = k.float()[:, :, kv_head].transpose(1, 2)       # (B, H, Sk, D)
    vf = v.float()[:, :, kv_head].transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        n = qt.shape[2]
        q_pos = torch.arange(q0, q0 + n, device=q.device)
        m = torch.full((b, h, n), NEG_INF, device=q.device)
        l = torch.zeros((b, h, n), device=q.device)
        acc = torch.zeros((b, h, n, d), device=q.device)
        k_end = min(sk, q0 + block_q) if causal else sk
        for k0 in range(0, k_end, block_k):     # tile 0 always holds key 0
            kt = kf[:, :, k0:k0 + block_k]
            s = (qt @ kt.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
                s = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = _rounded(p, q.dtype, True) if split_p else p
            acc = acc * corr[..., None] + pv @ vf[:, :, k0:k0 + block_k]
            m = m_new
        out[:, :, q0:q0 + n] = acc / torch.clamp_min(l, 1e-30)[..., None]
        lse[:, :, q0:q0 + n] = m + torch.log(l)
    o = out.transpose(1, 2).to(q.dtype)
    return (o, lse) if return_lse else o


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _check_16_bytes(t: torch.Tensor, name: str, what: str) -> None:
    """A kernel that reads 16 bytes a lane: the base and every stride of a
    dim longer than 1 must be 16-byte multiples."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(i) * es % 16
                                for i in range(3) if t.shape[i] > 1):
        raise ValueError(f"{what}: {name} must start on a 16-byte boundary "
                         f"with 16-byte multiples for its batch, seq and "
                         f"head strides (got strides {t.stride()} of "
                         f"{es}-byte elements)")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         block_q: Optional[int] = None,
                         block_k: int = BLOCK_K,
                         impl: Optional[str] = None,
                         return_lse: bool = False):
    """Launch q's dtype's kernel (or, with ``impl="cuda_core"``, the
    CUDA-core one) on PyTorch's current stream; raises on any tensor it
    does not take (rows not on 16-byte boundaries first, for either
    kernel) and on a refused launch.  ``return_lse`` also returns the rows' fp32
    log-sum-exp (B, H, Sq), written by the kernel's epilogue; without it
    the kernel gets a null pointer and writes O alone."""
    kern = kernel_for(q.dtype, impl)
    block_q = block_q or BLOCK_Q[kern]
    for name, t in (("q", q), ("k", k), ("v", v)):   # 16-byte copies
        _check_16_bytes(t, name, "flash_attention_cuda")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v must be CUDA "
                             "tensors on one device")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_cuda: the last dim must be "
                             "contiguous")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_cuda: B={b}, H={h} exceed the "
                         f"grid limit {_MAX_GRID_YZ}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPE_CODE[q.dtype], _IMPL_CODE[impl], q.device.index, b, sq,
            sk, h, kh, d,
            block_q, block_k, *strides, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention", _ERRORS)
    return (o, lse) if return_lse else o


# --- backward (FlashAttention-2) ------------------------------------------------
#
# The reference has no backward for its Pallas kernel (no custom_vjp): its
# training differentiates the jnp attention.  The kernels in
# ``csrc/flash_attention_bwd.cu`` are the FlashAttention-2 backward of the
# forward above, from the fp32 row LSE it saved:
#   P = exp(S * scale - LSE)  (masked entries 0);  dP = dO V^T
#   delta = rowsum(P * dP);  dS = P * (dP - delta)
#   dV = P^T dO;  dK = dS^T Q * scale;  dQ = dS K * scale
# with GQA's dK/dV summed over the group's query heads.  delta is
# rowsum(dO * O) in exact arithmetic; taken from P and dP it needs no O and
# keeps each row of dS summing to zero, where the bf16-rounded O does not
# (see the source).  Every sum is fp32 from the inputs' values; dQ, dK, dV
# are cast once to q's dtype.  The dtype picks the kernels, as in the
# forward (``kernel_for``):
#
# - bfloat16 -> ``"wgmma"``: the products on the tensor cores, P and dS
#   entering them in bf16, as one rounding or as hi + lo
#   (``WGMMA_BWD_SPLIT``); blocks of 64 or 128 q rows (dQ) and keys (dK/dV).
# - float32 -> ``"cuda_core"``: fp32 products on the CUDA cores, blocks of
#   32 or 64 q rows (dQ) and keys (dK/dV), each thread an 8-row register
#   tile (4 in dK/dV past head dim 64) against 64-column streamed tiles.
#   The dK/dV kernel takes one block a (key tile, query head); with a GQA
#   group of G > 1 the heads' fp32 shares meet in scratch the wrapper
#   allocates, and the group's last block to draw a ticket from an int32
#   counter (``bwd_ticket_counters``) adds them in head order.
#   ``impl="cuda_core"`` pins these for bf16 too.

BWD_BLOCK = 64                # q rows and keys per tile of a warpgroup or block
# q rows (dQ kernel) and keys (dK/dV kernel) a block, by kernel: the
# choices each is built for (the CUDA-core ones the source's kBlockSmall,
# kBlockLarge) and the defaults (each pair chosen by timing all four,
# ``chip_smoke.py``'s ``blocks_ms``); ``bwd_block_pair`` adapts the
# CUDA-core dQ block to the grid
BWD_BLOCK_CHOICES = {"wgmma": (64, 128), "cuda_core": (32, 64)}
BWD_BLOCKS = {"wgmma": (128, 128), "cuda_core": (64, 32)}
# the CUDA-core dQ kernel takes 32-row blocks while its 64-row grid is at
# most this many blocks an SM (two 64-row blocks fit an SM at D 64)
BWD_SMALL_GRID = 2
# the CUDA-core dK/dV kernel's ticket counters made at a stream's first
# call: one a (batch, KV head, key tile), grown when a launch needs more
BWD_TICKETS = 1 << 16
# How the tensor-core kernels' bf16 A operands enter their products: True
# is hi + lo (two bf16 parts, two products), False one bf16 rounding.  The
# source's kSplit* constants; chosen per product on a trained model's
# inputs (``bench/attention_bwd_precision.py``).
WGMMA_BWD_SPLIT = {"p_dv": False, "ds_dk": False, "ds_dq": True}
_BWD_ERRORS = {-1: "dtype", -2: "block_q", -3: "head dim", -4: "block_k",
               -5: "shape", -6: "impl", -7: "scratch"}
_TICKETS: dict = {}     # (device index, stream) -> counters, newest last


def bwd_block_pair(kern: str, b: int, sq: int, h: int,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(block_q, block_k) a launch of ``kern``'s backward takes by default,
    from host-known shapes: ``BWD_BLOCKS[kern]``, except that the
    CUDA-core dQ kernel takes 32-row blocks (4 rows a thread) while its
    64-row grid, ``b * h * ceil(sq / 64)`` blocks, is at most
    ``BWD_SMALL_GRID`` blocks an SM: there each warp's own chain of work
    sets the time, and a 32-row block's warps carry half a 64-row one's.
    Measured on an H100 (``PERF.md``, beside 32-key dK/dV blocks): 32-row
    dQ blocks 8-14% faster at the plan phase's (1-4, 128, 15/5, 64), 8%
    slower at the train shape's 960 blocks."""
    bq, bk = BWD_BLOCKS[kern]
    if kern == "cuda_core" and b * h * -(-sq // BWD_BLOCK) \
            <= BWD_SMALL_GRID * sms:
        bq = BWD_BLOCK_CHOICES[kern][0]
    return bq, bk


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, *, causal: bool = True,
                              impl: Optional[str] = None,
                              split: Optional[dict] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The kernels' algorithm in PyTorch: q tiles of ``BWD_BLOCK`` rows
    recompute P from the LSE and dP, take their rows' delta, add their
    share of dK and dV (fp32, summed over the GQA group) and give their
    rows of dQ.  For the ``"wgmma"`` kernels (``kernel_for(q.dtype,
    impl)``) P and dS enter their products rounded as the kernels round
    them: ``split`` (default ``WGMMA_BWD_SPLIT``) says which take hi + lo.
    Returns (dq, dk, dv) in q's dtype and the inputs' layouts."""
    wgmma = kernel_for(q.dtype, impl) == "wgmma"
    split = split or WGMMA_BWD_SPLIT
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    kv_head = torch.arange(h, device=q.device) // g
    scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)                      # (B, H, Sq, D)
    kf = k.float()[:, :, kv_head].transpose(1, 2)       # (B, H, Sk, D)
    vf = v.float()[:, :, kv_head].transpose(1, 2)
    dof = do.float().transpose(1, 2)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    k_pos = torch.arange(sk, device=q.device)

    def operand(x, part):
        return _rounded(x, q.dtype, split[part]) if wgmma else x
    for q0 in range(0, sq, BWD_BLOCK):
        qt, dot = qf[:, :, q0:q0 + BWD_BLOCK], dof[:, :, q0:q0 + BWD_BLOCK]
        n = qt.shape[2]
        q_pos = torch.arange(q0, q0 + n, device=q.device)
        s = (qt @ kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, q0:q0 + n, None])
        if causal:
            p = torch.where(k_pos[None, :] > q_pos[:, None], 0.0, p)
        dv += operand(p, "p_dv").transpose(-1, -2) @ dot
        dp = dot @ vf.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, :, q0:q0 + n] = (operand(ds, "ds_dq") @ kf) * scale
        dk += (operand(ds, "ds_dk").transpose(-1, -2) @ qt) * scale
    dk = dk.reshape(b, kh, g, sk, d).sum(dim=2)
    dv = dv.reshape(b, kh, g, sk, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(q.dtype),
            dv.transpose(1, 2).to(q.dtype))


_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                 + [ctypes.c_float, ctypes.c_void_p])


def bwd_ticket_counters(device: torch.device, stream,
                        n: int = BWD_TICKETS) -> torch.Tensor:
    """The stream's ticket counters for the CUDA-core dK/dV kernel (int32,
    at least ``n``): allocated and zeroed on the stream at the first call
    for this (device, stream), and again, at least twice as many, when a
    launch needs more than it has; every launch leaves them zero.  A CUDA
    graph captured on ``stream`` needs them made before its capture begins
    (call this, or run the backward once on the stream at the capture's
    shapes): a call that would make them inside a capture raises.  Counters
    that were replaced stay allocated, since a graph captured before may
    launch on them."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, stream.cuda_stream)
    made = _TICKETS.setdefault(key, [])
    if not made or made[-1].numel() < n:
        with torch.cuda.stream(stream):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "flash_attention_bwd: the ticket counters of a stream "
                    "under graph capture must be made before the capture "
                    "(flash_attention.bwd_ticket_counters(device, stream, "
                    "n))")
            size = max(n, BWD_TICKETS, 2 * made[-1].numel() if made else 0)
            made.append(torch.zeros(size, dtype=torch.int32, device=device))
    return made[-1]


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, *, causal: bool = True,
                             impl: Optional[str] = None,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch q's dtype's two backward kernels (or, with
    ``impl="cuda_core"``, the CUDA-core ones) on PyTorch's current stream:
    dQ with delta, then dK/dV.  ``block_q`` / ``block_k`` (None: the
    kernels' defaults for the shape, ``bwd_block_pair``) are the q rows
    and keys a block takes.  Raises on any tensor they do not take (rows not
    on 16-byte boundaries, for either pair of kernels, before it looks at
    the device) and on a refused launch.  Inputs are made contiguous (a no-op on the
    model's path); two calls on the same inputs agree bit for bit (no
    atomics on data).  The CUDA-core pair with H > KH also takes fp32
    scratch for the heads' dK/dV shares and the stream's ticket counters
    (``bwd_ticket_counters``)."""
    kern = kernel_for(q.dtype, impl)
    bq, bk = bwd_block_pair(kern, q.shape[0], q.shape[1], q.shape[2])
    block_q, block_k = block_q or bq, block_k or bk
    if block_q not in BWD_BLOCK_CHOICES[kern] \
            or block_k not in BWD_BLOCK_CHOICES[kern]:
        raise ValueError(f"flash_attention_bwd_cuda: block_q={block_q}, "
                         f"block_k={block_k}; the {kern} kernels are built "
                         f"for {BWD_BLOCK_CHOICES[kern]}")
    q, k, v, do, lse = (t.contiguous() for t in (q, k, v, do, lse))
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_16_bytes(t, name, "flash_attention_bwd_cuda")  # 16-byte copies
    for t in (q, k, v, do, lse):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention_bwd_cuda: q, k, v, do, lse "
                             "must be CUDA tensors on one device")
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype \
            or tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: do {tuple(do.shape)} "
                         f"{do.dtype} and lse {tuple(lse.shape)} {lse.dtype} "
                         f"do not match q {tuple(q.shape)} {q.dtype}")
    if h > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bwd_cuda: B={b}, H={h} exceed "
                         f"the grid limit {_MAX_GRID_YZ}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    partial = counter = None
    if kern == "cuda_core" and h > kh:
        partial = torch.empty((2, b, h, sk, d), dtype=torch.float32,
                              device=q.device)
        counter = bwd_ticket_counters(q.device, stream,
                                      b * kh * -(-sk // block_k))
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counter is None else counter.data_ptr(),
            _DTYPE_CODE[q.dtype], _IMPL_CODE[impl], q.device.index, b, sq,
            sk, h, kh, d, block_q, block_k, int(causal), 1.0 / math.sqrt(d),
            stream.cuda_stream)
    _build.check(lib, rc, "flash_attention_bwd", _BWD_ERRORS)
    del delta, partial    # freed in stream order, after the kernels
    return dq, dk, dv


# --- decode (q_len == 1 against a cache with a dynamic valid length) ------------
#
# The kernel (``csrc/flash_decode.cu``) replaces the Pallas
# ``repro/kernels/flash_attention.py::_decode_kernel``.  q: (B, 1, H, D);
# k, v: (B, S, KH, D) caches read in place through their strides;
# ``cache_len`` an int or a 0-d integer tensor (on the card it is read by the
# kernel itself, with no host sync), clamped to [0, S].
#
# Split-K (flash-decoding): the keys are cut into ``n_splits`` runs of whole
# 64-key tiles, each run's partial (m, l, acc) is computed on its own, and a
# merge combines them.  The plain version repeats the split and the merge.

_DECODE_ERRORS = {-1: "dtype", -3: "head dim", -4: "block_k", -5: "shape",
                  -6: "split", -7: "heads per block"}
DECODE_HEADS = (1, 2, 4, 8)   # query heads a block takes: one build each
BLOCKS_PER_SM = 4             # decode_splits' target grid: 4 blocks an SM


def decode_heads(group: int) -> int:
    """Query heads one decode block takes for a GQA group of ``group``:
    the least of ``DECODE_HEADS`` that holds the group, at most 8 (a larger
    group spans ``ceil(group / 8)`` head groups, each reading the K/V)."""
    return next(n for n in DECODE_HEADS if n >= min(group, DECODE_HEADS[-1]))


def decode_splits(b: int, kh: int, groups: int, s: int, *,
                  sms: int = H100_SMS) -> int:
    """How many splits of whole 64-key tiles the decode grid cuts an
    S-key cache into, from host-known shapes only (never ``cache_len``, so
    a length on the card costs no sync).

    ``groups`` is the number of head groups (``ceil(G / decode_heads(G))``).
    The count is the least that gives ``b * kh * groups * n`` at least
    ``BLOCKS_PER_SM * sms`` blocks, capped at one tile a split, then lowered
    while every split keeps the same whole-tile length so no split is empty
    at ``cache_len == S``.  So ``1 <= n <= ceil(S / 64)``, and
    ``n >= want / 2`` where ``want`` is that least count."""
    tiles = -(-s // BLOCK_K)
    base = b * kh * groups
    want = -(-BLOCKS_PER_SM * sms // base)
    n = max(1, min(want, tiles))
    per = -(-tiles // n)
    return -(-tiles // per)


def split_keys(s: int, n_splits: int) -> int:
    """Keys a split takes: ``ceil(tiles / n_splits)`` whole 64-key tiles.
    Split i covers ``[i * split_keys, min((i + 1) * split_keys, S))``."""
    return -(-(-(-s // BLOCK_K)) // n_splits) * BLOCK_K


def decode_plan(b: int, s: int, h: int, kh: int,
                n_splits: Optional[int] = None) -> Tuple[int, int, int]:
    """(n_splits, split_keys, heads_per_block) of one decode call; an
    explicit ``n_splits`` must lie in [1, ceil(S / 64)]."""
    g = h // kh
    nh = decode_heads(g)
    tiles = -(-s // BLOCK_K)
    if n_splits is None:
        n_splits = decode_splits(b, kh, -(-g // nh), s)
    elif (isinstance(n_splits, bool) or not isinstance(n_splits, int)
          or not 1 <= n_splits <= tiles):
        raise ValueError(f"flash_attention_decode: n_splits={n_splits!r}; "
                         f"an int in [1, {tiles}] (one 64-key tile a split "
                         f"at most) for S={s}")
    return n_splits, split_keys(s, n_splits), nh


def check_decode_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_k: int) -> None:
    """What the decode kernel takes, held for the plain version too."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_decode: q (B,1,H,D) and k/v "
                         f"(B,S,KH,D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention_decode: k/v {tuple(k.shape)} do "
                         f"not match q {tuple(q.shape)} (need H % KH == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_decode: head dim {d} not "
                         f"supported; the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_decode: dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; the kernel takes one of "
                         f"{list(_DTYPE_CODE)} for all three")
    if b < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention_decode: empty batch or cache")
    if block_k not in BLOCK_K_CHOICES:
        raise ValueError(f"flash_attention_decode: block_k={block_k}; the "
                         f"kernel is built for {BLOCK_K_CHOICES}")


def _length(cache_len, device: torch.device,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``cache_len`` as a 0-d integer tensor on ``device`` (no copy when
    it already is one of ``dtype`` there)."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.numel() != 1 or cache_len.is_floating_point():
            raise ValueError(f"flash_attention_decode: cache_len must be one "
                             f"integer, got {tuple(cache_len.shape)} "
                             f"{cache_len.dtype}")
        return cache_len.reshape(()).to(device=device, dtype=dtype)
    return torch.tensor(int(cache_len), dtype=dtype, device=device)


def flash_attention_decode_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, cache_len,
                                 block_k: int = BLOCK_K,
                                 n_splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, S, KH, D) -> (B, 1, H, D) in q's dtype.

    The kernel's algorithm: each split (``decode_plan``) runs the tile loop
    on its own keys, where tiles wholly past ``cache_len`` leave the running
    statistics untouched (a select, so a length on the card needs no sync);
    then the merge, ``sum w_i acc_i / max(sum w_i l_i, 1e-30)`` with
    ``w_i = exp(m_i - max m)``.  ``cache_len == 0`` gives zeros."""
    b, _, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    ns, sk, _ = decode_plan(b, s, h, kh, n_splits)
    n = _length(cache_len, q.device).clamp(0, s)
    qs = (q.float() / math.sqrt(d)).to(q.dtype).float()   # scale, then round
    qg = qs.reshape(b, kh, h // kh, d)                    # (B, KH, G, D)
    kf = k.float().transpose(1, 2)                        # (B, KH, S, D)
    vf = v.float().transpose(1, 2)
    parts = []
    for lo in range(0, ns * sk, sk):
        m = torch.full(qg.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qg.shape[:3], device=q.device)
        acc = torch.zeros(qg.shape, device=q.device)
        for k0 in range(lo, min(lo + sk, s), block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            sc = qg @ kt.transpose(-1, -2)                # (B, KH, G, T)
            pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            sc = torch.where(pos >= n, NEG_INF, sc)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            live = n > k0
            l = torch.where(live, l * corr + p.sum(dim=-1), l)
            acc = torch.where(live, acc * corr[..., None] + p @ vt, acc)
            m = torch.where(live, m_new, m)
        parts.append((m, l, acc))
    m, l, acc = (torch.stack(t, dim=-1) for t in zip(*parts))
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))       # (B, KH, G, n)
    out = ((acc * w[..., None, :]).sum(dim=-1)
           / torch.clamp_min((l * w).sum(dim=-1), 1e-30)[..., None])
    return out.reshape(b, 1, h, d).to(q.dtype)


_DECODE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                    + [ctypes.c_longlong] * 10
                    + [ctypes.c_float, ctypes.c_void_p])


def flash_attention_decode_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, cache_len,
                                block_k: int = BLOCK_K,
                                n_splits: Optional[int] = None
                                ) -> torch.Tensor:
    """Launch the split kernel and, with more than one split, the merge
    kernel on PyTorch's current stream; raises on any tensor they do not
    take (unaligned K/V included) and on a refused launch."""
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention_decode_cuda: q, k, v must be "
                             "CUDA tensors on one device")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_decode_cuda: the last dim must "
                             "be contiguous")
    _check_16_bytes(k, "k", "flash_attention_decode_cuda")
    _check_16_bytes(v, "v", "flash_attention_decode_cuda")
    b, _, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    ns, sk, nh = decode_plan(b, s, h, kh, n_splits)
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device != q.device:
            raise ValueError("flash_attention_decode_cuda: a tensor "
                             "cache_len must lie on q's device")
        n_dev = _length(cache_len, q.device, torch.int32)  # a view if int32
        len_ptr, len_arg = n_dev.data_ptr(), 0
    else:
        n_dev, len_ptr, len_arg = None, None, max(0, min(int(cache_len), s))
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if ns > 1:        # every split writes its partial; the merge reads all
        part_acc = torch.empty((b, h, ns, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, h, ns, 2), dtype=torch.float32,
                              device=q.device)
    lib = _build.load("flash_decode")
    fn = lib.repro_flash_decode
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _DECODE_ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), len_ptr,
            len_arg, _DTYPE_CODE[q.dtype], q.device.index, b, s, h, kh, d,
            block_k, ns, sk, nh, q.stride(0), q.stride(2), k.stride(0),
            k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(2), math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention_decode", _DECODE_ERRORS)
    del n_dev, part_acc, part_ml   # freed in stream order, after the kernels
    return o
