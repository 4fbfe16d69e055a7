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
  kernel computes them, q tiles of 16 or 32 rows.

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
# default (wgmma: one or two 64-row warpgroups; cuda_core: 4 warps x 4 or 8)
BLOCK_Q_CHOICES = {"wgmma": (64, 128), "cuda_core": (16, 32)}
BLOCK_Q = {"wgmma": 128, "cuda_core": 32}
HEAD_DIMS = tuple(range(16, 129, 16))   # one kernel instantiation each
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPL_CODE = {None: 0, "cuda_core": 1}
_ERRORS = {-1: "dtype", -2: "block_q", -3: "head dim", -4: "block_k",
           -5: "impl"}
_MAX_GRID_YZ = 65535


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          block_q: Optional[int] = None,
                          block_k: int = BLOCK_K,
                          impl: Optional[str] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.
    ``block_q`` None takes the kernel's default tile; the ``"wgmma"``
    kernel's P enters P V as ``hi + lo``, each rounded to q's dtype (its
    sum l is taken before the split)."""
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
            if split_p:                         # exact in fp32: hi + lo
                hi = p.to(q.dtype).float()
                pv = hi + (p - hi).to(q.dtype).float()
            else:
                pv = p
            acc = acc * corr[..., None] + pv @ vf[:, :, k0:k0 + block_k]
            m = m_new
        out[:, :, q0:q0 + n] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
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
                         impl: Optional[str] = None) -> torch.Tensor:
    """Launch q's dtype's kernel (or, with ``impl="cuda_core"``, the
    CUDA-core one) on PyTorch's current stream; raises on any tensor it
    does not take (for the wgmma kernel, rows not on 16-byte boundaries)
    and on a refused launch."""
    kern = kernel_for(q.dtype, impl)
    block_q = block_q or BLOCK_Q[kern]
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
    if kern == "wgmma":                 # 16-byte cp.async copies
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_16_bytes(t, name, "flash_attention_cuda")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], _IMPL_CODE[impl], q.device.index, b, sq,
            sk, h, kh, d,
            block_q, block_k, *strides, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention", _ERRORS)
    return o


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
H100_SMS = 132
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
