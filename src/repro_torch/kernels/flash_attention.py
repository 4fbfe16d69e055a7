"""Flash attention forward: the CUDA kernel's launcher and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas
``repro/kernels/flash_attention.py::_kernel``: FlashAttention-2 forward
with fp32 online softmax, q/k/v read as fp32 for both products, scores
scaled by 1/sqrt(d) after the product, a top-left aligned causal mask and
the KV tail past ``sk`` masked.  Both functions here take the model's
(B, S, H, D) layout and GQA (``H % KH == 0``) directly.

``flash_attention_plain`` repeats the kernel's block algorithm in PyTorch:
q tiles of ``block_q`` rows, a loop over ``block_k``-key tiles that stops
at the tile's causal limit, the same online-softmax update.  The CPU path
and the tests use it; on the card it is what the kernel is held against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q = 32                  # query rows per CUDA block (4 warps x 8 rows)
BLOCK_K = 64                  # keys per K/V tile staged in shared memory
BLOCK_Q_CHOICES = (16, 32)    # the tiles the kernel is compiled for
BLOCK_K_CHOICES = (64,)
HEAD_DIMS = (64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "block_q", -3: "head dim", -4: "block_k"}
_MAX_GRID_YZ = 65535


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int, block_k: int) -> None:
    """What the kernel takes; the plain version is held to the same rule so
    a shape that passes on the CPU also runs on the card."""
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
    if block_q not in BLOCK_Q_CHOICES or block_k not in BLOCK_K_CHOICES:
        raise ValueError(f"flash_attention: block_q={block_q}, "
                         f"block_k={block_k}; the kernel is built for "
                         f"block_q in {BLOCK_Q_CHOICES}, block_k in "
                         f"{BLOCK_K_CHOICES}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = BLOCK_Q,
                          block_k: int = BLOCK_K) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype."""
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
            acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + block_k]
            m = m_new
        out[:, :, q0:q0 + n] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_longlong] * 12
             + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = BLOCK_Q,
                         block_k: int = BLOCK_K) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
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
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    strides = [t.stride(i) for t in (q, k, v, o) for i in range(3)]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODE[q.dtype], q.device.index, b, sq, sk, h, kh, d,
            block_q, block_k, *strides, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention", _ERRORS)
    return o
