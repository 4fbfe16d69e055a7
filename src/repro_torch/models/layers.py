"""Shared neural building blocks (counterpart of ``repro/models/layers.py``).

Attention implementations:

  naive    materializes the full (Sq, Sk) score matrix: fine for short seqs
  chunked  blockwise online softmax over KV chunks in plain PyTorch:
           O(Sq * block) live memory, the CPU default beyond 2048 tokens
  kernel   the flash-attention kernel in ``repro_torch.kernels`` (the CUDA
           kernel on the card, its plain version on the CPU), with a
           backward kernel when a gradient is taken

All softmax statistics are computed in float32 regardless of input dtype.
``attn_decode(impl="kernel")`` takes the decode kernel for a scalar
length and no window, as the reference's ``impl="pallas"`` does.
Sliding-window prefill past the window takes ``attn_window_linear`` (a
loop over query blocks, each against its ``window + q_block`` keys), as
the reference routes it; the kernel path routes a window there too.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import is_cuda_like
from repro_torch.kernels import ops as kops

NEG_INF = -1e30
_PAD_POS = 2**30          # position given to attn_chunked's KV padding


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale   # cast, then scale


def rms_norm_residual(res: torch.Tensor, delta: torch.Tensor,
                      scale: torch.Tensor, eps: float = 1e-5,
                      impl: str = "jnp") -> Tuple[torch.Tensor, torch.Tensor]:
    """``y = res + delta; h = rms_norm(y)`` -> (h, y).

    ``impl="kernel"`` takes both outputs from the fused kernel (the
    reference's ``impl="pallas"``, with that kernel's order of rounding);
    ``impl="jnp"`` is the plain path, named as in the reference.
    """
    if impl == "kernel":
        return kops.fused_add_rmsnorm(res, delta, scale, eps=eps)
    if impl != "jnp":
        raise ValueError(f"rms_norm_residual: unknown impl {impl!r}")
    y = res + delta
    return rms_norm(y, scale, eps), y


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]      # (S, half)
        ang = ang[None, :, None, :]                            # (1,S,1,half)
    else:
        ang = positions[..., None].float() * freqs             # (B,S,half)
        ang = ang[:, :, None, :]                               # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


# --- attention -----------------------------------------------------------------

def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,K,G,hd) grouping query heads over KV heads."""
    b, s, h, hd = q.shape
    if h % n_kv:
        raise ValueError(f"{h} query heads do not group over {n_kv} KV heads")
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int, kv_len: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) additive bias in f32."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, m)
    if window > 0:
        m = torch.where(q_pos[:, None] - k_pos[None, :] >= window, NEG_INF, m)
    if kv_len is not None:
        m = torch.where(k_pos[None, :] >= kv_len, NEG_INF, m)
    return m


def attn_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
               window: int = 0, kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    n_kv = k.shape[2]
    qg = _split_gqa(q, n_kv)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    s = s + _mask_bias(q_pos, k_pos, causal, window, kv_len)[None, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(b, sq, h, hd)


def attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
                 window: int = 0, kv_len: Optional[int] = None,
                 block: int = 1024, block_remat: bool = False) -> torch.Tensor:
    """Online softmax over KV chunks; numerically identical to attn_naive.
    A Python loop over the chunks takes the place of ``lax.scan``.
    ``block_remat``: each chunk's step runs under ``torch.utils.checkpoint``,
    so the backward recomputes the score and probability blocks instead of
    storing them (the reference's ``jax.checkpoint(step)``)."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    block = min(block, sk)
    pad = (-sk) % block
    if pad:                   # pad KV to a multiple of block (masked out)
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_PAD_POS)
        sk += pad
    qg = _split_gqa(q, n_kv)
    scale = 1.0 / math.sqrt(hd)
    g = h // n_kv

    def step(o, m, l, kc, vc, kpc):
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kc).float() * scale
        bias = _mask_bias(q_pos, kpc, causal, window, kv_len)
        if pad:   # the reference masks its pad only through causal/kv_len
            bias = torch.where(kpc[None, :] == _PAD_POS, NEG_INF, bias)
        s = s + bias[None, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(vc.dtype), vc)
        return o * corr[..., None] + pv.float(), m_new, l

    if block_remat and torch.is_grad_enabled():
        step = functools.partial(checkpoint, step, use_reentrant=False,
                                 preserve_rng_state=False)
    o = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block):
        o, m, l = step(o, m, l, k[:, start:start + block],
                       v[:, start:start + block], k_pos[start:start + block])
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attn_window_linear(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int, q_block: int = 512) -> torch.Tensor:
    """Causal sliding-window attention, linear in seq length.

    Loops over query blocks; each block attends to a slice of ``window +
    q_block`` keys ending at the block's last token, from K/V padded at the
    front so every slice is in bounds (the reference's scan).  Used for SWA
    prefill (mixtral) where full chunked attention would waste O(S^2)
    work.  ``s`` must be a multiple of ``q_block`` (or at most it).
    """
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    q_block = min(q_block, s)
    if s % q_block:
        raise ValueError(f"attn_window_linear: seq {s} is not a multiple of "
                         f"q_block {q_block}")
    span = window + q_block
    kp = F.pad(k, (0, 0, 0, 0, span, 0))
    vp = F.pad(v, (0, 0, 0, 0, span, 0))
    qg = _split_gqa(q, n_kv)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    out = []
    for i in range(s // q_block):
        qc = qg[:, i * q_block:(i + 1) * q_block]
        # q block [i*qb, (i+1)*qb) sees KV [(i+1)*qb - span, (i+1)*qb)
        start = (i + 1) * q_block                  # slice start in padded kv
        kc, vc = kp[:, start:start + span], vp[:, start:start + span]
        q_pos = i * q_block + torch.arange(q_block, device=dev)
        k_pos = start - span + torch.arange(span, device=dev)
        sc = torch.einsum("bqkgh,bskh->bkgqs", qc, kc).float() * scale
        bias = _mask_bias(q_pos, k_pos, True, window, None)
        bias = torch.where(k_pos[None, :] < 0, NEG_INF, bias)
        p = torch.softmax(sc + bias[None, None, None], dim=-1)
        out.append(torch.einsum("bkgqs,bskh->bqkgh", p.to(vc.dtype), vc))
    return torch.cat(out, 1).reshape(b, s, h, hd)


def attn_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, *,
                cache_len: Union[int, torch.Tensor], window: int = 0,
                impl: str = "naive") -> torch.Tensor:
    """Single-token decode. q: (B,1,H,hd); caches: (B,S,K,hd).

    ``cache_len`` may be a scalar (a Python int or a 0-d tensor: the
    lockstep batch, all rows at the same position) or a (B,) tensor
    (continuous batching: rows joined at different times, each masks its
    own context).  ``impl="kernel"`` with no window and a scalar length
    runs the decode kernel (``kops.flash_attention_decode``); a window or
    a (B,) length takes the plain path, as the reference's
    ``impl="pallas"`` does.
    """
    if impl not in ("naive", "kernel"):
        raise ValueError(f"attn_decode: unknown impl {impl!r}")
    per_row = isinstance(cache_len, torch.Tensor) and cache_len.dim() > 0
    if impl == "kernel" and window == 0 and not per_row:
        return kops.flash_attention_decode(q, k_cache, v_cache,
                                           cache_len=cache_len)
    b, _, h, hd = q.shape
    n_kv = k_cache.shape[2]
    qg = _split_gqa(q, n_kv)[:, 0]                      # (B,K,G,hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)[None]
    lens = cache_len.reshape(-1, 1) if isinstance(cache_len, torch.Tensor) \
        else cache_len                                  # (1,1), (B,1) or int
    mask = k_pos >= lens                                # (1,S) or (B,S)
    if window > 0:
        # ring buffer: valid positions are the last `window` written slots
        mask = mask | (k_pos < lens - window)
    s = torch.where(mask[:, None, None, :], NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def attention(q, k, v, *, impl: str = "chunked", causal: bool = True,
              window: int = 0, q_pos=None, k_pos=None,
              kv_len: Optional[int] = None, block: int = 1024,
              block_remat: bool = False) -> torch.Tensor:
    """Dispatch over implementations; q_pos/k_pos default to arange.
    ``block_remat`` checkpoints the chunked path's per-block step."""
    if q_pos is None:
        q_pos = torch.arange(q.shape[1], device=q.device)
    if k_pos is None:
        k_pos = torch.arange(k.shape[1], device=q.device)
    if impl == "kernel":
        # the kernel handles causal/non-causal and non-divisible (even
        # unequal) sequence lengths; window and explicit kv_len masking
        # route to the chunked path, as in the reference
        if window == 0 and kv_len is None and (
                not causal or q.shape[1] == k.shape[1]):
            return kops.flash_attention(q, k, v, causal=causal)
        impl = "chunked"
    if impl == "window" or (window > 0 and causal and q.shape[1] > window
                            and impl != "naive" and kv_len is None):
        return attn_window_linear(q, k, v, window=window)
    if impl == "naive":
        return attn_naive(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                          window=window, kv_len=kv_len)
    if impl != "chunked":
        raise ValueError(f"attention: unknown impl {impl!r}")
    return attn_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                        window=window, kv_len=kv_len, block=block,
                        block_remat=block_remat)


def pick_attn_impl(cfg_impl: str, seq_len: int,
                   device: Union[str, torch.device]) -> str:
    """Resolve ``attn_impl="auto"``: the kernel on CUDA (or a dry run's
    stand-in for it, ``device.is_cuda_like``), else naive for
    short sequences and the chunked online softmax beyond (full scores
    don't fit)."""
    if cfg_impl != "auto":
        return cfg_impl
    if is_cuda_like(device):
        return "kernel"
    return "naive" if seq_len <= 2048 else "chunked"
