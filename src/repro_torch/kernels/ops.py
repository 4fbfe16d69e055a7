"""Public (B, S, H, D) wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper checks its
arguments once, then routes by where the tensors lie: CPU tensors take the
kernel's plain PyTorch version, CUDA tensors launch the CUDA kernel (which
raises if it cannot).  Nothing falls back from the card to the plain
version.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made,
so a run can show that its main path went through the kernels.  A CUDA
graph's replay launches what its capture recorded without calling a
wrapper: the graph's owner adds its capture's counts on every replay
(``train_step.make_graphed_train_step``).

``flash_attention`` and ``fused_add_rmsnorm`` are differentiable: when a
gradient will be taken (grad mode on and an input that requires one) they
run as ``torch.autograd.Function``s whose backward is a kernel too
(``flash_attention_bwd``, ``fused_add_rmsnorm_bwd``; the plain backward
on the CPU).  Inputs that need no gradient keep the forward-only path,
with no LSE buffer.

Block sizes: an int pins the tile (the kernel is built for a few tiles,
see ``check_args``); ``None`` takes the kernel's default tile, or, when
autotuning is on (``REPRO_KERNEL_AUTOTUNE=1``, ``autotune.enabled``) or
the block is ``"auto"``, the per-(op, shape, dtype, chip) winner from
``autotune.py``'s persistent cache, as the reference's wrappers do.
``flash_attention_decode`` has no tuner (nor has the reference): its
``"auto"`` takes the default tile.  A tune that misses the cache inside a
CUDA graph capture raises (``autotune.autotune``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import add as add_mod
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod

BlockArg = Union[int, str, None]

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0, "fused_add_rmsnorm": 0,
    "flash_attention_decode": 0, "rmsnorm": 0, "ssd_scan": 0, "add": 0,
    "flash_attention_bwd": 0, "fused_add_rmsnorm_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _tune(block: BlockArg) -> bool:
    return block == "auto" or (block is None and at.enabled())


def _block(arg: BlockArg, default: Optional[int], name: str
           ) -> Optional[int]:
    if arg is None or arg == "auto":
        return default
    if isinstance(arg, bool) or not isinstance(arg, int):
        raise TypeError(f"{name} must be None, 'auto' or an int, got "
                        f"{arg!r}")
    return arg


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA tensors; raises otherwise, so a
    tensor that is not on the CPU never reaches a plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel wrappers take CUDA tensors (the kernel) or "
                     f"CPU tensors (its plain version), got {sorted(kinds)}")


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: BlockArg = None,
                    block_k: BlockArg = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, K, D) with H % K == 0 -> (B, S, H, D).
    bf16 runs the tensor-core kernel, fp32 the CUDA-core one (``block_q``
    64 or 128 for either); None takes the kernel's default.
    Differentiable: see ``_FlashAttention``."""
    if _tune(block_q) or _tune(block_k):
        fa.check_args(q, k, v, fa.default_block_q(q.dtype), fa.BLOCK_K)
        cfg = at.tune_flash_attention(q, k, v, causal=causal)
        block_q, block_k = cfg["block_q"], cfg["block_k"]
    bq = _block(block_q, fa.default_block_q(q.dtype), "block_q")
    bk = _block(block_k, fa.BLOCK_K, "block_k")
    fa.check_args(q, k, v, bq, bk)
    cpu = _on_cpu(q, k, v)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, bq, bk, cpu)
    return _flash_fwd(q, k, v, causal, bq, bk, cpu, return_lse=False)


def _flash_fwd(q, k, v, causal, bq, bk, cpu, *, return_lse):
    if cpu:
        return fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk, return_lse=return_lse)
    out = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk, return_lse=return_lse)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from its inputs, the output's
    gradient dO and the forward's row LSE (B, H, Sq) fp32; one call counts
    one launch (of two kernels)."""
    if _on_cpu(q, k, v, do, lse):
        return fa.flash_attention_bwd_plain(q, k, v, do, lse, causal=causal)
    out = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)
    LAUNCHES["flash_attention_bwd"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward with the row LSE saved beside q, k and v (the backward needs
    no O); backward through ``flash_attention_bwd``.  CPU tensors take both
    plain versions, so the CPU tests run this same wiring."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk, cpu):
        o, lse = _flash_fwd(q, k, v, causal, bq, bk, cpu, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           cache_len: Union[int, torch.Tensor],
                           block_k: BlockArg = "auto",
                           n_splits: Optional[int] = None) -> torch.Tensor:
    """Decode-shaped attention: q: (B, 1, H, D); k, v: (B, S, K, D) caches;
    ``cache_len`` the (dynamic) valid prefix, an int or a 0-d integer
    tensor. -> (B, 1, H, D).  ``n_splits`` pins the split-K count (None:
    ``flash_attention.decode_splits``); ``block_k`` "auto" or None is the
    default tile (there is no decode tuner); one call counts one launch."""
    bk = _block(block_k, fa.BLOCK_K, "block_k")
    fa.check_decode_args(q, k, v, bk)
    if _on_cpu(q, k, v):
        return fa.flash_attention_decode_plain(q, k, v, cache_len=cache_len,
                                               block_k=bk, n_splits=n_splits)
    out = fa.flash_attention_decode_cuda(q, k, v, cache_len=cache_len,
                                         block_k=bk, n_splits=n_splits)
    LAUNCHES["flash_attention_decode"] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: BlockArg = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H); a: (H,); b, c: (B, S, N).
    Returns (y (B, S, H, P), final_state (B, H, P, N) fp32)."""
    if _tune(chunk):
        ssd_mod.check_args(x, dt, a, b, c, ssd_mod.CHUNK)
        chunk = at.tune_ssd_scan(x, dt, a, b, c)["chunk"]
    ck = _block(chunk, ssd_mod.CHUNK, "chunk")
    ssd_mod.check_args(x, dt, a, b, c, ck)
    return _ssd_scan(x, dt, a, b, c, ck)


def _ssd_scan(x, dt, a, b, c, ck):
    if _on_cpu(x, dt, a, b, c):
        return ssd_mod.ssd_scan_passes_plain(x, dt, a, b, c, chunk=ck)
    out = ssd_mod.ssd_scan_cuda(x, dt, a, b, c, chunk=ck)
    LAUNCHES["ssd_scan"] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            block_rows: BlockArg = None) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    if _tune(block_rows):
        rn.check_args(x, scale, rn.BLOCK_ROWS)
        block_rows = at.tune_rmsnorm(x, scale, eps=eps)["block_rows"]
    br = _block(block_rows, rn.BLOCK_ROWS, "block_rows")
    rn.check_args(x, scale, br)
    return _rmsnorm(x, scale, eps, br)


def _rmsnorm(x, scale, eps, br):
    if _on_cpu(x, scale):
        return rn.rmsnorm_plain(x, scale, eps=eps)
    out = rn.rmsnorm_cuda(x, scale, eps=eps, block_rows=br)
    LAUNCHES["rmsnorm"] += 1
    return out


def add(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y = x + r in the inputs' dtype (the unfused baseline's add pass)."""
    add_mod.check_args(x, r)
    if _on_cpu(x, r):
        return add_mod.add_plain(x, r)
    out = add_mod.add_cuda(x, r)
    LAUNCHES["add"] += 1
    return out


def fused_add_rmsnorm(x: torch.Tensor, res: torch.Tensor,
                      scale: torch.Tensor, *, eps: float = 1e-5,
                      block_rows: BlockArg = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (rmsnorm(x + res) * scale, x + res) in one pass.
    Differentiable: see ``_FusedAddRMSNorm``."""
    if _tune(block_rows):
        fused_mod.check_args(x, res, scale, fused_mod.BLOCK_ROWS)
        block_rows = at.tune_fused_add_rmsnorm(x, res, scale,
                                               eps=eps)["block_rows"]
    br = _block(block_rows, fused_mod.BLOCK_ROWS, "block_rows")
    fused_mod.check_args(x, res, scale, br)
    cpu = _on_cpu(x, res, scale)
    if _wants_grad(x, res, scale):
        return _FusedAddRMSNorm.apply(x, res, scale, eps, br, cpu)
    return _fused_fwd(x, res, scale, eps, br, cpu)


def _fused_fwd(x, res, scale, eps, br, cpu):
    if cpu:
        return fused_mod.fused_add_rmsnorm_plain(x, res, scale, eps=eps)
    out = fused_mod.fused_add_rmsnorm_cuda(x, res, scale, eps=eps,
                                           block_rows=br)
    LAUNCHES["fused_add_rmsnorm"] += 1
    return out


def fused_add_rmsnorm_bwd(dh: torch.Tensor, dy: torch.Tensor,
                          x: torch.Tensor, res: torch.Tensor,
                          scale: torch.Tensor, *, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dsum, dscale) of the fused add + RMSNorm from the gradients of its
    two outputs (h, y): dsum is the gradient of both x and res.  One call
    is one kernel launch (dscale's sum across blocks included)."""
    if _on_cpu(dh, dy, x, res, scale):
        return fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, res, scale,
                                                     eps=eps)
    out = fused_mod.fused_add_rmsnorm_bwd_cuda(dh, dy, x, res, scale,
                                               eps=eps)
    LAUNCHES["fused_add_rmsnorm_bwd"] += 1
    return out


class _FusedAddRMSNorm(torch.autograd.Function):
    """Forward saves x, res and scale (rstd is recomputed); backward
    through ``fused_add_rmsnorm_bwd``.  Autograd hands an unused output's
    gradient in as zeros."""

    @staticmethod
    def forward(ctx, x, res, scale, eps, br, cpu):
        h, y = _fused_fwd(x, res, scale, eps, br, cpu)
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        return h, y

    @staticmethod
    def backward(ctx, dh, dy):
        x, res, scale = ctx.saved_tensors
        dsum, dscale = fused_add_rmsnorm_bwd(dh.contiguous(), dy.contiguous(),
                                             x, res, scale, eps=ctx.eps)
        return dsum, dsum, dscale, None, None, None
