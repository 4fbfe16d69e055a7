"""Public (B, S, H, D) wrappers around the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  Each wrapper checks its
arguments once, then routes by where the tensors lie: CPU tensors take the
kernel's plain PyTorch version, CUDA tensors launch the CUDA kernel (which
raises if it cannot).  Nothing falls back from the card to the plain
version.  ``LAUNCHES`` counts, per wrapper, the kernel launches it made,
so a run can show that its main path went through the kernels.

Block sizes: ``None`` takes the kernel's default tile; an int pins it
(the kernel is built for a few tiles, see ``check_args``).  ``"auto"``
waits for the autotuner's port and raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import add as add_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod

BlockArg = Union[int, str, None]

LAUNCHES: Dict[str, int] = {
    "flash_attention": 0, "fused_add_rmsnorm": 0,
    "flash_attention_decode": 0, "rmsnorm": 0, "ssd_scan": 0, "add": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _block(arg: BlockArg, default: int, name: str) -> int:
    if arg is None:
        return default
    if arg == "auto":
        raise NotImplementedError(f"{name}='auto': the block autotuner is "
                                  "not ported yet; pass None or an int")
    if isinstance(arg, bool) or not isinstance(arg, int):
        raise TypeError(f"{name} must be None or an int, got {arg!r}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: BlockArg = None,
                    block_k: BlockArg = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, K, D) with H % K == 0 -> (B, S, H, D).
    bf16 runs the tensor-core kernel (``block_q`` 64 or 128), fp32 the
    CUDA-core one (16 or 32); None takes the kernel's default."""
    bq = _block(block_q, fa.default_block_q(q.dtype), "block_q")
    bk = _block(block_k, fa.BLOCK_K, "block_k")
    fa.check_args(q, k, v, bq, bk)
    if _on_cpu(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                        block_k=bk)
    out = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           cache_len: Union[int, torch.Tensor],
                           block_k: BlockArg = None,
                           n_splits: Optional[int] = None) -> torch.Tensor:
    """Decode-shaped attention: q: (B, 1, H, D); k, v: (B, S, K, D) caches;
    ``cache_len`` the (dynamic) valid prefix, an int or a 0-d integer
    tensor. -> (B, 1, H, D).  ``n_splits`` pins the split-K count (None:
    ``flash_attention.decode_splits``); one call counts one launch."""
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
    ck = _block(chunk, ssd_mod.CHUNK, "chunk")
    ssd_mod.check_args(x, dt, a, b, c, ck)
    if _on_cpu(x, dt, a, b, c):
        return ssd_mod.ssd_scan_plain(x, dt, a, b, c, chunk=ck)
    out = ssd_mod.ssd_scan_cuda(x, dt, a, b, c, chunk=ck)
    LAUNCHES["ssd_scan"] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            block_rows: BlockArg = None) -> torch.Tensor:
    """x: (..., d); scale: (d,)."""
    br = _block(block_rows, rn.BLOCK_ROWS, "block_rows")
    rn.check_args(x, scale, br)
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
    """Returns (rmsnorm(x + res) * scale, x + res) in one pass."""
    br = _block(block_rows, fused_mod.BLOCK_ROWS, "block_rows")
    fused_mod.check_args(x, res, scale, br)
    if _on_cpu(x, res, scale):
        return fused_mod.fused_add_rmsnorm_plain(x, res, scale, eps=eps)
    out = fused_mod.fused_add_rmsnorm_cuda(x, res, scale, eps=eps,
                                           block_rows=br)
    LAUNCHES["fused_add_rmsnorm"] += 1
    return out
