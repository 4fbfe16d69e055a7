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
with no LSE buffer.  ``ssd_scan``, ``rmsnorm`` and ``add`` have no
backward (nor has the reference's kernel): where a gradient would be taken
they raise, on the CPU too, so no device can drop one silently (the
kernel fills a fresh buffer that autograd cannot see through).  Training
takes the differentiable forms (``mamba2.ssd_chunked``, ``layers.rms_norm``).

Block sizes: an int pins the tile (the kernel is built for a few tiles,
see ``check_args``); ``None`` takes the kernel's default tile, or, when
autotuning is on (``REPRO_KERNEL_AUTOTUNE=1``, ``autotune.enabled``) or
the block is ``"auto"``, the per-(op, shape, dtype, chip) winner from
``autotune.py``'s persistent cache, as the reference's wrappers do.
``flash_attention_decode`` has no tuner (nor has the reference): its
``"auto"`` takes the default tile.  A tune that misses the cache inside a
CUDA graph capture raises (``autotune.autotune``).

Fake tensors (``torch._subclasses.FakeTensor``, the dry run's stand-ins,
``launch/dryrun.py``) take a third route: the wrapper checks its
arguments, returns empty tensors of the kernel's output shapes, dtypes
and device (the LSE too where the differentiable form keeps it), counts
the call in ``FAKE_CALLS`` (never in ``LAUNCHES``) and hands every
function in ``FAKE_SINKS`` the kernel's FLOPs, bytes (``fake_cost``) and
device.  It launches nothing, computes nothing, tunes nothing
(``"auto"`` and ``REPRO_KERNEL_AUTOTUNE`` take the default tile) and
touches no module cache (built libraries, ticket counters, the tuner's
cache).  It is not a fallback: a real CUDA tensor still takes the kernel
or raises, and a CPU tensor its plain version.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.profiler.kernel_costs import op_flops_bytes
from repro_torch.device import dtype_name
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


# the fake route's calls, by wrapper, and the dry run's cost counters
FAKE_CALLS: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)
FAKE_SINKS: List[Callable[[str, float, float, torch.device], None]] = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_fake_calls() -> None:
    for name in FAKE_CALLS:
        FAKE_CALLS[name] = 0


def fake_cost(name: str, *tensors: torch.Tensor) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one call of wrapper ``name`` on these inputs:
    the forward kernels by the planner's formulas
    (``kernel_costs.op_flops_bytes``, causal attention halved, the LSE's
    fp32 write added), the two backward kernels by the same conventions
    (attention: five products of the forward's two, reading q, k, v, dO,
    the LSE, writing dQ, dK, dV; the fused norm: reading dh, dy, x, res
    and scale, writing dsum and dscale, ten operations an element)."""
    x = tensors[0]
    dt = dtype_name(x.dtype)
    es = x.element_size()
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, causal = tensors[0], tensors[1], tensors[-1]
        b, sq, h, d = q.shape
        bh, sk = b * h, k.shape[1]
        flops, nbytes = op_flops_bytes("flash_attention",
                                       (bh, sq, sk, d, int(causal)), dt)
        if name == "flash_attention":
            return flops, nbytes + 4.0 * bh * sq
        return 2.5 * flops, es * bh * d * (3 * sq + 4 * sk) + 4.0 * bh * sq
    if name == "flash_attention_decode":
        b, _, h, d = x.shape
        return op_flops_bytes("flash_decode", (b * h, tensors[1].shape[1], d),
                              dt)
    if name == "ssd_scan":
        bs, s, h, p = x.shape
        return op_flops_bytes("ssd_scan", (bs, s, h, p, tensors[3].shape[-1]),
                              dt)
    rows, d = x.numel() // max(x.shape[-1], 1), x.shape[-1]
    if name in ("rmsnorm", "fused_add_rmsnorm"):
        return op_flops_bytes(name, (rows, d), dt)
    if name == "fused_add_rmsnorm_bwd":
        return 10.0 * rows * d, es * (5 * rows * d + 2 * d)
    if name == "add":
        return float(rows * d), 3.0 * es * rows * d
    raise ValueError(f"fake_cost: unknown wrapper {name!r}")


def _fake_call(name: str, *tensors) -> None:
    FAKE_CALLS[name] += 1
    if FAKE_SINKS:
        flops, nbytes = fake_cost(name, *tensors)
        for sink in FAKE_SINKS:
            sink(name, flops, nbytes, tensors[0].device)


def _route(*tensors: torch.Tensor) -> str:
    """``"fake"`` where any input is a fake tensor, else ``"cpu"`` or
    ``"cuda"`` by ``_on_cpu``."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        return "fake"
    return "cpu" if _on_cpu(*tensors) else "cuda"


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


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"ops.{name}: the kernel has no backward, and a gradient would "
            f"be taken through it (grad mode on and an input that requires "
            f"one); call it under torch.no_grad() or take the "
            f"differentiable form")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: BlockArg = None,
                    block_k: BlockArg = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, Sk, K, D) with H % K == 0 -> (B, S, H, D).
    bf16 runs the tensor-core kernel, fp32 the CUDA-core one (``block_q``
    64 or 128 for either); None takes the kernel's default.
    Differentiable: see ``_FlashAttention``."""
    route = _route(q, k, v)
    if route != "fake" and (_tune(block_q) or _tune(block_k)):
        fa.check_args(q, k, v, fa.default_block_q(q.dtype), fa.BLOCK_K)
        cfg = at.tune_flash_attention(q, k, v, causal=causal)
        block_q, block_k = cfg["block_q"], cfg["block_k"]
    bq = _block(block_q, fa.default_block_q(q.dtype), "block_q")
    bk = _block(block_k, fa.BLOCK_K, "block_k")
    fa.check_args(q, k, v, bq, bk)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, bq, bk, route)
    return _flash_fwd(q, k, v, causal, bq, bk, route, return_lse=False)


def _flash_fwd(q, k, v, causal, bq, bk, route, *, return_lse):
    if route == "fake":
        _fake_call("flash_attention", q, k, v, causal)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        if not return_lse:
            return o
        b, sq, h, _ = q.shape
        return o, q.new_empty((b, h, sq), dtype=torch.float32)
    if route == "cpu":
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
    route = _route(q, k, v, do, lse)
    if route == "fake":
        _fake_call("flash_attention_bwd", q, k, v, causal)
        return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                     for t in (q, k, v))
    if route == "cpu":
        return fa.flash_attention_bwd_plain(q, k, v, do, lse, causal=causal)
    out = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal)
    LAUNCHES["flash_attention_bwd"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward with the row LSE saved beside q, k and v (the backward needs
    no O); backward through ``flash_attention_bwd``.  CPU tensors take both
    plain versions, so the CPU tests run this same wiring; fake tensors
    both fake routes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bq, bk, route):
        o, lse = _flash_fwd(q, k, v, causal, bq, bk, route, return_lse=True)
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
    route = _route(q, k, v)
    if route == "fake":
        _fake_call("flash_attention_decode", q, k)
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == "cpu":
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
    Returns (y (B, S, H, P), final_state (B, H, P, N) fp32).  Forward
    only: raises where a gradient would be taken."""
    _refuse_grad("ssd_scan", x, dt, a, b, c)
    if _tune(chunk) and _route(x, dt, a, b, c) != "fake":
        ssd_mod.check_args(x, dt, a, b, c, ssd_mod.CHUNK)
        chunk = at.tune_ssd_scan(x, dt, a, b, c)["chunk"]
    ck = _block(chunk, ssd_mod.CHUNK, "chunk")
    ssd_mod.check_args(x, dt, a, b, c, ck)
    return _ssd_scan(x, dt, a, b, c, ck)


def _ssd_scan(x, dt, a, b, c, ck):
    route = _route(x, dt, a, b, c)
    if route == "fake":
        _fake_call("ssd_scan", x, dt, a, b)
        bs, _, h, p = x.shape
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                x.new_empty((bs, h, p, b.shape[-1]), dtype=torch.float32))
    if route == "cpu":
        return ssd_mod.ssd_scan_passes_plain(x, dt, a, b, c, chunk=ck)
    out = ssd_mod.ssd_scan_cuda(x, dt, a, b, c, chunk=ck)
    LAUNCHES["ssd_scan"] += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            block_rows: BlockArg = None) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Forward only: raises where a gradient
    would be taken."""
    _refuse_grad("rmsnorm", x, scale)
    if _tune(block_rows) and _route(x, scale) != "fake":
        rn.check_args(x, scale, rn.BLOCK_ROWS)
        block_rows = at.tune_rmsnorm(x, scale, eps=eps)["block_rows"]
    br = _block(block_rows, rn.BLOCK_ROWS, "block_rows")
    rn.check_args(x, scale, br)
    return _rmsnorm(x, scale, eps, br)


def _rmsnorm(x, scale, eps, br):
    route = _route(x, scale)
    if route == "fake":
        _fake_call("rmsnorm", x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if route == "cpu":
        return rn.rmsnorm_plain(x, scale, eps=eps)
    out = rn.rmsnorm_cuda(x, scale, eps=eps, block_rows=br)
    LAUNCHES["rmsnorm"] += 1
    return out


def add(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """y = x + r in the inputs' dtype (the unfused baseline's add pass).
    Forward only: raises where a gradient would be taken."""
    _refuse_grad("add", x, r)
    add_mod.check_args(x, r)
    route = _route(x, r)
    if route == "fake":
        _fake_call("add", x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    if route == "cpu":
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
    route = _route(x, res, scale)
    if _tune(block_rows) and route != "fake":
        fused_mod.check_args(x, res, scale, fused_mod.BLOCK_ROWS)
        block_rows = at.tune_fused_add_rmsnorm(x, res, scale,
                                               eps=eps)["block_rows"]
    br = _block(block_rows, fused_mod.BLOCK_ROWS, "block_rows")
    fused_mod.check_args(x, res, scale, br)
    if _wants_grad(x, res, scale):
        return _FusedAddRMSNorm.apply(x, res, scale, eps, br, route)
    return _fused_fwd(x, res, scale, eps, br, route)


def _fused_fwd(x, res, scale, eps, br, route):
    if route == "fake":
        _fake_call("fused_add_rmsnorm", x)
        return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                     for _ in range(2))
    if route == "cpu":
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
    route = _route(dh, dy, x, res, scale)
    if route == "fake":
        _fake_call("fused_add_rmsnorm_bwd", x)
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.empty_like(scale))
    if route == "cpu":
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
    def forward(ctx, x, res, scale, eps, br, route):
        h, y = _fused_fwd(x, res, scale, eps, br, route)
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        return h, y

    @staticmethod
    def backward(ctx, dh, dy):
        x, res, scale = ctx.saved_tensors
        dsum, dscale = fused_add_rmsnorm_bwd(dh.contiguous(), dy.contiguous(),
                                             x, res, scale, eps=ctx.eps)
        return dsum, dsum, dscale, None, None, None
