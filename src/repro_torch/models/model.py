"""Unified model API (counterpart of ``repro/models/model.py``): family
dispatch, init and the loss.

Every family module exposes the same surface:
    decls(cfg) -> nested dict of Decl
    forward(cfg, params, batch, *, return_cache, attn_impl, return_hidden)
    decode(cfg, params, cache, tokens)
(``forward`` and ``decode`` here also take the reference's ``mesh``).
    cache_decls(cfg, batch, max_len)   (or state_decls for ssm)
The dense, MoE and VLM families (``models/transformer.py``, as in the
reference), ssm (``models/mamba2.py``), hybrid (``models/hybrid.py``) and
encdec (``models/encdec.py``): every family of the catalog.  ``init`` and
``init_cache`` place their tensors on ``cuda`` unless the caller passes
another ``device``.  ``stub_inputs`` is the zero ``frames`` or
``patches`` that the server and the block profiler feed the stubbed
frontends, as the reference's do.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.dist import sharding as shd
from repro_torch.models import encdec, hybrid, mamba2, transformer
from repro_torch.models.config import ModelConfig

IGNORE_LABEL = -100


def masked_ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Masked next-token CE as sums: (nll_sum, n_tokens, n_correct).

    The single source of the loss math, shared by ``loss_fn`` and the
    chunked loss's body (fp32 log-softmax, IGNORE_LABEL masking).  Sum
    form so callers can accumulate before normalizing.
    """
    labels = labels.long()
    mask = labels != IGNORE_LABEL
    safe = torch.where(mask, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    correct = mask & (logits.argmax(-1) == labels)
    return (torch.where(mask, nll, 0.0).sum(), mask.sum(), correct.sum())


_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}
# the families whose loss takes ``cfg.logits_chunk`` (the reference's)
CHUNKED_LOSS_FAMILIES = ("dense", "moe", "vlm")


def get_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in _MODULES:
        raise NotImplementedError(f"unknown model family {cfg.family!r}")
    return _MODULES[cfg.family]


def stub_inputs(cfg: ModelConfig, batch: int, device
                ) -> Dict[str, torch.Tensor]:
    """The stubbed frontend's zero input for ``batch`` rows: ``frames``
    (B, n_frames, D) for encdec, ``patches`` (B, n_patches, D) for vlm,
    fp32; nothing for the other families."""
    shape = {"encdec": ("frames", cfg.n_frames),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.zeros((batch, n, cfg.d_model), dtype=torch.float32,
                              device=device)}


def decls(cfg: ModelConfig):
    return get_module(cfg).decls(cfg)


def init(cfg: ModelConfig, seed: int = 0, *, device: DeviceArg = None):
    """Seeded random weights in ``cfg.param_dtype``; the generator lives on
    the target device, so the numbers depend on the seed and the device
    type (not on JAX's PRNG: see ``repro_torch.bridge`` for shared weights)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return shd.init_from_decls(decls(cfg), gen, cfg.param_dtype, dev)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from declarations (validates cfg.total_params)."""
    total = 0
    for _, d in shd.iter_decls(decls(cfg)):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


def cache_decls(cfg: ModelConfig, batch: int, max_len: int):
    mod = get_module(cfg)
    if cfg.family == "ssm":
        return mamba2.state_decls(cfg, batch, max_len)
    return mod.cache_decls(cfg, batch, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               start_len: int = 0, *, device: DeviceArg = None, mesh=None):
    """Zeroed cache in ``cfg.dtype`` (every leaf, the SSM state too, as in
    the reference); ``len`` is a Python int.  ``mesh`` (a
    ``dist.mesh.Mesh``): each leaf a ``dist.placement.Sharded`` laid out
    by ``serve_step.cache_specs``, its blocks on the positions' devices
    (``device`` is not taken then), the decode buffer that
    ``kv_cache.grow_cache`` re-lays a sharded prefill's cache into."""
    dtype = torch_dtype(cfg.dtype)
    decls = cache_decls(cfg, batch, max_len)
    if mesh is not None:
        from repro_torch.dist import placement as pm
        from repro_torch.serve.serve_step import cache_specs
        specs = cache_specs(cfg, batch, max_len, mesh)
        c = {}
        for k, d in decls.items():
            if k == "len":
                continue
            spec = pm.check_spec(d.shape, specs[k], mesh)
            c[k] = pm.Sharded(tuple(d.shape), spec, mesh, [
                torch.zeros([s.stop - s.start for s in pm.block_slices(
                    d.shape, spec, mesh, p)], dtype=dtype, device=dev)
                for p, dev in enumerate(mesh.device_list)])
    else:
        dev = resolve_device(device)
        c = {k: torch.zeros(d.shape, dtype=dtype, device=dev)
             for k, d in decls.items() if k != "len"}
    c["len"] = int(start_len)
    return c


def forward(cfg: ModelConfig, params, batch, *, mesh=None,
            return_cache: bool = False, attn_impl=None,
            return_hidden: bool = False):
    """The family's forward.  ``mesh`` (a ``dist.mesh.Mesh``; ``params`` a
    tree of ``dist.placement.Sharded``): the sharded forward
    (``dist/spmd.py``); the logits come back as a ``Sharded`` (B, S, V)
    fp32, the vocab over 'model' where the layout splits it, and with
    ``return_cache`` the cache as ``Sharded`` leaves laid out by
    ``serve_step.cache_specs`` (``dist/spmd_serve.py``), with
    ``return_hidden`` the final-normed hidden (B, S, D) and the head (D,
    V) as ``Sharded`` (``spmd.hidden_sharded``)."""
    if mesh is not None:
        from repro_torch.dist import spmd
        if return_hidden:
            hidden, heads, lay = spmd.forward(
                cfg, params, batch, spmd.check_mesh(mesh), attn_impl,
                return_hidden=True)
            return spmd.hidden_sharded(mesh, lay, hidden, heads)
        out = spmd.forward(cfg, params, batch, spmd.check_mesh(mesh),
                           attn_impl, return_cache)
        logits = spmd.logits_sharded(mesh, out[1], out[0])
        return (logits, out[2]) if return_cache else logits
    kw = {}
    if return_hidden:        # transformer families only (chunked loss)
        kw["return_hidden"] = True
    return get_module(cfg).forward(cfg, params, batch,
                                   return_cache=return_cache,
                                   attn_impl=attn_impl, **kw)


def decode(cfg: ModelConfig, params, cache, tokens, *, mesh=None):
    """One decode step: (logits (B, 1, V), cache).  ``mesh``: the sharded
    step (``dist/spmd_serve.py``) on a cache of ``Sharded`` leaves, the
    logits a ``Sharded`` as ``forward``'s."""
    if mesh is not None:
        from repro_torch.dist import spmd, spmd_serve
        logits, lay, cache = spmd_serve.decode(cfg, params, cache, tokens,
                                               spmd.check_mesh(mesh))
        return spmd.logits_sharded(mesh, lay, logits), cache
    return get_module(cfg).decode(cfg, params, cache, tokens)


def loss_fn(cfg: ModelConfig, params, batch, *, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy; labels == IGNORE_LABEL are masked.

    ``cfg.logits_chunk > 0`` (transformer families): the (B, S, V) fp32
    logits tensor is never materialized, the head projection + softmax run
    in sequence chunks.
    ``mesh`` (a ``dist.mesh.Mesh``; ``params`` a tree of
    ``dist.placement.Sharded``): the sharded forward and loss over the
    global batch (``dist/spmd.py``), chunked there too
    (``spmd.chunked_ce_loss``).
    """
    if mesh is not None:
        from repro_torch.dist import spmd
        return spmd.loss_fn(cfg, params, batch, spmd.check_mesh(mesh))
    if cfg.logits_chunk and cfg.family in CHUNKED_LOSS_FAMILIES:
        return _chunked_loss(cfg, params, batch)
    logits = forward(cfg, params, batch)
    nll_sum, n_tok, n_corr = masked_ce_sums(logits, batch["labels"])
    denom = torch.clamp_min(n_tok, 1)
    loss = nll_sum / denom
    return loss, {"loss": loss, "tokens": n_tok, "accuracy": n_corr / denom}


def _chunk_sums(xi: torch.Tensor, head: torch.Tensor, li: torch.Tensor):
    logits = (xi @ head.to(xi.dtype)).float()
    return masked_ce_sums(logits, li)


def _chunked_loss(cfg: ModelConfig, params, batch):
    """Each chunk's logits run under ``torch.utils.checkpoint``: only the
    chunk's hidden rows are kept, and the backward recomputes the chunk's
    fp32 logits, so no (B, S, V) fp32 tensor is ever held (the
    reference's scan body, rematerialized)."""
    x, head = forward(cfg, params, batch, return_hidden=True)
    labels = batch["labels"]
    b, s, d = x.shape
    c = min(cfg.logits_chunk, s)
    if s % c:
        pad = c - s % c
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_LABEL)
        s += pad
    grad = torch.is_grad_enabled() and x.requires_grad
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_tok = n_corr = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, s, c):
        xi, li = x[:, i:i + c], labels[:, i:i + c]
        if grad:
            s_nll, s_tok, s_corr = checkpoint(_chunk_sums, xi, head, li,
                                              use_reentrant=False,
                                              preserve_rng_state=False)
        else:
            s_nll, s_tok, s_corr = _chunk_sums(xi, head, li)
        nll_sum = nll_sum + s_nll
        n_tok = n_tok + s_tok
        n_corr = n_corr + s_corr
    denom = torch.clamp_min(n_tok, 1)
    loss = nll_sum / denom
    return loss, {"loss": loss, "tokens": n_tok, "accuracy": n_corr / denom}
