"""Unified model API (counterpart of ``repro/models/model.py``): family
dispatch, init and the loss.

Every family module exposes the same surface:
    decls(cfg) -> nested dict of Decl
    forward(cfg, params, batch, *, return_cache, attn_impl, return_hidden)
    decode(cfg, params, cache, tokens)
    cache_decls(cfg, batch, max_len)
The dense and MoE families are ported (both ``models/transformer.py``, as
in the reference); the others raise.  ``init`` and
``init_cache`` place their tensors on ``cuda`` unless the caller passes
another ``device``.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer
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


def get_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense and moe "
            f"only)")
    return transformer


def decls(cfg: ModelConfig):
    return get_module(cfg).decls(cfg)


def init(cfg: ModelConfig, seed: int = 0, *, device: DeviceArg = None):
    """Seeded random weights in ``cfg.param_dtype``; the generator lives on
    the target device, so the numbers depend on the seed and the device
    type (not on JAX's PRNG: see ``repro_torch.bridge`` for shared weights)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return shd.init_from_decls(decls(cfg), gen, cfg.param_dtype, dev)


def cache_decls(cfg: ModelConfig, batch: int, max_len: int):
    return get_module(cfg).cache_decls(cfg, batch, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               start_len: int = 0, *, device: DeviceArg = None):
    """Zeroed KV cache in ``cfg.dtype``; ``len`` is a Python int."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    c = {k: torch.zeros(d.shape, dtype=dtype, device=dev)
         for k, d in cache_decls(cfg, batch, max_len).items() if k != "len"}
    c["len"] = int(start_len)
    return c


def forward(cfg: ModelConfig, params, batch, *, return_cache: bool = False,
            attn_impl=None, return_hidden: bool = False):
    return get_module(cfg).forward(cfg, params, batch,
                                   return_cache=return_cache,
                                   attn_impl=attn_impl,
                                   return_hidden=return_hidden)


def decode(cfg: ModelConfig, params, cache, tokens):
    return get_module(cfg).decode(cfg, params, cache, tokens)


def loss_fn(cfg: ModelConfig, params, batch, *, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy; labels == IGNORE_LABEL are masked.

    ``cfg.logits_chunk > 0``: the (B, S, V) fp32 logits tensor is never
    materialized, the head projection + softmax run in sequence chunks.
    ``mesh`` (a ``dist.mesh.Mesh``; ``params`` a tree of
    ``dist.placement.Sharded``): the sharded forward and loss over the
    global batch (``dist/spmd.py``); the chunked loss raises there.
    """
    if mesh is not None:
        from repro_torch.dist import spmd
        return spmd.loss_fn(cfg, params, batch, spmd.check_mesh(mesh))
    if cfg.logits_chunk:
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
