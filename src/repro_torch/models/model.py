"""Unified model API (counterpart of ``repro/models/model.py``).

Every family module exposes the same surface:
    decls(cfg) -> nested dict of Decl
    forward(cfg, params, batch, *, return_cache, attn_impl)
    decode(cfg, params, cache, tokens)
    cache_decls(cfg, batch, max_len)
Only the dense family is ported; the others raise.  ``init`` and
``init_cache`` place their tensors on ``cuda`` unless the caller passes
another ``device``.
"""
from __future__ import annotations

from types import ModuleType

import torch

from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def get_module(cfg: ModelConfig) -> ModuleType:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense only)")
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
            attn_impl=None):
    return get_module(cfg).forward(cfg, params, batch,
                                   return_cache=return_cache,
                                   attn_impl=attn_impl)


def decode(cfg: ModelConfig, params, cache, tokens):
    return get_module(cfg).decode(cfg, params, cache, tokens)
