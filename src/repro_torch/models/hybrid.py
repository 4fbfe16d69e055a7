"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
(counterpart of ``repro/models/hybrid.py``).

The backbone is ``n_layers`` mamba2 layers; a single shared
(attention + FFN) block, one parameter set, is applied before every
``attn_every``-th group of backbone layers (arXiv:2411.15242; the released
model's LoRA projectors on the shared block are omitted, see the config's
docstring).  Autograd sums the shared block's gradient over its
``n_groups`` applications.

The shared block runs ``transformer.attn_block`` and ``ffn_block`` on a
dense view of the config (unfused norms, as in the reference), so its
prefill attention takes the flash-attention kernel on the card; its decode
attention is the plain ``attn_decode``, as the reference's.  The mamba
layers' SSD takes ``mamba2.pick_ssd_impl``'s route.

Decode state = per-layer SSM states + per-*application* KV caches
(n_groups of them: the shared block has distinct activations per
application even though its weights are shared).  A decode step writes
each application's K/V row into its cache in place, at a device slot, as
``transformer.decode`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.dist.sharding import Decl
from repro_torch.models import layers as L
from repro_torch.models import mamba2, transformer
from repro_torch.models.config import ModelConfig


def n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"hybrid: n_layers {cfg.n_layers} is not a multiple "
                         f"of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def _dense_view(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense")


def decls(cfg: ModelConfig) -> Dict:
    d = {
        "embed": Decl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="embed"),
        "ln_f": Decl((cfg.d_model,), ("embed",), init="ones"),
        "layers": mamba2.ssm_layer_decls(cfg),
        "shared_attn": transformer.layer_decls(_dense_view(cfg),
                                               stacked=False),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = Decl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            scale_dim=-2)
    return d


def cache_decls(cfg: ModelConfig, batch: int, max_len: int
                ) -> Dict[str, Decl]:
    ng = n_groups(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    st = mamba2.state_decls(cfg, batch)
    return {
        "k": Decl((ng, batch, max_len, kv, hd),
                  (None, None, "kv_seq", "kv_heads", None), init="zeros"),
        "v": Decl((ng, batch, max_len, kv, hd),
                  (None, None, "kv_seq", "kv_heads", None), init="zeros"),
        "ssm": st["ssm"],
        "conv": st["conv"],
        "len": Decl((), (), init="zeros"),
    }


def _shared_block(cfg: ModelConfig, params, x, positions, impl: str):
    """Shared attn+FFN application over the full sequence: (x, (k, v))."""
    dv = _dense_view(cfg)
    p = params["shared_attn"]
    x, kv = transformer.attn_block(dv, p, x, positions, impl)
    return transformer.ffn_block(dv, p, x), kv


def _shared_decode(cfg: ModelConfig, params, x, positions, k_all, v_all,
                   rows, slot, valid):
    """Shared attn+FFN application on one token: its K/V row written in
    place into ``k_all``/``v_all`` (B, S, KV, hd) at ``slot``, attention
    over the first ``valid`` slots."""
    dv = _dense_view(cfg)
    p = params["shared_attn"]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = transformer._qkv(dv, p, h, positions)
    k_all.index_put_((rows, slot), k[:, 0].to(k_all.dtype))
    v_all.index_put_((rows, slot), v[:, 0].to(v_all.dtype))
    o = L.attn_decode(q, k_all, v_all, cache_len=valid)
    x = x + transformer._proj_out(o.to(x.dtype), p["wo"])
    return transformer.ffn_block(dv, p, x)


def _group_layers(params, g: int, size: int):
    return {name: w[g * size:(g + 1) * size]
            for name, w in params["layers"].items()}


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            return_cache: bool = False, attn_impl: Optional[str] = None,
            ssd_impl: Optional[str] = None):
    """Logits (B,S,V) fp32 and, with ``return_cache``, the decode state
    (``k``/``v`` (n_groups, B, S, KV, hd), ``ssm`` fp32, ``conv``, ``len``
    an int).  ``attn_impl`` routes the shared block's attention as the
    transformer's; ``ssd_impl`` the SSD (``mamba2.pick_ssd_impl``)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = transformer.embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    impl = attn_impl or L.pick_attn_impl(cfg.attn_impl, s, x.device)
    grad = transformer._needs_grad(params)
    simpl = ssd_impl or mamba2.pick_ssd_impl(x.device, prefill=True,
                                             grad=grad)
    ae = cfg.attn_every
    ks, vs, ssms, convs = [], [], [], []
    for g in range(n_groups(cfg)):
        x, (k, v) = _shared_block(cfg, params, x, positions, impl)
        x, ssm, conv = mamba2.run_layers(
            cfg, _group_layers(params, g, ae), x, impl=simpl, grad=grad,
            return_state=return_cache)
        if return_cache:
            ks.append(k)
            vs.append(v)
            ssms += ssm
            convs += conv
    logits = transformer._head(cfg, params, x)
    if return_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "ssm": torch.stack(ssms), "conv": torch.stack(convs),
                        "len": s}
    return logits


def decode(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1). Returns (logits, cache).

    ``cache["len"]`` is a Python int (checked on the host: a slot past the
    buffer raises) or a 0-d integer tensor on the params' device (read on
    the device, so a CUDA graph can capture the step).  Each application's
    K/V row and the ``conv`` states are written in place; ``ssm`` as
    ``mamba2.decode_layer`` says; ``len + 1``."""
    n = cache["len"]
    x = transformer.embed(cfg, params, tokens)
    k_all, v_all = cache["k"], cache["v"]
    pos = n
    if not isinstance(n, torch.Tensor):
        if n >= k_all.shape[2]:
            raise IndexError(f"decode: position {n} is past the cache's "
                             f"{k_all.shape[2]} slots")
        pos = torch.tensor(n, device=x.device)
    b = tokens.shape[0]
    positions = pos.reshape(1)
    slot = pos.expand(b)
    rows = torch.arange(b, device=x.device)
    ssm, conv, new_ssm = cache["ssm"], cache["conv"], []
    ae = cfg.attn_every
    for g in range(n_groups(cfg)):
        x = _shared_decode(cfg, params, x, positions, k_all[g], v_all[g],
                           rows, slot, pos + 1)
        for i in range(g * ae, (g + 1) * ae):
            x = mamba2.decode_layer(cfg, params, i, x, ssm, conv, new_ssm)
    return transformer._head(cfg, params, x), {
        "k": k_all, "v": v_all,
        "ssm": torch.stack(new_ssm) if new_ssm else ssm, "conv": conv,
        "len": n + 1}
