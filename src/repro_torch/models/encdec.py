"""Whisper-style encoder-decoder transformer, audio backbone only
(counterpart of ``repro/models/encdec.py``).

The conv frontend is a stub: the batch carries precomputed frame
embeddings ``frames`` (B, n_frames, d_model).  The encoder is
bidirectional over the frames with a learned positional embedding; the
decoder is a causal LM with cross-attention into the encoder's output.

As in the reference: decoder self-attention takes RoPE (encoder and
cross-attention take none), the FFN is tanh-GELU, the norms are RMSNorm,
and the logits use the tied ``embed``.  Every attention (encoder,
self-attention, cross-attention) runs ``attn_naive`` when its query length
is at most 2048 and ``attn_chunked`` beyond, whatever ``attn_impl`` asks
for: the family launches no kernel, in the reference and here.  Past 2048
decoder tokens the cross-attention's chunked path masks its key padding
(the 1500 frames are not a multiple of its 1024 block), where the
reference's leaves the pad in the softmax (ROADMAP §3, fault R4).

``cfg.remat`` other than ``none`` checkpoints each encoder and decoder
layer's whole body when a gradient will be taken (``dots`` included, as
the reference's plain ``jax.checkpoint``).

The prefill cache is ``k``/``v`` (L, B, S, KV, hd), the rotated keys, and
``ck``/``cv`` (L, B, n_frames, KV, hd), the encoder's keys and values for
each decoder layer, constant after the prefill.  ``decode`` writes its K/V
row in place, as ``transformer.decode`` does, for a scalar ``len`` only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import Decl
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_NAIVE_MAX = 2048        # _mha's query length up to which attention is naive


def _attn_decls(cfg: ModelConfig, pre, pax, prefix=""):
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def decl(shape, axes, **kw):
        return Decl(pre + tuple(shape), pax + tuple(axes), **kw)

    return {
        prefix + "wq": decl((d, h, hd), ("embed", "heads", None),
                            scale_dim=-3),
        prefix + "wk": decl((d, kv, hd), ("embed", "kv_heads", None),
                            scale_dim=-3),
        prefix + "wv": decl((d, kv, hd), ("embed", "kv_heads", None),
                            scale_dim=-3),
        prefix + "wo": decl((h, hd, d), ("heads", None, "embed"),
                            scale_dim=-2),
    }


def _ffn_decls(cfg: ModelConfig, pre, pax):
    d, f = cfg.d_model, cfg.d_ff

    def decl(shape, axes, **kw):
        return Decl(pre + tuple(shape), pax + tuple(axes), **kw)

    return {
        "w_in": decl((d, f), ("embed", "ff"), scale_dim=-2),
        "w_out": decl((f, d), ("ff", "embed"), scale_dim=-2),
    }


def decls(cfg: ModelConfig) -> Dict:
    ne, nd = cfg.n_encoder_layers, cfg.n_layers
    enc = {"ln1": Decl((ne, cfg.d_model), ("layers", "embed"), init="ones"),
           "ln2": Decl((ne, cfg.d_model), ("layers", "embed"), init="ones")}
    enc.update(_attn_decls(cfg, (ne,), ("layers",)))
    enc.update(_ffn_decls(cfg, (ne,), ("layers",)))
    dec = {"ln1": Decl((nd, cfg.d_model), ("layers", "embed"), init="ones"),
           "lnc": Decl((nd, cfg.d_model), ("layers", "embed"), init="ones"),
           "ln2": Decl((nd, cfg.d_model), ("layers", "embed"), init="ones")}
    dec.update(_attn_decls(cfg, (nd,), ("layers",)))
    dec.update(_attn_decls(cfg, (nd,), ("layers",), prefix="c_"))
    dec.update(_ffn_decls(cfg, (nd,), ("layers",)))
    return {
        "embed": Decl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="embed"),
        "enc_pos": Decl((cfg.n_frames, cfg.d_model), (None, "embed"),
                        init="embed"),
        "frame_proj": Decl((cfg.d_model, cfg.d_model), ("embed", None),
                           scale_dim=-2),
        "ln_enc": Decl((cfg.d_model,), ("embed",), init="ones"),
        "ln_f": Decl((cfg.d_model,), ("embed",), init="ones"),
        "encoder": enc,
        "decoder": dec,
    }


def _gelu(u: torch.Tensor) -> torch.Tensor:
    return F.gelu(u, approximate="tanh")   # jax.nn.gelu's default form


def _ffn(p, h):
    return _gelu(h @ p["w_in"]) @ p["w_out"]


def _mha(cfg: ModelConfig, p, xq, xkv, *, causal, positions_q=None,
         positions_k=None, prefix="", rope_on=True):
    """(output (B, Sq, D), (k, v)): ``k`` rotated where ``rope_on``."""
    q = T._proj_in(xq, p[prefix + "wq"])
    k = T._proj_in(xkv, p[prefix + "wk"])
    v = T._proj_in(xkv, p[prefix + "wv"])
    if rope_on:
        q = L.rope(q, positions_q, cfg.rope_theta)
        k = L.rope(k, positions_k, cfg.rope_theta)
    impl = "naive" if xq.shape[1] <= _NAIVE_MAX else "chunked"
    o = L.attention(q, k, v, impl=impl, causal=causal, q_pos=positions_q,
                    k_pos=positions_k)
    return T._proj_out(o, p[prefix + "wo"]), (k, v)


def _stack_layers(tree, n: int):
    """The stacked tree's layers, each a dict of its slices."""
    stacked = {name: w.unbind(0) for name, w in tree.items()}
    return [{name: w[i] for name, w in stacked.items()} for i in range(n)]


def _step(cfg: ModelConfig, body, params):
    """``body`` under a full checkpoint when ``cfg.remat`` asks for one and
    a gradient will be taken (the reference's ``jax.checkpoint(body)``)."""
    if cfg.remat == "none" or not T._needs_grad(params):
        return body
    return T._remat(body, "full")


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder states."""
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt) @ params["frame_proj"]
    x = x + params["enc_pos"][None].to(dt)
    fpos = torch.arange(x.shape[1], device=x.device)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        o, _ = _mha(cfg, lp, h, h, causal=False, positions_q=fpos,
                    positions_k=fpos, rope_on=False)
        x = x + o
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + _ffn(lp, h)

    step = _step(cfg, body, params)
    for lp in _stack_layers(params["encoder"], cfg.n_encoder_layers):
        x = step(x, lp)
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["embed"].T.to(x.dtype)).float()


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            return_cache: bool = False, attn_impl: Optional[str] = None):
    """Logits (B, S, V) fp32 and, with ``return_cache``, the prefill cache
    (``len`` an int).  ``attn_impl`` is accepted and ignored, as in the
    reference (``_mha`` picks by length)."""
    enc = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = T.embed(cfg, params, tokens)
    tpos = torch.arange(s, device=x.device)
    fpos = torch.arange(enc.shape[1], device=x.device)

    def body(x, lp, enc):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        o, (k, v) = _mha(cfg, lp, h, h, causal=True, positions_q=tpos,
                         positions_k=tpos)
        x = x + o
        h = L.rms_norm(x, lp["lnc"], cfg.norm_eps)
        o, (ck, cv) = _mha(cfg, lp, h, enc, causal=False, positions_q=tpos,
                           positions_k=fpos, prefix="c_", rope_on=False)
        x = x + o
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(lp, h)
        return (x, k, v, ck, cv) if return_cache else (x,)

    step = _step(cfg, body, params)
    caches = []
    for lp in _stack_layers(params["decoder"], cfg.n_layers):
        x, *kv = step(x, lp, enc)
        caches.append(kv)
    logits = _logits(cfg, params, x)
    if return_cache:
        k, v, ck, cv = (torch.stack(t) for t in zip(*caches))
        return logits, {"k": k, "v": v, "ck": ck, "cv": cv, "len": s}
    return logits


def cache_decls(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Decl]:
    kv, hd, nd = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    return {
        "k": Decl((nd, batch, max_len, kv, hd),
                  ("layers", None, "kv_seq", "kv_heads", None), init="zeros"),
        "v": Decl((nd, batch, max_len, kv, hd),
                  ("layers", None, "kv_seq", "kv_heads", None), init="zeros"),
        "ck": Decl((nd, batch, cfg.n_frames, kv, hd),
                   ("layers", None, None, "kv_heads", None), init="zeros"),
        "cv": Decl((nd, batch, cfg.n_frames, kv, hd),
                   ("layers", None, None, "kv_heads", None), init="zeros"),
        "len": Decl((), (), init="zeros"),
    }


def decode(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1). Returns (logits, cache).

    ``cache["len"]`` is a Python int (checked on the host: a slot past the
    buffer raises) or a 0-d integer tensor on the params' device (read on
    the device, so a CUDA graph can capture the step).  A (B,) length
    raises ``ValueError``: the reference has only the lockstep path.  Each
    layer's K/V row is written into ``k``/``v`` in place; ``ck``/``cv`` are
    read whole (``n_frames`` valid keys)."""
    n = cache["len"]
    if isinstance(n, torch.Tensor) and n.dim() != 0:
        raise ValueError(f"encdec decode: len of shape {tuple(n.shape)}; "
                         f"the family decodes a lockstep batch (a scalar "
                         f"len) only")
    x = T.embed(cfg, params, tokens)
    k_all, v_all, ck, cv = cache["k"], cache["v"], cache["ck"], cache["cv"]
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
    n_frames = ck.shape[2]
    for i, lp in enumerate(_stack_layers(params["decoder"], cfg.n_layers)):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = L.rope(T._proj_in(h, lp["wq"]), positions, cfg.rope_theta)
        k = L.rope(T._proj_in(h, lp["wk"]), positions, cfg.rope_theta)
        v = T._proj_in(h, lp["wv"])
        k_all[i].index_put_((rows, slot), k[:, 0].to(k_all.dtype))
        v_all[i].index_put_((rows, slot), v[:, 0].to(v_all.dtype))
        o = L.attn_decode(q, k_all[i], v_all[i], cache_len=pos + 1)
        x = x + T._proj_out(o.to(x.dtype), lp["wo"])
        h = L.rms_norm(x, lp["lnc"], cfg.norm_eps)
        cq = T._proj_in(h, lp["c_wq"])
        o = L.attn_decode(cq, ck[i], cv[i], cache_len=n_frames)
        x = x + T._proj_out(o.to(x.dtype), lp["c_wo"])
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(lp, h)
    return _logits(cfg, params, x), {"k": k_all, "v": v_all, "ck": ck,
                                     "cv": cv, "len": n + 1}
