"""Decoder-only transformer: dense, MoE and VLM families (counterpart of
``repro/models/transformer.py``).

* Parameters are stacked over layers (leading ``layers`` dim), as in the
  reference; a Python loop over the layer index takes the place of
  ``lax.scan``.  The stacked tensors are unbound once a forward, so a
  backward stacks the layers' gradients in one pass.
* ``cfg.remat`` wraps each layer's body when a gradient will be taken
  (``_remat``): ``none`` runs it plainly, ``full`` checkpoints it, ``dots``
  keeps only the outputs of plain matrix products and recomputes the rest.
* The same ``forward`` serves full-sequence scoring and prefill (returns
  the KV cache); ``decode`` runs one token against the cache.
* ``attn_impl="kernel"`` runs the flash-attention kernel and, at the
  residual seam between attention and FFN, the fused add+RMSNorm kernel;
  any other impl takes the plain path for both.
* ``attn_block`` and ``ffn_block`` are the two sub-blocks unfused, the
  form the pipeline's stages run (``dist/pipeline.py``, as the
  reference's).
* ``family="moe"`` swaps the FFN for ``models/moe.py``'s routed experts;
  a window (mixtral) makes the prefill ``attn_window_linear`` and the
  cache a ring of ``window`` slots.
* ``family="vlm"`` (internvl2) prepends the batch's stub patch embeddings
  ``patches`` (B, n_patches, D), projected by ``vision_proj``, to the
  token embeddings: positions, the attention's impl and the cache's
  ``len`` run over ``n_patches + S``; decode is the dense decode.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import torch_dtype
from repro_torch.dist.sharding import Decl
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig

FAMILIES = ("dense", "moe", "vlm")      # the families this module runs


# --- declarations ---------------------------------------------------------------

def layer_decls(cfg: ModelConfig, stacked: bool = True) -> Dict[str, Decl]:
    """One decoder layer; ``stacked`` prepends the layers dim."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pre = (cfg.n_layers,) if stacked else ()
    pax = ("layers",) if stacked else ()

    def decl(shape, axes, **kw):
        return Decl(pre + tuple(shape), pax + tuple(axes), **kw)

    out: Dict[str, Decl] = {
        "ln1": decl((d,), ("embed",), init="ones"),
        "ln2": decl((d,), ("embed",), init="ones"),
        "wq": decl((d, h, hd), ("embed", "heads", None), scale_dim=-3),
        "wk": decl((d, kv, hd), ("embed", "kv_heads", None), scale_dim=-3),
        "wv": decl((d, kv, hd), ("embed", "kv_heads", None), scale_dim=-3),
        "wo": decl((h, hd, d), ("heads", None, "embed"), scale_dim=-2),
    }
    if cfg.qkv_bias:
        out["bq"] = decl((h, hd), ("heads", None), init="zeros")
        out["bk"] = decl((kv, hd), ("kv_heads", None), init="zeros")
        out["bv"] = decl((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.family == "moe":
        out.update(moe_mod.moe_decls(cfg, pre, pax))
    elif cfg.ffn_act == "swiglu":
        out.update({
            "w_gate": decl((d, cfg.d_ff), ("embed", "ff"), scale_dim=-2),
            "w_up": decl((d, cfg.d_ff), ("embed", "ff"), scale_dim=-2),
            "w_down": decl((cfg.d_ff, d), ("ff", "embed"), scale_dim=-2),
        })
    else:
        out.update({
            "w_up": decl((d, cfg.d_ff), ("embed", "ff"), scale_dim=-2),
            "w_down": decl((cfg.d_ff, d), ("ff", "embed"), scale_dim=-2),
        })
    return out


def decls(cfg: ModelConfig) -> Dict[str, Any]:
    d = {
        "embed": Decl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="embed"),
        "ln_f": Decl((cfg.d_model,), ("embed",), init="ones"),
        "layers": layer_decls(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = Decl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            scale_dim=-2)
    if cfg.family == "vlm":
        d["vision_proj"] = Decl((cfg.d_model, cfg.d_model), ("embed", None),
                                scale_dim=-2)
    return d


# --- layer forward ---------------------------------------------------------------

def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    return o.reshape(*o.shape[:-2], h * k) @ w.reshape(h * k, d)


def _qkv(cfg: ModelConfig, p, x, positions):
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_delta(cfg: ModelConfig, p, x, positions, impl: str):
    """The attention sub-block's residual delta (un-added)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    o = L.attention(q, k, v, impl=impl, causal=True, window=cfg.window,
                    q_pos=positions, k_pos=positions,
                    block_remat=cfg.attn_block_remat)
    return _proj_out(o, p["wo"]), (k, v)


def attn_block(cfg: ModelConfig, p, x, positions, impl: str):
    delta, kv = attn_delta(cfg, p, x, positions, impl)
    return x + delta, kv


def _ffn(cfg: ModelConfig, p, h, experts=None):
    """FFN applied to an already-normed hidden state; ``experts`` the
    (lo, hi) range of experts ``p`` holds (a mesh position's, ``moe_ffn``)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(cfg, p, h, experts=experts)
    if cfg.ffn_act == "swiglu":
        return L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.ffn_act == "gelu":    # jax.nn.gelu's default is the tanh form
        act = lambda u: F.gelu(u, approximate="tanh")  # noqa: E731
    elif cfg.ffn_act == "relu2":
        act = lambda u: torch.square(F.relu(u))  # noqa: E731
    else:
        raise ValueError(f"unknown ffn_act {cfg.ffn_act!r}")
    return act(h @ p["w_up"]) @ p["w_down"]


def ffn_block(cfg: ModelConfig, p, x):
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h)


def decoder_block(cfg: ModelConfig, p, x, positions, impl: str):
    """Attention then FFN sub-blocks with the residual seam between them fused:
    the post-attention add and the FFN's pre-norm run as one kernel pass
    when ``impl == "kernel"``; identical math on the plain path."""
    delta, kv = attn_delta(cfg, p, x, positions, impl)
    h, x = L.rms_norm_residual(
        x, delta, p["ln2"], cfg.norm_eps,
        impl="kernel" if impl == "kernel" else "jnp")
    return x + _ffn(cfg, p, h), kv


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {name: w[i] for name, w in params["layers"].items()}


def _hidden(cfg: ModelConfig, params, x):
    """(final-normed hidden, head projection (D, V))."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x, head


def _head(cfg: ModelConfig, params, x):
    x, head = _hidden(cfg, params, x)
    return (x @ head.to(x.dtype)).float()


# the products ``dots_with_no_batch_dims_saveable`` keeps: 2-D matmuls
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``cfg.remat`` around one layer's body (the reference's ``_remat``
    around the scan body): ``none`` as is, ``dots`` a selective checkpoint
    that saves the outputs of matrix products without batch dims
    (``aten.mm``/``aten.addmm``; the model's projections) and recomputes
    the rest, any other mode a full checkpoint.  No op of a layer draws
    random numbers (the port has no dropout), so the checkpoint neither
    saves nor restores the RNG state (``preserve_rng_state=False``): that
    reads the CUDA generator on every call, which a CUDA graph capture
    (``train_step.make_graphed_train_step``) may refuse.  The model's other
    checkpoints (the chunked loss, ``block_remat``) do the same."""
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _needs_grad(params) -> bool:
    if not torch.is_grad_enabled():
        return False
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if t.requires_grad:
                return True
        else:
            stack.extend(t.values())
    return False


def embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings in the compute dtype.  ``F.embedding`` and not
    ``params["embed"][tokens]``: indexing takes its gradient by
    ``index_put_`` with accumulate, which on CUDA adds a repeated token's
    rows one after another (one token 4,096 times: 2.6 ms on an H100,
    against 0.14 ms for ``F.embedding``'s sorted segment sums,
    ``bench/block_fit.py``); the forward is the same gather."""
    return F.embedding(tokens, params["embed"]).to(torch_dtype(cfg.dtype))


# --- full-sequence forward (train / scoring / prefill) -----------------------------

def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            return_cache: bool = False, attn_impl: Optional[str] = None,
            return_hidden: bool = False):
    """Returns logits (B,S,V) and optionally the KV cache (ring for SWA);
    ``return_hidden`` returns (final-normed hidden (B,S,D), head (D,V))
    for the chunked loss instead of the logits."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    if cfg.family == "vlm":
        dt = torch_dtype(cfg.dtype)
        patches = batch["patches"].to(dt) @ params["vision_proj"]
        x = torch.cat([patches.to(dt), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    impl = attn_impl or L.pick_attn_impl(cfg.attn_impl, s, x.device)

    def body(x, lp):
        x, (k, v) = decoder_block(cfg, lp, x, positions, impl)
        if cfg.window and s > cfg.window:
            k, v = k[:, -cfg.window:], v[:, -cfg.window:]
        return (x, k, v) if return_cache else (x,)

    step = _remat(body, cfg.remat) if _needs_grad(params) else body
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, *kv = step(x, {name: w[i] for name, w in stacked.items()})
        if return_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    if return_hidden:
        return _hidden(cfg, params, x)
    logits = _head(cfg, params, x)
    if return_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": s}
        return logits, cache
    return logits


# --- decode ----------------------------------------------------------------------

def cache_decls(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Decl]:
    """KV cache stand-ins (SWA archs cap the cache at the window)."""
    s = min(max_len, cfg.window) if cfg.window else max_len
    kv, hd = cfg.n_kv_heads, cfg.hd
    shp = (cfg.n_layers, batch, s, kv, hd)
    axes = ("layers", None, "kv_seq", "kv_heads", None)
    return {"k": Decl(shp, axes, init="zeros"),
            "v": Decl(shp, axes, init="zeros"),
            "len": Decl((), (), init="zeros")}


def decode(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1). Returns (logits, cache).

    ``cache["len"]`` takes three forms:

    * a Python int: every row sits at the same position (the lockstep
      batch, run eagerly);
    * a 0-d integer tensor on the params' device: the same, with the
      position read on the device, so a CUDA graph can capture the step;
    * a (B,) integer tensor: per-row positions (continuous batching, the
      reference's per-row path), rows admitted at different times decode
      together, each masking its own context.

    Where the reference returns a new cache, the port writes the new K/V
    row into the cache tensors in place and returns them with ``len + 1``
    (an int for an int, else a new tensor).  An int is checked on the
    host, where a slot past the buffer raises instead of being clamped
    into it, and then moved to the device; with a tensor nothing is read
    on the host, so that check is the caller's (the servers' host
    bookkeeping).
    """
    n = cache["len"]
    x = embed(cfg, params, tokens)
    k_all, v_all = cache["k"], cache["v"]
    cache_size = k_all.shape[2]
    pos = n
    if not isinstance(n, torch.Tensor):
        if not cfg.window and n >= cache_size:
            raise IndexError(f"decode: position {n} is past the cache's "
                             f"{cache_size} slots")
        pos = torch.tensor(n, device=x.device)
    b = tokens.shape[0]
    # absolute positions for RoPE: (1,) lockstep, (B, 1) per row
    positions = pos.reshape(1) if pos.dim() == 0 else pos[:, None]
    # SWA: ring buffer; slot p % window holds position p
    slot = (pos % cache_size if cfg.window else pos).expand(b)
    rows = torch.arange(b, device=x.device)
    valid = torch.clamp(pos + 1, max=cache_size)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        # in place, at a device index: one row a batch row
        k_all[i].index_put_((rows, slot), k[:, 0].to(k_all.dtype))
        v_all[i].index_put_((rows, slot), v[:, 0].to(v_all.dtype))
        o = L.attn_decode(q, k_all[i], v_all[i], cache_len=valid, window=0)
        delta = _proj_out(o.to(x.dtype), lp["wo"])
        h, x = L.rms_norm_residual(x, delta, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h)
    return _head(cfg, params, x), {"k": k_all, "v": v_all, "len": n + 1}
