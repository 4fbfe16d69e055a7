"""The encoder-decoder family on a mesh: the sharded encoder and decoder
of ``models/encdec.py`` (counterpart of the reference's ``encdec.encode``
and ``forward`` under its ``mesh``), reached from ``dist/spmd.forward``
for ``family`` "encdec", and the one-token decode layer that
``dist/spmd_serve.decode`` steps.

The reference constrains only the decoder's input (the batch over its dp
axes, whole over 'model') and leaves the rest to GSPMD, which does not
change results.  The port lays each layer out as the dense one
(``spmd.Layout``, read from the ``decoder`` tree; the encoder's leaves
and the cross-attention's ``c_*`` are declared with the self-attention's
shapes and axes, so they lie alike):

* ``frame_proj`` (embed, None), ``enc_pos`` (None, embed) and ``ln_enc``
  are gathered whole where they are stored over 'data' (``spmd._local``)
  and applied to each position's batch block of ``frames``; ``enc_pos``
  is the one leaf with a leading replicated dim, added whole to every
  row;
* every attention (the encoder's, the decoder's causal self-attention
  with RoPE, the cross-attention of the position's rows against its own
  rows' encoder states) splits its query heads over 'model' where they
  divide it, a replicated ``wq``/``c_wq`` and ``wo``/``c_wo`` sliced a
  position (``spmd.layer_weights``); K/V heads follow ``wk``/``c_wk``,
  and where those are whole each position takes the heads its query
  heads read (``spmd._kv_heads``); ``wo``'s partial products are summed
  over 'model';
* the tanh-GELU FFN splits 'ff' over 'model', ``w_out``'s partial
  products summed there;
* the encoder states are split as the batch and whole over 'model': the
  cross-attention reads only the position's own rows;
* no fused seam: a plain ``rms_norm`` after each residual add, as the
  family runs; every attention is naive up to 2048 queries and chunked
  beyond (``encdec._NAIVE_MAX``), so the family launches no kernel;
* ``cfg.remat`` other than ``none`` checkpoints each encoder and decoder
  layer's whole lockstep body when a gradient is taken.

The logits are the tied embedding's (``spmd.head_logits``).  A prefill
keeps each decoder layer's self-attention K/V and cross-attention K/V per
position (``kept["kv"]``, ``kept["ckv"]``), sliced into the cache by
``spmd_serve.prefill_cache``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd, spmd_serve
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P
from repro_torch.launch import program_cost as pc
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MODEL = spmd.MODEL
Weights = List[Dict[str, torch.Tensor]]


def _sum_heads(mesh: Mesh, lay: spmd.Layout,
               part: List[torch.Tensor]) -> List[torch.Tensor]:
    """``wo``'s partial products summed over 'model' where the heads are
    split."""
    return pm.all_reduce_sum(part, mesh, MODEL) if lay.heads else part


def _mha(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, w: Weights,
         xq: List[torch.Tensor], xkv: List[torch.Tensor], *, causal: bool,
         q_pos: List[torch.Tensor], k_pos: List[torch.Tensor],
         prefix: str = "", rope_on: bool = True
         ) -> Tuple[List[torch.Tensor], list]:
    """``encdec._mha`` on every position: the output summed over 'model'
    (each position's (b, Sq, D)), and each position's (k, v) as its
    projection gave them (its K/V heads where ``wk`` is split)."""
    impl = "naive" if xq[0].shape[1] <= encdec._NAIVE_MAX else "chunked"
    part, kept = [], []
    for p in range(mesh.size):
        q = T._proj_in(xq[p], w[p][prefix + "wq"])
        k = T._proj_in(xkv[p], w[p][prefix + "wk"])
        v = T._proj_in(xkv[p], w[p][prefix + "wv"])
        if rope_on:
            q = L.rope(q, q_pos[p], cfg.rope_theta)
            k = L.rope(k, k_pos[p], cfg.rope_theta)
        kept.append((k, v))
        k, v = spmd._kv_heads(cfg, lay, mesh, p, k, v)
        o = L.attention(q, k, v, impl=impl, causal=causal, q_pos=q_pos[p],
                        k_pos=k_pos[p])
        part.append(T._proj_out(o, w[p][prefix + "wo"]))
    return _sum_heads(mesh, lay, part), kept


def _norm(cfg: ModelConfig, w: Weights, xs: List[torch.Tensor],
          name: str) -> List[torch.Tensor]:
    return [L.rms_norm(x, wp[name], cfg.norm_eps) for x, wp in zip(xs, w)]


def _ffn(mesh: Mesh, lay: spmd.Layout, w: Weights,
         hs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``encdec._ffn`` on every position, summed over 'model' where 'ff' is
    split."""
    part = [encdec._ffn(wp, h) for wp, h in zip(w, hs)]
    return pm.all_reduce_sum(part, mesh, MODEL) if lay.ff else part


def _add(xs: List[torch.Tensor], ds: List[torch.Tensor]
         ) -> List[torch.Tensor]:
    return [x + d for x, d in zip(xs, ds)]


def _ranges(mesh: Mesh, n: int) -> List[torch.Tensor]:
    """``arange(n)`` on each position's device (one tensor a device)."""
    devs = mesh.device_list
    made = {d: torch.arange(n, device=d) for d in set(devs)}
    return [made[d] for d in devs]


def _stacked(tree, mesh: Mesh, counts=None) -> Tuple[Dict[str, P], list]:
    """A stacked layer tree's per-layer specs and each position's layers
    (``spmd.layer_stacks``)."""
    specs = {name: P(*st.spec[1:]) for name, st in tree.items()}
    return specs, spmd.layer_stacks(mesh, tree, counts)


def encode(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, params,
           frames: List[torch.Tensor], grad: bool) -> List[torch.Tensor]:
    """``encdec.encode`` on every position's batch block of ``frames``:
    its encoder states (b_local, n_frames, D), whole over 'model'.
    ``grad``: a gradient will be taken (``cfg.remat`` applies)."""
    remat = grad and cfg.remat != "none"
    dt = torch_dtype(cfg.dtype)

    def whole(name):
        return spmd._local(mesh, params[name].spec, params[name].blocks)

    xs = [f.to(dt) @ w for f, w in zip(frames, whole("frame_proj"))]
    xs = [x + e[None].to(dt) for x, e in zip(xs, whole("enc_pos"))]
    fpos = _ranges(mesh, xs[0].shape[1])
    specs, stacked = _stacked(params["encoder"], mesh)

    def body(xs, lws):
        w = spmd.layer_weights(mesh, lay, specs, lws)
        hs = _norm(cfg, w, xs, "ln1")
        o, _ = _mha(cfg, mesh, lay, w, hs, hs, causal=False, q_pos=fpos,
                    k_pos=fpos, rope_on=False)
        xs = _add(xs, o)
        return _add(xs, _ffn(mesh, lay, w, _norm(cfg, w, xs, "ln2")))

    step = T._remat(body, "full") if remat else body
    xs = pc.loop("encoder_layers", cfg.n_encoder_layers,
                 lambda i, xs, lws, _: step(xs, lws), xs,
                 inputs=lambda i: spmd.layer_at(stacked, i), grad=grad,
                 retained=grad)
    return [L.rms_norm(x, w, cfg.norm_eps)
            for x, w in zip(xs, whole("ln_enc"))]


def run(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, params,
        xs: List[torch.Tensor], frames: List[torch.Tensor], grad: bool,
        kept: Optional[dict] = None) -> List[torch.Tensor]:
    """The encoder on ``frames``, then every decoder layer over every
    position in lockstep (``xs`` one embedded (b, S, D) a position);
    returns the decoder's output before ``ln_f``.  ``grad``: a gradient
    will be taken (``cfg.remat`` applies); ``kept`` (a prefill's) gets
    each layer's self-attention K/V in ``kept["kv"]`` and cross-attention
    K/V in ``kept["ckv"]``, one list a layer, one entry a position."""
    remat = grad and cfg.remat != "none"
    enc = encode(cfg, mesh, lay, params, frames, grad)
    tpos = _ranges(mesh, xs[0].shape[1])
    fpos = _ranges(mesh, enc[0].shape[1])
    apart = spmd.last_apart(mesh, lay, grad)
    specs, stacked = _stacked(params["decoder"], mesh,
                              spmd.apart_counts(cfg.n_layers, apart))

    def body(xs, lws, enc):
        w = spmd.layer_weights(mesh, lay, specs, lws)
        hs = _norm(cfg, w, xs, "ln1")
        o, kv = _mha(cfg, mesh, lay, w, hs, hs, causal=True, q_pos=tpos,
                     k_pos=tpos)
        xs = _add(xs, o)
        o, ckv = _mha(cfg, mesh, lay, w, _norm(cfg, w, xs, "lnc"), enc,
                      causal=False, q_pos=tpos, k_pos=fpos, prefix="c_",
                      rope_on=False)
        xs = _add(xs, o)
        xs = _add(xs, _ffn(mesh, lay, w, _norm(cfg, w, xs, "ln2")))
        if kept is not None:
            kept["kv"].append(kv)
            kept["ckv"].append(ckv)
        return xs

    step = T._remat(body, "full") if remat else body
    grow = () if kept is None else (kept["kv"], kept["ckv"])
    return pc.loop("layers", cfg.n_layers,
                   lambda i, xs, lws, enc: step(xs, lws, enc), xs,
                   inputs=lambda i: spmd.layer_at(stacked, i), shared=enc,
                   grow=grow, grad=grad, retained=grad, last_apart=apart)


def decode_layer(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, w: Weights,
                 xs: List[torch.Tensor], cache, i: int,
                 at: List[spmd_serve._Slots]
                 ) -> List[torch.Tensor]:
    """Decoder layer ``i``'s one-token step over every position
    (``encdec.decode``'s body on a mesh), ``w`` its weights a position
    (``spmd.layer_weights``), ``at`` the step's ``spmd_serve._slots``:
    the self-attention through ``spmd_serve.attn_decode_part`` (the new
    K/V row written in place into the block that owns its slot), then the
    (b, 1, H, hd) query against the position's ``ck``/``cv`` block over
    every frame (its K/V heads where the cache splits them over 'model',
    else the heads its query heads read), then the FFN."""
    part = spmd_serve.attn_decode_part(cfg, mesh, lay, w, xs, cache["k"],
                                       cache["v"], i, at)
    xs = _add(xs, _sum_heads(mesh, lay, part))
    ck, cv = cache["ck"], cache["cv"]
    split = spmd_serve._kv_mode(ck.spec) == "heads"
    part = []
    for p, (x, h) in enumerate(zip(xs, _norm(cfg, w, xs, "lnc"))):
        cq = T._proj_in(h, w[p]["c_wq"])
        k, v = ck.blocks[p][i], cv.blocks[p][i]
        if not split:
            k, v = spmd._kv_heads(cfg, lay, mesh, p, k, v)
        o = L.attn_decode(cq, k, v, cache_len=ck.shape[2])
        part.append(T._proj_out(o.to(x.dtype), w[p]["c_wo"]))
    xs = _add(xs, _sum_heads(mesh, lay, part))
    return _add(xs, _ffn(mesh, lay, w, _norm(cfg, w, xs, "ln2")))
