"""The sharded forward and loss on a mesh (counterpart of the ``mesh``
argument the reference threads through ``transformer.forward`` and
``model.loss_fn``), reached from ``models.model.loss_fn(..., mesh=...)``.

One process runs every position of the mesh in lockstep: each layer runs
the positions in turn, each on its own device from its own blocks
(``placement.Sharded``), with the model's own pieces (``_proj_in``,
``_proj_out``, ``L.rope``, ``L.attention``, ``L.rms_norm_residual``, the
FFN's products).  Between them, the collectives that XLA inserts for the
reference:

* a dim of a weight sharded over 'data' (``fsdp_tp``'s 'embed') is
  ``all_gather``ed before use, a layer at a time;
* a product whose contraction dim is sharded over 'model' (``wo`` over
  heads, ``w_down`` over 'ff', the vocab-parallel embedding lookup) is
  followed by ``all_reduce_sum`` over 'model';
* a dim that is replicated needs neither: its work is computed on every
  position, as GSPMD computes it;
* the MoE FFN (``_moe_part``): experts over 'model' (expert parallel) or
  ``e_ff`` over 'model' (tensor parallel inside each expert), the 'model'
  group summing either way; the global dispatch routes the whole batch at
  every position (gathered over 'data'), so capacity and drops are the
  one-device step's;
* the state-space families' Mamba-2 layers and the hybrid's shared block
  (``dist/spmd_ssm.py``): the SSD heads over 'model' where it divides
  them;
* the encoder-decoder's encoder, self- and cross-attention and FFN
  (``dist/spmd_encdec.py``): the heads and 'ff' over 'model' as the
  dense layer's;
* a vlm's stub patches, projected by ``vision_proj`` on each position's
  batch block and prepended to its text before the dense stack.

Every family of the catalog runs on any mesh.

Activations are laid out as the reference constrains them, by
``sharding.sanitize`` of its hints: the batch over ``batch_spec``'s dp
axes, the query heads over 'model' where they divide it (a replicated
``wq`` is then sliced a position), the logits' vocab over 'model' where
it divides (the loss is then vocab-parallel: the max, the sum of exps and
the label's logit from the position that owns it).  K/V heads follow
``wk``: where they are replicated while the query heads are sharded, each
position takes the K/V heads its query heads read.

The loss is counted once: ``masked_ce_sums``' sums over the global batch
(every dp position's shard, once), from the positions at index 0 of every
axis the batch is not sharded over.  Autograd through this one graph
gives each copy of a replicated block its own path's gradient; the
train step sums them (``placement.replica_group_sum``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P, batch_spec, sanitize
from repro_torch.launch import program_cost as pc
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (CHUNKED_LOSS_FAMILIES, IGNORE_LABEL,
                                      masked_ce_sums)

MODEL = "model"
SSM_FAMILIES = ("ssm", "hybrid")        # their layers: dist/spmd_ssm.py


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.dist.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a forward lays its activations out on ``mesh``."""
    tp: int                     # size of 'model' (1 without it)
    batch: Tuple[str, ...]      # axes the batch dim is split over
    heads: bool                 # query heads (wq, bq, wo) over 'model'
    kv: bool                    # K/V heads (wk, wv, bk, bv) over 'model'
    ff: bool                    # the FFN's hidden dim (or e_ff) over 'model'
    experts: bool               # the MoE experts over 'model'
    vocab_embed: bool           # the lookup's table rows over 'model'
    vocab_logits: bool          # the logits' vocab over 'model'
    ssm_heads: bool             # the Mamba-2 layers' SSD heads over 'model'


def layout(cfg: ModelConfig, params, mesh: Mesh, batch: int,
           seq: int) -> Layout:
    """The attention and FFN fields read the decoder layers (encdec's
    ``decoder``, whose encoder and cross-attention leaves are laid out as
    its self-attention's), or the hybrid's unstacked ``shared_attn`` (all
    False for ``ssm``); ``seq`` counts a vlm's patches.  ``ssm_heads``
    holds where 'model' divides the SSD heads and ``gate_ln`` is stored
    over it (``dist/spmd_ssm.py``)."""
    sizes = dict(mesh.shape)
    tp = sizes.get(MODEL, 1)
    b = batch_spec(mesh, batch)[0]
    logits = sanitize((batch, seq, cfg.vocab_size),
                      batch_spec(mesh, batch, None, MODEL), sizes)
    attn = {"heads": False, "kv": False, "ff": False, "experts": False}
    if cfg.family != "ssm":
        q = sanitize((batch, seq, cfg.n_heads, cfg.hd),
                     batch_spec(mesh, batch, None, MODEL, None), sizes)
        hyb = cfg.family == "hybrid"
        layers = params[{"hybrid": "shared_attn",
                         "encdec": "decoder"}.get(cfg.family, "layers")]
        at = 0 if hyb else 1            # the stacked tree's layer dim
        moe = cfg.family == "moe"
        # (experts, embed, e_ff) or (embed, ff), after any layer dim
        ff = layers["we_up"].spec[at + 2] if moe else layers[
            "w_in" if cfg.family == "encdec" else "w_up"].spec[at + 1]
        attn = dict(heads=q[2] == MODEL,
                    kv=layers["wk"].spec[at + 1] == MODEL, ff=ff == MODEL,
                    experts=moe and layers["we_up"].spec[at] == MODEL)
    ssm = cfg.family in SSM_FAMILIES and \
        params["layers"]["gate_ln"].spec[1] == MODEL and \
        cfg.ssm_nheads % tp == 0
    # a 'model' axis of one position splits nothing (as GSPMD partitions
    # nothing over it): the lookup and the loss are the one-device ones
    vocab = tp > 1 and "embed" in params and params["embed"].spec[0] == MODEL
    return Layout(
        tp=tp, batch=pm.part_axes(b), **attn, vocab_embed=vocab,
        vocab_logits=tp > 1 and logits[2] == MODEL, ssm_heads=ssm)


def _model_index(mesh: Mesh, pos: int) -> int:
    return mesh.coords(pos).get(MODEL, 0)


def _local(mesh: Mesh, spec: Sequence, blocks: List[torch.Tensor],
           split: Sequence[int] = ()) -> List[torch.Tensor]:
    """A weight's blocks as the positions compute with them: every dim
    sharded over an axis other than 'model' gathered whole, and each dim
    in ``split`` that is not stored over 'model' sliced to the position's
    part of it (a replicated ``wq`` when the heads are sharded)."""
    for dim, part in enumerate(spec):
        names = pm.part_axes(part)
        other = tuple(n for n in names if n != MODEL)
        if other and MODEL in names:
            raise NotImplementedError(f"a weight dim over {names}")
        if other:
            blocks = pm.all_gather(blocks, mesh, other, dim)
    tp = mesh.shape.get(MODEL, 1)
    for dim in split:
        if spec[dim] != MODEL and tp > 1:
            out = []
            for p, w in enumerate(blocks):
                n = w.shape[dim] // tp
                out.append(w.narrow(dim, _model_index(mesh, p) * n, n))
            blocks = out
    return blocks


def _kv_heads(cfg: ModelConfig, lay: Layout, mesh: Mesh, pos: int,
              k: torch.Tensor, v: torch.Tensor):
    """The K/V heads position ``pos``'s query heads read, where the query
    heads are sharded and K/V are whole: a slice where each group of
    query heads sharing a K/V head lies on one position, else the K/V
    head of each local query head (one K/V head a query head)."""
    if not lay.heads or lay.kv or lay.tp == 1:
        return k, v
    n = cfg.n_heads // lay.tp
    g = cfg.n_heads // cfg.n_kv_heads
    a = _model_index(mesh, pos) * n
    if n % g == 0:
        return k[:, :, a // g:(a + n) // g], v[:, :, a // g:(a + n) // g]
    if g % n == 0:
        return k[:, :, a // g:a // g + 1], v[:, :, a // g:a // g + 1]
    idx = torch.arange(a, a + n, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def layer_weights(mesh: Mesh, lay: Layout, specs: Dict[str, P],
                  lws: List[Dict[str, torch.Tensor]]
                  ) -> List[Dict[str, torch.Tensor]]:
    """One layer's blocks as each position computes with them
    (``_local``): a replicated ``wq``, ``bq`` and ``wo`` (and encdec's
    cross-attention ``c_wq`` and ``c_wo``) sliced to the position's query
    heads where the heads are sharded."""
    split = {"wq": (1,), "bq": (0,), "wo": (0,), "c_wq": (1,),
             "c_wo": (0,)} if lay.heads else {}
    w: List[Dict[str, torch.Tensor]] = [dict() for _ in range(mesh.size)]
    for name, spec in specs.items():
        blocks = _local(mesh, spec, [lw[name] for lw in lws],
                        split.get(name, ()))
        for p in range(mesh.size):
            w[p][name] = blocks[p]
    return w


def ffn_half(cfg: ModelConfig, mesh: Mesh, lay: Layout,
             w: List[Dict[str, torch.Tensor]], xs: List[torch.Tensor],
             part: List[torch.Tensor], impl: str, fused: bool
             ) -> List[torch.Tensor]:
    """The layer after attention: ``part`` each position's attention
    output projected by its ``wo`` block (summed over 'model' here where
    the heads are split), the residual seam, the FFN (dense or MoE) and its
    sum over 'model' where 'ff' or the experts are split."""
    delta = pm.all_reduce_sum(part, mesh, MODEL) if lay.heads else part
    ys, hs, part = [], [], []
    for p in range(mesh.size):
        if fused:
            h, y = L.rms_norm_residual(
                xs[p], delta[p], w[p]["ln2"], cfg.norm_eps,
                impl="kernel" if impl == "kernel" else "jnp")
        else:
            y = xs[p] + delta[p]
            h = L.rms_norm(y, w[p]["ln2"], cfg.norm_eps)
        hs.append(h)
        ys.append(y)
        if cfg.family != "moe":
            part.append(T._ffn(cfg, w[p], h))
    if cfg.family == "moe":
        part = _moe_part(cfg, mesh, lay, w, hs)
    ffn = pm.all_reduce_sum(part, mesh, MODEL) \
        if lay.ff or lay.experts else part
    return [y + f for y, f in zip(ys, ffn)]


def _layer_fn(cfg: ModelConfig, mesh: Mesh, lay: Layout, specs: Dict[str, P],
              positions: List[torch.Tensor], impl: str, fused: bool = True,
              kv_out: Optional[list] = None):
    """One decoder layer over every position (the lockstep body that
    ``cfg.remat`` checkpoints): ``xs`` one (b, S, D) residual a position,
    ``lws`` one dict of this layer's blocks a position; ``positions`` the
    RoPE positions on each position's device.  ``fused`` runs the seam as
    ``decoder_block`` does (``rms_norm_residual``); False as
    ``attn_block`` then ``ffn_block`` (the residual add, then a plain
    ``rms_norm``), the pipeline stage's body.  ``kv_out`` (a prefill's;
    never under a gradient) gets one list a call: each position's (k, v)
    as its projection gave them, the K/V heads ``kv_heads_held`` names."""
    n = mesh.size

    def body(xs, lws):
        w = layer_weights(mesh, lay, specs, lws)
        part, kept = [], []
        for p in range(n):
            h = L.rms_norm(xs[p], w[p]["ln1"], cfg.norm_eps)
            q, k, v = T._qkv(cfg, w[p], h, positions[p])
            kept.append((k, v))
            k, v = _kv_heads(cfg, lay, mesh, p, k, v)
            o = L.attention(q, k, v, impl=impl, causal=True,
                            window=cfg.window, q_pos=positions[p],
                            k_pos=positions[p],
                            block_remat=cfg.attn_block_remat)
            part.append(T._proj_out(o, w[p]["wo"]))
        if kv_out is not None:
            kv_out.append(kept)
        return ffn_half(cfg, mesh, lay, w, xs, part, impl, fused)

    return body


def kv_heads_held(cfg: ModelConfig, lay: Layout, mesh: Mesh,
                  pos: int) -> Tuple[int, int]:
    """The K/V heads [lo, hi) a position's K/V projection computes: its
    block where ``wk`` is stored over 'model', else all of them."""
    if not lay.kv:
        return 0, cfg.n_kv_heads
    n = cfg.n_kv_heads // lay.tp
    a = _model_index(mesh, pos)
    return a * n, (a + 1) * n


def _moe_part(cfg: ModelConfig, mesh: Mesh, lay: Layout,
              w: List[Dict[str, torch.Tensor]], hs: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Each position's part of the MoE FFN of its normed hidden ``hs[p]``,
    summed over 'model' by the caller where the experts or ``e_ff`` are
    split there (``models/moe.py``).  The routing equals the one-device
    routing: the global dispatch, whose capacity and drops span every
    token of the batch, gathers the batch over its dp axes first (each
    position then routes the whole batch and keeps its own rows); the
    per-sequence dispatch needs no gather."""
    gather = lay.batch and not (cfg.moe_dispatch == "per_seq"
                                and hs[0].shape[0] > 1)
    full = pm.all_gather(hs, mesh, lay.batch, 0) if gather else hs
    out = []
    for p in range(mesh.size):
        experts = None
        if lay.experts:
            n = cfg.n_experts // lay.tp
            experts = (_model_index(mesh, p) * n,
                       (_model_index(mesh, p) + 1) * n)
        y = T._ffn(cfg, w[p], full[p], experts)
        if gather:      # this position's rows of the gathered batch
            y = y[pm.block_slices(y.shape[:1], P(lay.batch), mesh, p)[0]]
        out.append(y)
    return out


def _local_batch(batch, mesh: Mesh, key: str) -> pm.Sharded:
    x = batch[key]
    if isinstance(x, pm.Sharded):
        return x
    x = torch.as_tensor(x)
    return pm.shard(x, batch_spec(mesh, x.shape[0]), mesh)


def _embed(cfg: ModelConfig, mesh: Mesh, lay: Layout, params,
           tokens: List[torch.Tensor]) -> List[torch.Tensor]:
    table = _local(mesh, params["embed"].spec, params["embed"].blocks)
    dtype = torch_dtype(cfg.dtype)
    if not lay.vocab_embed:
        return [F.embedding(t, e).to(dtype) for t, e in zip(tokens, table)]
    rows = []
    for p, (t, e) in enumerate(zip(tokens, table)):
        n = e.shape[0]
        local = t - _model_index(mesh, p) * n
        mine = (local >= 0) & (local < n)
        got = F.embedding(local.clamp(0, n - 1), e)
        rows.append(torch.where(mine[..., None], got, 0))
    return [x.to(dtype) for x in pm.all_reduce_sum(rows, mesh, MODEL)]


def run_layers(cfg: ModelConfig, mesh: Mesh, lay: Layout, layers,
               xs: List[torch.Tensor], impl: str, remat: bool,
               fused: bool = True, kv_out: Optional[list] = None
               ) -> List[torch.Tensor]:
    """Every layer of ``layers`` (a tree of ``Sharded`` stacked on a
    leading layer dim) over every position in lockstep, each layer under
    ``cfg.remat`` when ``remat`` (a gradient will be taken); ``xs`` one
    residual a position; ``kv_out`` gets each layer's K/V
    (``_layer_fn``).  Under the dry run's ``program_cost.replay()`` the
    layers are one trip (``program_cost.loop``)."""
    devs = mesh.device_list
    s = xs[0].shape[1]
    arange = {d: torch.arange(s, device=d) for d in set(devs)}
    specs = {name: P(*st.spec[1:]) for name, st in layers.items()}
    n = next(iter(layers.values())).shape[0]
    apart = last_apart(mesh, lay, remat)
    stacked = layer_stacks(mesh, layers, apart_counts(n, apart))
    body = _layer_fn(cfg, mesh, lay, specs, [arange[d] for d in devs], impl,
                     fused, kv_out)
    step = T._remat(body, cfg.remat) if remat else body
    return pc.loop("layers", n, lambda i, xs, lws, _: step(xs, lws), xs,
                   inputs=lambda i: layer_at(stacked, i),
                   grow=() if kv_out is None else (kv_out,), grad=remat,
                   retained=remat, last_apart=apart)


def layer_stacks(mesh: Mesh, layers, counts=None
                 ) -> List[Dict[str, Sequence]]:
    """Each position's layers of a stacked tree (``program_cost.unstack``:
    ``unbind``, or the replayed layers, ``counts``, under the dry run's
    replay)."""
    return [{name: pc.unstack(st.blocks[p], counts)
             for name, st in layers.items()} for p in range(mesh.size)]


def last_apart(mesh: Mesh, lay: Layout, grad: bool) -> bool:
    """Whether a gradient reads the last layer's output of only some
    positions and every position's output of the layers before it: the
    logits whole on every 'model' position (the vocab not split) and
    counted from index 0 of 'model' (``loss_owners``).  A replay then
    takes the last layer apart (``program_cost.loop``)."""
    return grad and lay.tp > 1 and not lay.vocab_logits


def apart_counts(n: int, apart: bool):
    """``layer_stacks``' counts for a loop of ``n`` layers replayed with
    its last layer apart, or None."""
    return ((0, n - 1), (n - 1, 1)) if apart and n >= 2 else None


def layer_at(stacked, i: int) -> List[Dict[str, torch.Tensor]]:
    """Layer ``i``'s blocks a position, from ``layer_stacks``."""
    return [{name: w[i] for name, w in st.items()} for st in stacked]


def final_norm(cfg: ModelConfig, mesh: Mesh, params,
               xs: List[torch.Tensor]) -> List[torch.Tensor]:
    ln_f = _local(mesh, params["ln_f"].spec, params["ln_f"].blocks)
    return [L.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, ln_f)]


def head_blocks(cfg: ModelConfig, mesh: Mesh, lay: Layout, params
                ) -> List[torch.Tensor]:
    """Per position its block of the head (D, V_local): the tied
    embedding's transpose or ``lm_head``, gathered whole over the axes
    other than 'model', its vocab over 'model' where ``lay.vocab_logits``
    (the position's own part where the weight is replicated)."""
    if cfg.tie_embeddings:
        return [e.T for e in _local(
            mesh, params["embed"].spec, params["embed"].blocks,
            (0,) if lay.vocab_logits else ())]
    return _local(mesh, params["lm_head"].spec, params["lm_head"].blocks,
                  (1,) if lay.vocab_logits else ())


def head_logits(cfg: ModelConfig, mesh: Mesh, lay: Layout, params,
                xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``ln_f`` then the head: per position its fp32 logits block."""
    return [(h @ w.to(h.dtype)).float()
            for h, w in zip(final_norm(cfg, mesh, params, xs),
                            head_blocks(cfg, mesh, lay, params))]


def _prepend_patches(cfg: ModelConfig, mesh: Mesh, params,
                     patches: pm.Sharded, xs: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """A vlm's stub ``patches`` (B, n_patches, D), laid out as the batch,
    projected on each position by ``vision_proj`` (gathered whole where it
    is stored over 'data') and prepended to its text rows, as
    ``transformer.forward`` does."""
    dt = torch_dtype(cfg.dtype)
    proj = _local(mesh, params["vision_proj"].spec,
                  params["vision_proj"].blocks)
    return [torch.cat([(x.to(dt) @ w).to(dt), t], dim=1)
            for x, w, t in zip(patches.blocks, proj, xs)]


def forward(cfg: ModelConfig, params, batch, mesh: Mesh,
            attn_impl: Optional[str] = None, return_cache: bool = False,
            return_hidden: bool = False):
    """Per position (in position order) its logits block (b_local, S,
    V_local) in fp32, and the ``Layout``.  ``params`` is a tree of
    ``Sharded``; ``batch["tokens"]`` a (B, S) ``Sharded`` or a tensor laid
    out here by ``batch_spec``, as are encdec's ``frames`` and a vlm's
    ``patches`` (whose n_patches positions come before the text: S counts
    them).  ``return_cache`` (a prefill) adds a third item, the decode
    cache: ``Sharded`` leaves laid out by ``serve_step.cache_specs(cfg, B,
    S, mesh)`` and ``len`` S (``dist/spmd_serve.py``).  ``return_hidden``
    (the chunked loss; the transformer families, as on one device):
    (per position its final-normed hidden block (b_local, S, D), per
    position its head block (``head_blocks``), the ``Layout``) instead."""
    check_mesh(mesh)
    if return_hidden and (return_cache
                          or cfg.family not in CHUNKED_LOSS_FAMILIES):
        raise ValueError(f"return_hidden: a forward of the "
                         f"{CHUNKED_LOSS_FAMILIES} families without a cache")
    tokens = _local_batch(batch, mesh, "tokens")
    rows, s = tokens.shape
    patches = _local_batch(batch, mesh, "patches") \
        if cfg.family == "vlm" else None
    if patches is not None:
        s += patches.shape[1]
    lay = layout(cfg, params, mesh, rows, s)
    impl = attn_impl or L.pick_attn_impl(cfg.attn_impl, s,
                                         mesh.device_list[0])
    xs = _embed(cfg, mesh, lay, params, tokens.blocks)
    if patches is not None:
        xs = _prepend_patches(cfg, mesh, params, patches, xs)
    grad = torch.is_grad_enabled() and any(
        b.requires_grad for _, st in pm.tree_items(params) for b in st.blocks)
    if return_cache and grad:
        raise ValueError("forward(return_cache=True) on a mesh is a prefill: "
                         "it takes no gradient")
    kept: Optional[dict] = {"kv": [], "ssm": [], "conv": [], "ckv": []} \
        if return_cache else None
    if cfg.family in SSM_FAMILIES:
        from repro_torch.dist import spmd_ssm
        ssd = mamba2.pick_ssd_impl(mesh.device_list[0], prefill=True,
                                   grad=grad)
        xs = spmd_ssm.run_backbone(cfg, mesh, lay, params, xs, impl, ssd,
                                   grad, kept)
    elif cfg.family == "encdec":
        from repro_torch.dist import spmd_encdec
        frames = _local_batch(batch, mesh, "frames").blocks
        xs = spmd_encdec.run(cfg, mesh, lay, params, xs, frames, grad, kept)
    else:
        xs = run_layers(cfg, mesh, lay, params["layers"], xs, impl, grad,
                        kv_out=None if kept is None else kept["kv"])
    if return_hidden:
        return (final_norm(cfg, mesh, params, xs),
                head_blocks(cfg, mesh, lay, params), lay)
    logits = head_logits(cfg, mesh, lay, params, xs)
    if not return_cache:
        return logits, lay
    from repro_torch.dist import spmd_serve
    return logits, lay, spmd_serve.prefill_cache(cfg, mesh, lay, rows, s,
                                                  kept)


def logits_sharded(mesh: Mesh, lay: Layout,
                   blocks: List[torch.Tensor]) -> pm.Sharded:
    """Per-position logits blocks (b_local, S, V_local) as one ``Sharded``
    (B, S, V): the batch over ``lay.batch``, the vocab over 'model' where
    ``lay.vocab_logits``."""
    return _as_sharded(mesh, P(_batch_part(lay), None,
                               MODEL if lay.vocab_logits else None), blocks)


def hidden_sharded(mesh: Mesh, lay: Layout, hidden: List[torch.Tensor],
                   heads: List[torch.Tensor]
                   ) -> Tuple[pm.Sharded, pm.Sharded]:
    """``forward(..., return_hidden=True)``'s blocks as ``Sharded``: the
    hidden (B, S, D), its batch over ``lay.batch``, and the head (D, V),
    its vocab over 'model' where ``lay.vocab_logits``."""
    return (_as_sharded(mesh, P(_batch_part(lay), None, None), hidden),
            _as_sharded(mesh, P(None, MODEL if lay.vocab_logits else None),
                        heads))


def _batch_part(lay: Layout):
    return lay.batch[0] if len(lay.batch) == 1 else (lay.batch or None)


def _as_sharded(mesh: Mesh, spec: P, blocks: List[torch.Tensor]
                ) -> pm.Sharded:
    """Per-position blocks laid out by ``spec`` as one ``Sharded``: each
    dim's global size its block's times the sizes of the axes it is
    split over."""
    shape = tuple(n * math.prod(mesh.shape[a] for a in pm.part_axes(part))
                  for n, part in zip(blocks[0].shape, spec))
    return pm.Sharded(shape, pm.check_spec(shape, spec, mesh), mesh,
                      list(blocks))


def _ce_sums(mesh: Mesh, lay: Layout, logits: List[torch.Tensor],
             labels: List[torch.Tensor]):
    """Per position (nll_sum, n_tokens, n_correct) of its batch shard;
    vocab-parallel where the logits are split over 'model'."""
    if not lay.vocab_logits:
        return [masked_ce_sums(lg, lb) for lg, lb in zip(logits, labels)]
    n = mesh.size
    labels = [lb.long() for lb in labels]
    peak = [lg.detach().amax(-1) for lg in logits]
    top = pm.all_reduce_max(peak, mesh, MODEL)
    sum_exp = pm.all_reduce_sum(
        [torch.exp(lg - t[..., None]).sum(-1) for lg, t in zip(logits, top)],
        mesh, MODEL)
    picked, first = [], []
    for p in range(n):
        v = logits[p].shape[-1]
        off = _model_index(mesh, p) * v
        local = labels[p] - off
        mine = (local >= 0) & (local < v)
        got = torch.gather(logits[p], -1, local.clamp(0, v - 1)[..., None])
        picked.append(torch.where(mine, got[..., 0], 0.0))
        # the global argmax: the first position holding the max
        arg = peak[p].new_full(peak[p].shape, float("inf"))
        at = logits[p].detach().argmax(-1) + off
        first.append(torch.where(peak[p] == top[p], at.float(), arg))
    label_logit = pm.all_reduce_sum(picked, mesh, MODEL)
    argmax = pm.all_reduce_min(first, mesh, MODEL)
    out = []
    for p in range(n):
        mask = labels[p] != IGNORE_LABEL
        nll = torch.log(sum_exp[p]) + top[p] - label_logit[p]
        correct = mask & (argmax[p].long() == labels[p])
        out.append((torch.where(mask, nll, 0.0).sum(), mask.sum(),
                    correct.sum()))
    return out


def loss_owners(mesh: Mesh, batch_axes: Tuple[str, ...]) -> List[int]:
    """The positions whose sums make the global batch's once: index 0 of
    every axis the batch is not split over."""
    return pm.owners(P(batch_axes or None), mesh)


def ce_loss(mesh: Mesh, lay: Layout, logits: List[torch.Tensor],
            labels: List[torch.Tensor]):
    """The masked mean CE of per-position logits blocks over the global
    batch, counted once (``loss_owners``): (loss, {"loss", "tokens",
    "accuracy"}), 0-d tensors on the first position's device."""
    return _mean_of_sums(mesh, lay, _ce_sums(mesh, lay, logits, labels))


def chunked_ce_loss(cfg: ModelConfig, mesh: Mesh, lay: Layout,
                    hidden: List[torch.Tensor], heads: List[torch.Tensor],
                    labels: List[torch.Tensor]):
    """``ce_loss`` of the head's logits over each position's final-normed
    ``hidden`` block, ``cfg.logits_chunk`` sequence positions at a time
    (the one-device ``model._chunked_loss``, the reference's scan): the
    sequence padded to a multiple of the chunk with ``IGNORE_LABEL``, each
    chunk's fp32 logits (b_local, c, V_local) and their sums
    (``_ce_sums``, vocab-parallel where ``lay.vocab_logits``) under one
    ``torch.utils.checkpoint`` over every position, so the backward
    recomputes a chunk's logits and no (b, S, V_local) fp32 tensor is
    held; the counted positions' sums add over the chunks (where the
    vocab is whole on every position, only theirs are computed).  Each chunk
    reads its own view of the head (an ``expand`` over the chunks), so the
    head's gradient is the sum of the chunks' stacked gradients, taken
    once, as the hidden's is their concatenation.  The chunks are one trip
    under the dry run's replay (``program_cost.loop``)."""
    s = hidden[0].shape[1]
    c = min(cfg.logits_chunk, s)
    pad = -s % c
    n = (s + pad) // c
    grad = torch.is_grad_enabled() and hidden[0].requires_grad
    owners = loss_owners(mesh, lay.batch)
    # the positions a chunk's sums need: every one where the vocab is
    # split (the vocab-parallel loss), else the counted ones alone
    need = range(mesh.size) if lay.vocab_logits else owners
    parts, wparts, lparts = {}, {}, {}
    for p in need:
        x, lb = hidden[p], labels[p]
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            lb = F.pad(lb, (0, pad), value=IGNORE_LABEL)
        parts[p], lparts[p] = pc.split(x, c, 1), lb.split(c, 1)
        wparts[p] = pc.unstack(heads[p].expand(n, *heads[p].shape))

    def sums_of(xs, ws, lbs):
        got = _ce_sums(mesh, lay, [(xs[p] @ ws[p].to(xs[p].dtype)).float()
                                   for p in need], [lbs[p] for p in need])
        return dict(zip(need, got))

    def chunk(i, acc, ins, _):
        xs, ws, lbs = ins
        if grad:
            got = checkpoint(sums_of, xs, ws, lbs, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            got = sums_of(xs, ws, lbs)
        return {p: tuple(a + b for a, b in zip(mine, got[p]))
                for p, mine in acc.items()}

    devs = mesh.device_list
    zero = {p: (torch.zeros((), dtype=torch.float32, device=devs[p]),
                torch.zeros((), dtype=torch.int64, device=devs[p]),
                torch.zeros((), dtype=torch.int64, device=devs[p]))
            for p in owners}
    sums = pc.loop("loss_chunks", n, chunk, zero,
                   inputs=lambda i: ({p: x[i] for p, x in parts.items()},
                                     {p: w[i] for p, w in wparts.items()},
                                     {p: lb[i] for p, lb in lparts.items()}),
                   grad=grad)
    return _mean_of_sums(mesh, lay, sums)


def _mean_of_sums(mesh: Mesh, lay: Layout, sums):
    """(loss, metrics) of per-position (nll_sum, n_tokens, n_correct)
    (``sums[p]``, at least for every position of ``loss_owners``),
    counted once on the first position's device."""
    dev0 = mesh.device_list[0]
    owners = loss_owners(mesh, lay.batch)
    nll = sum(sums[p][0].to(dev0) for p in owners)
    n_tok = sum(sums[p][1].to(dev0) for p in owners)
    n_corr = sum(sums[p][2].to(dev0) for p in owners)
    denom = torch.clamp_min(n_tok, 1)
    loss = nll / denom
    return loss, {"loss": loss, "tokens": n_tok, "accuracy": n_corr / denom}


def loss_fn(cfg: ModelConfig, params, batch, mesh: Mesh,
            attn_impl: Optional[str] = None):
    """Masked next-token CE over the global batch on ``mesh``: (loss,
    {"loss", "tokens", "accuracy"}), 0-d tensors on the first position's
    device; ``cfg.logits_chunk > 0`` (the transformer families) takes it
    in sequence chunks (``chunked_ce_loss``)."""
    labels = _local_batch(batch, mesh, "labels").blocks
    if cfg.logits_chunk and cfg.family in CHUNKED_LOSS_FAMILIES:
        hidden, heads, lay = forward(cfg, params, batch, mesh, attn_impl,
                                     return_hidden=True)
        return chunked_ce_loss(cfg, mesh, lay, hidden, heads, labels)
    logits, lay = forward(cfg, params, batch, mesh, attn_impl)
    return ce_loss(mesh, lay, logits, labels)
