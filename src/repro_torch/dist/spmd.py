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
  one-device step's.

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
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P, batch_spec, sanitize
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import IGNORE_LABEL, masked_ce_sums

MODEL = "model"


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


def layout(cfg: ModelConfig, params, mesh: Mesh, batch: int,
           seq: int) -> Layout:
    sizes = dict(mesh.shape)
    b = batch_spec(mesh, batch)[0]
    q = sanitize((batch, seq, cfg.n_heads, cfg.hd),
                 batch_spec(mesh, batch, None, MODEL, None), sizes)
    logits = sanitize((batch, seq, cfg.vocab_size),
                      batch_spec(mesh, batch, None, MODEL), sizes)
    layers = params["layers"]
    moe = cfg.family == "moe"
    # stacked (layers, experts, embed, e_ff) or (layers, embed, ff)
    ff = layers["we_up"].spec[3] if moe else layers["w_up"].spec[2]
    return Layout(
        tp=sizes.get(MODEL, 1), batch=pm.part_axes(b),
        heads=q[2] == MODEL, kv=layers["wk"].spec[2] == MODEL,
        ff=ff == MODEL,
        experts=moe and layers["we_up"].spec[1] == MODEL,
        vocab_embed="embed" in params and params["embed"].spec[0] == MODEL,
        vocab_logits=logits[2] == MODEL)


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


def _layer_fn(cfg: ModelConfig, mesh: Mesh, lay: Layout, specs: Dict[str, P],
              positions: List[torch.Tensor], impl: str, fused: bool = True):
    """One decoder layer over every position (the lockstep body that
    ``cfg.remat`` checkpoints): ``xs`` one (b, S, D) residual a position,
    ``lws`` one dict of this layer's blocks a position; ``positions`` the
    RoPE positions on each position's device.  ``fused`` runs the seam as
    ``decoder_block`` does (``rms_norm_residual``); False as
    ``attn_block`` then ``ffn_block`` (the residual add, then a plain
    ``rms_norm``), the pipeline stage's body."""
    split = {"wq": (1,), "bq": (0,), "wo": (0,)} if lay.heads else {}
    n = mesh.size

    def body(xs, lws):
        w = [dict() for _ in range(n)]
        for name, spec in specs.items():
            blocks = _local(mesh, spec, [lw[name] for lw in lws],
                            split.get(name, ()))
            for p in range(n):
                w[p][name] = blocks[p]
        part = []
        for p in range(n):
            h = L.rms_norm(xs[p], w[p]["ln1"], cfg.norm_eps)
            q, k, v = T._qkv(cfg, w[p], h, positions[p])
            k, v = _kv_heads(cfg, lay, mesh, p, k, v)
            o = L.attention(q, k, v, impl=impl, causal=True,
                            window=cfg.window, q_pos=positions[p],
                            k_pos=positions[p],
                            block_remat=cfg.attn_block_remat)
            part.append(T._proj_out(o, w[p]["wo"]))
        delta = pm.all_reduce_sum(part, mesh, MODEL) if lay.heads else part
        ys, hs, part = [], [], []
        for p in range(n):
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

    return body


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
               fused: bool = True) -> List[torch.Tensor]:
    """Every layer of ``layers`` (a tree of ``Sharded`` stacked on a
    leading layer dim) over every position in lockstep, each layer under
    ``cfg.remat`` when ``remat``; ``xs`` one residual a position."""
    devs = mesh.device_list
    s = xs[0].shape[1]
    arange = {d: torch.arange(s, device=d) for d in set(devs)}
    specs = {name: P(*st.spec[1:]) for name, st in layers.items()}
    stacked = [{name: st.blocks[p].unbind(0) for name, st in layers.items()}
               for p in range(mesh.size)]
    body = _layer_fn(cfg, mesh, lay, specs, [arange[d] for d in devs], impl,
                     fused)
    step = T._remat(body, cfg.remat) if remat else body
    for i in range(next(iter(layers.values())).shape[0]):
        xs = step(xs, [{name: w[i] for name, w in st.items()}
                       for st in stacked])
    return xs


def final_norm(cfg: ModelConfig, mesh: Mesh, params,
               xs: List[torch.Tensor]) -> List[torch.Tensor]:
    ln_f = _local(mesh, params["ln_f"].spec, params["ln_f"].blocks)
    return [L.rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, ln_f)]


def head_logits(cfg: ModelConfig, mesh: Mesh, lay: Layout, params,
                xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``ln_f`` then the head: per position its fp32 logits block."""
    if cfg.tie_embeddings:
        heads = [e.T for e in _local(
            mesh, params["embed"].spec, params["embed"].blocks,
            (0,) if lay.vocab_logits else ())]
    else:
        heads = _local(mesh, params["lm_head"].spec, params["lm_head"].blocks,
                       (1,) if lay.vocab_logits else ())
    return [(h @ w.to(h.dtype)).float()
            for h, w in zip(final_norm(cfg, mesh, params, xs), heads)]


def forward(cfg: ModelConfig, params, batch, mesh: Mesh,
            attn_impl: Optional[str] = None):
    """Per position (in position order) its logits block (b_local, S,
    V_local) in fp32, and the ``Layout``.  ``params`` is a tree of
    ``Sharded``; ``batch["tokens"]`` a (B, S) ``Sharded`` or a tensor laid
    out here by ``batch_spec``."""
    check_mesh(mesh)
    if cfg.logits_chunk:
        raise NotImplementedError(
            "logits_chunk > 0 on a mesh (the chunked loss) is not ported")
    tokens = _local_batch(batch, mesh, "tokens")
    lay = layout(cfg, params, mesh, *tokens.shape)
    tokens, s = tokens.blocks, tokens.shape[1]
    impl = attn_impl or L.pick_attn_impl(cfg.attn_impl, s,
                                         mesh.device_list[0])
    xs = _embed(cfg, mesh, lay, params, tokens)
    grad = torch.is_grad_enabled() and any(
        b.requires_grad for _, st in pm.tree_items(params) for b in st.blocks)
    xs = run_layers(cfg, mesh, lay, params["layers"], xs, impl, grad)
    return head_logits(cfg, mesh, lay, params, xs), lay


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
    sums = _ce_sums(mesh, lay, logits, labels)
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
    device."""
    logits, lay = forward(cfg, params, batch, mesh, attn_impl)
    return ce_loss(mesh, lay, logits,
                   _local_batch(batch, mesh, "labels").blocks)
