"""Serving on a mesh: the sharded prefill's cache and the sharded
one-token decode step (counterpart of the ``mesh`` argument the
reference threads through ``transformer.forward(..., return_cache=True)``
and ``transformer.decode``, ``mamba2``, ``hybrid`` and ``encdec``'s,
reached from
``serve_step.make_prefill(cfg, mesh)`` and ``make_decode(cfg, mesh)``).

The cache is a dict of ``placement.Sharded`` leaves laid out by
``serve_step.cache_specs`` (the reference's rules), plus ``len``:

* K/V (L, B, S, KV, hd): the K/V heads over 'model' where they divide it
  (the *head split*), else the sequence where it divides (the *sequence
  split*, context-parallel decode), else whole on every position; the
  batch over ``batch_spec``'s dp axes;
* ``ssm`` (L, B, H, P, N) with its heads over 'model' where they divide
  it, ``conv`` (L, B, K-1, d_inner + 2N) with its channels in contiguous
  blocks over 'model' (``dist/spmd_ssm.decode_layer``);
* encdec's ``ck``/``cv`` (L, B, n_frames, KV, hd), the cross-attention's
  K/V from the prefill, their K/V heads over 'model' where they divide
  it, the frames never split (``dist/spmd_encdec.decode_layer``).

The prefill (``spmd.forward(..., return_cache=True)``) keeps each layer's
K/V per position as its projection gave them (``spmd.kv_heads_held``: the
position's block where ``wk`` is stored over 'model', else every head) and
slices each position's cache block from them: the heads and slots
``cache_specs`` gives the position, the last ``window`` slots first for
a sliding window (mixtral, as the reference keeps ``k[:, -window:]``).
Where the cache asks for heads a position did not compute (``wk`` split
while the cache is not head-split; ``cache_specs`` and ``spmd.layout``
both split the K/V heads exactly where 'model' divides them, so no
config reaches it), it raises.

The decode step is a lockstep layer over the positions, as
``spmd._layer_fn``, with ``transformer.decode``'s body: the new token's
K/V row is written in place into the cache block that owns its slot
(slot ``len``, or ``len % window`` in a ring), by a masked write on every
position (a device ``len`` is never read on the host).  Attention:

* head split: each position runs ``attn_decode`` over its own K/V heads,
  which are the heads its query heads read (where the K/V heads divide
  'model', so do the query heads);
* sequence split: each position scores all query heads against its own
  slots, and the parts combine over 'model' as one softmax: the max by
  ``all_reduce_max``, then the sum of exps and the exp-weighted V (fp32)
  in one ``all_reduce_sum``.  Where the query heads are split over
  'model' (mixtral-8x22b at tp 16: 48 query heads, 8 K/V heads), the
  (b, 1, H, hd) query is ``all_gather``ed over 'model' instead of the
  cache, so every collective stays one token wide; a position then keeps
  its own heads of the output for its ``wo`` block;
* whole: as on one device, over the K/V heads the position's query heads
  read (``spmd._kv_heads``).

``wo``, the norms, the FFN and the MoE's dispatch are ``_layer_fn``'s
(``spmd.layer_weights``, ``spmd.ffn_half``).  The decode's attention and
norms take the plain routes, as the reference's decode passes no
``impl``.  The state-space families' Mamba-2 layers step through
``dist/spmd_ssm.decode_layer``; the hybrid's shared block is this
module's attention layer on the unstacked ``shared_attn`` (unfused, as
``hybrid._shared_decode``); encdec's decoder layers step through
``dist/spmd_encdec.decode_layer`` (this module's self-attention, then the
cross-attention against ``ck``/``cv``), and a vlm's are the dense ones
(its cache's ``len`` counts the patches).  Every collective goes through
``placement._collective``, so ``record_collectives()`` sees them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P, batch_spec
from repro_torch.launch import program_cost as pc
from repro_torch.models import hybrid
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MODEL = spmd.MODEL


def _stacked(shape, spec: P, mesh: Mesh,
             blocks: List[List[torch.Tensor]]) -> pm.Sharded:
    """A cache leaf from one list a layer of each position's block."""
    return pm.Sharded(tuple(shape), pm.check_spec(shape, spec, mesh), mesh,
                      [torch.stack([layer[p] for layer in blocks])
                       for p in range(mesh.size)])


def _held(cfg: ModelConfig, lay: spmd.Layout, mesh: Mesh, pos: int,
          heads: slice) -> slice:
    """A cache block's K/V ``heads`` among those position ``pos``'s
    projection computes (``spmd.kv_heads_held``)."""
    lo, hi = spmd.kv_heads_held(cfg, lay, mesh, pos)
    if not (lo <= heads.start and heads.stop <= hi):
        raise NotImplementedError(
            f"the cache's K/V heads {heads} on position {pos} are not among "
            f"the heads [{lo}, {hi}) its projection computes")
    return slice(heads.start - lo, heads.stop - lo)


def _kv_leaf(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, shape, spec: P,
             kept: List[list], which: int) -> pm.Sharded:
    """The K (``which`` 0) or V leaf from each layer's per-position
    projections (``spmd._layer_fn``'s ``kv_out``)."""
    def blocks(layer):
        out = []
        for p, kv in enumerate(layer):
            x = kv[which]
            if cfg.window and x.shape[1] > cfg.window:
                x = x[:, -cfg.window:]
            sl = pm.block_slices(shape[1:], P(*spec[1:]), mesh, p)
            out.append(x[:, sl[1], _held(cfg, lay, mesh, p, sl[2])])
        return out
    return _stacked(shape, spec, mesh, _per_entry(kept, blocks))


def _per_entry(kept: List[list], fn) -> List[list]:
    """``fn`` of each entry of ``kept``, once an entry object: a replayed
    loop's entry stands in ``kept`` for every layer it replays
    (``program_cost.loop``'s ``grow``)."""
    done: Dict[int, list] = {}
    for entry in kept:
        if id(entry) not in done:
            done[id(entry)] = fn(entry)
    return [done[id(entry)] for entry in kept]


def prefill_cache(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, batch: int,
                  seq: int, kept: dict) -> Dict:
    """The prefill's decode cache from what its layers kept (``kept``:
    ``kv`` one list a layer or hybrid application, ``ckv`` one list an
    encdec decoder layer (its cross-attention's K/V), ``ssm`` and
    ``conv`` one list a Mamba-2 layer, each one entry a position), laid
    out by
    ``cache_specs(cfg, batch, seq, mesh)``; ``len`` is ``seq``.  The SSD
    states stay fp32, as the one-device prefill returns them."""
    from repro_torch.dist import spmd_ssm
    from repro_torch.models import model as model_lib
    from repro_torch.serve.serve_step import cache_specs
    decls = model_lib.cache_decls(cfg, batch, seq)
    specs = cache_specs(cfg, batch, seq, mesh)
    dense = hybrid._dense_view(cfg) if cfg.family == "hybrid" else cfg
    out: Dict = {}
    for name, src in (("k", "kv"), ("v", "kv"), ("ck", "ckv"),
                      ("cv", "ckv")):
        if name in decls:
            out[name] = _kv_leaf(dense, mesh, lay, decls[name].shape,
                                 specs[name], kept[src], name[-1] == "v")
    if "ssm" in decls:
        shape, spec = decls["ssm"].shape, specs["ssm"]

        def states(layer):
            row = []
            for p, st in enumerate(layer):
                lo = spmd_ssm.held_heads(cfg, lay, mesh, p)[0]
                sl = pm.block_slices(shape[1:], P(*spec[1:]), mesh, p)
                row.append(st[:, sl[1].start - lo:sl[1].stop - lo])
            return row
        out["ssm"] = _stacked(shape, spec, mesh,
                              _per_entry(kept["ssm"], states))
        cshape, cspec = decls["conv"].shape, specs["conv"]
        out["conv"] = _stacked(cshape, cspec, mesh, _per_entry(
            kept["conv"], lambda layer: [
                t[:, :, pm.block_slices(cshape[1:], P(*cspec[1:]), mesh,
                                        p)[2]]
                for p, t in enumerate(layer)]))
    out["len"] = seq
    return out


# --- the decode step ---------------------------------------------------------------

def _lens(n, mesh: Mesh, batch: int) -> List[torch.Tensor]:
    """``cache["len"]`` on each position's device: a 0-d tensor for an
    int, a 0-d tensor or a ``Sharded`` 0-d leaf (a lockstep batch), the
    position's rows of a (B,) tensor (per-row positions; a ``Sharded``
    (B,) leaf laid out as the batch)."""
    devs = mesh.device_list
    if isinstance(n, pm.Sharded):
        return list(n.blocks)
    if not isinstance(n, torch.Tensor):
        return [torch.tensor(n, device=d) for d in devs]
    if n.dim() == 0:
        return [n.to(d) for d in devs]
    spec = P(batch_spec(mesh, batch)[0])
    return [n[pm.block_slices((batch,), spec, mesh, p)[0]].to(d)
            for p, d in enumerate(devs)]


def _next_len(n):
    if isinstance(n, pm.Sharded):
        return n.with_blocks([b + 1 for b in n.blocks])
    return n + 1


def _kv_mode(spec: P) -> str:
    """How a K/V leaf (L, B, S, KV, hd) lies over 'model'."""
    if MODEL in pm.part_axes(spec[3]):
        return "heads"
    if MODEL in pm.part_axes(spec[2]):
        return "seq"
    return "whole"


@dataclasses.dataclass
class _Slots:
    """Where one position's decode step reads and writes its K/V blocks:
    the same for every layer of the step."""
    positions: torch.Tensor         # RoPE positions: (1,) or (b, 1)
    rows: torch.Tensor              # (b,) batch rows
    idx: torch.Tensor               # (b,) the new row's slot in the block
    mine: Optional[torch.Tensor]    # (b,) the slot lies in this block;
    #                                 None: the block holds every slot
    valid: torch.Tensor             # slots to attend: 0-d or (b,)
    first: int                      # the block's first slot
    heads: slice                    # its K/V heads among the projection's


def _slots(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, k_all: pm.Sharded,
           pos: List[torch.Tensor]) -> List[_Slots]:
    """Each position's ``_Slots`` for the K/V leaf ``k_all``, ``pos`` its
    ``len`` (0-d or its rows' (b,)): slot ``len``, or ``len % window`` in a
    ring."""
    size = k_all.shape[2]
    spec = P(*k_all.spec[1:])
    out = []
    for p, n in enumerate(pos):
        sl = pm.block_slices(k_all.shape[1:], spec, mesh, p)
        b = sl[0].stop - sl[0].start
        slot = (n % size if cfg.window else n).expand(b)
        first, held = sl[1].start, sl[1].stop - sl[1].start
        local = slot - first
        out.append(_Slots(
            positions=n.reshape(1) if n.dim() == 0 else n[:, None],
            rows=torch.arange(b, device=n.device),
            idx=local.clamp(0, held - 1),
            mine=None if held == size else (local >= 0) & (local < held),
            valid=torch.clamp(n + 1, max=size), first=first,
            heads=_held(cfg, lay, mesh, p, sl[2])))
    return out


def _write_row(cache: torch.Tensor, new: torch.Tensor, at: _Slots) -> None:
    """Write each batch row's ``new`` (b, KV, hd) into its slot of the block
    ``cache`` (b, S_local, KV, hd), in place; where the slot lies in
    another position's block, the row's old value is written back."""
    new = new.to(cache.dtype)
    if at.mine is not None:
        new = torch.where(at.mine[:, None, None], new, cache[at.rows, at.idx])
    cache.index_put_((at.rows, at.idx), new)


def _split_softmax(mesh: Mesh, q: List[torch.Tensor], k: List[torch.Tensor],
                   v: List[torch.Tensor], valid: List[torch.Tensor],
                   first: List[int]) -> List[torch.Tensor]:
    """``attn_decode`` over a cache split by its slots: each position's q
    (b, 1, H, hd) against its slots [first, first + S_local) of k and v,
    masked at ``valid`` (0-d or (b,)); the parts combined over 'model'
    into one softmax.  Returns the (b, 1, H, hd) output on every
    position, in q's dtype."""
    scores, hd = [], q[0].shape[-1]
    for p in range(mesh.size):
        n_kv = k[p].shape[2]
        qg = L._split_gqa(q[p], n_kv)[:, 0]                 # (b,KV,G,hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg, k[p]).float() * hd ** -0.5
        slots = torch.arange(k[p].shape[1], device=s.device) + first[p]
        mask = slots[None] >= valid[p].reshape(-1, 1)       # (1|b, S_local)
        scores.append(torch.where(mask[:, None, None, :], L.NEG_INF, s))
    top = pm.all_reduce_max([s.amax(-1, keepdim=True) for s in scores],
                            mesh, MODEL)
    parts = []
    for p, s in enumerate(scores):
        e = torch.exp(s - top[p])
        o = torch.einsum("bkgs,bskh->bkgh", e, v[p].float())
        parts.append(torch.cat([o, e.sum(-1, keepdim=True)], -1))
    out = []
    for p, t in enumerate(pm.all_reduce_sum(parts, mesh, MODEL)):
        o = t[..., :hd] / t[..., hd:]
        out.append(o.reshape(q[p].shape).to(q[p].dtype))
    return out


def attn_decode_part(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout,
                     w: List[Dict[str, torch.Tensor]],
                     xs: List[torch.Tensor], k_all: pm.Sharded,
                     v_all: pm.Sharded, i: int, at: List[_Slots]
                     ) -> List[torch.Tensor]:
    """A decode step's self-attention over every position, against entry
    ``i`` of the cache leaves ``k_all`` / ``v_all`` (a layer, or a hybrid
    application), ``w`` the layer's weights a position
    (``spmd.layer_weights``), ``at`` the step's ``_slots``: ``ln1``, the
    new K/V row written into its slot, the attention, and each position's
    output projected by its ``wo`` block (partial over 'model' where the
    query heads are split)."""
    mode = _kv_mode(k_all.spec)
    qs, ks, vs = [], [], []
    for p, x in enumerate(xs):
        h = L.rms_norm(x, w[p]["ln1"], cfg.norm_eps)
        q, k, v = T._qkv(cfg, w[p], h, at[p].positions)
        kb, vb = k_all.blocks[p][i], v_all.blocks[p][i]
        _write_row(kb, k[:, 0, at[p].heads], at[p])
        _write_row(vb, v[:, 0, at[p].heads], at[p])
        qs.append(q)
        ks.append(kb)
        vs.append(vb)
    valid = [a.valid for a in at]
    if mode == "seq":
        first = [a.first for a in at]
        if lay.heads:
            outs = _split_softmax(mesh, pm.all_gather(qs, mesh, MODEL, 2),
                                  ks, vs, valid, first)
            hl = cfg.n_heads // lay.tp
            outs = [o[:, :, spmd._model_index(mesh, p) * hl:
                      (spmd._model_index(mesh, p) + 1) * hl]
                    for p, o in enumerate(outs)]
        else:
            outs = _split_softmax(mesh, qs, ks, vs, valid, first)
    else:
        outs = []
        for p in range(mesh.size):
            kb, vb = ks[p], vs[p]
            if mode == "whole":
                kb, vb = spmd._kv_heads(cfg, lay, mesh, p, kb, vb)
            outs.append(L.attn_decode(qs[p], kb, vb, cache_len=valid[p],
                                      window=0))
    return [T._proj_out(o.to(x.dtype), wp["wo"])
            for o, x, wp in zip(outs, xs, w)]


def attn_decode_layer(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout,
                      w: List[Dict[str, torch.Tensor]], xs: List[torch.Tensor],
                      k_all: pm.Sharded, v_all: pm.Sharded, i: int,
                      at: List[_Slots], fused: bool = True
                      ) -> List[torch.Tensor]:
    """One attention + FFN layer of a decode step over every position
    (``attn_decode_part``, then ``spmd.ffn_half``).  ``fused`` as
    ``_layer_fn``'s (the hybrid's shared block runs unfused)."""
    part = attn_decode_part(cfg, mesh, lay, w, xs, k_all, v_all, i, at)
    return spmd.ffn_half(cfg, mesh, lay, w, xs, part, "jnp", fused)


def _layer_blocks(tree, mesh: Mesh, i: Optional[int] = None
                  ) -> Tuple[Dict[str, P], List[Dict[str, torch.Tensor]]]:
    """The specs and each position's blocks of a layer tree: entry ``i``
    of a stacked tree, or an unstacked one (``i`` None)."""
    if i is None:
        return ({name: st.spec for name, st in tree.items()},
                [{name: st.blocks[p] for name, st in tree.items()}
                 for p in range(mesh.size)])
    return ({name: P(*st.spec[1:]) for name, st in tree.items()},
            [{name: st.blocks[p][i] for name, st in tree.items()}
             for p in range(mesh.size)])


def decode(cfg: ModelConfig, params, cache, tokens, mesh: Mesh):
    """One decode step on ``mesh``: (per position its fp32 logits block
    (b_local, 1, V_local), the ``Layout``, the cache).  ``cache`` is
    ``prefill_cache``'s layout (after ``kv_cache.grow_cache``); its K/V
    (and conv, and an fp32 SSD state) are written in place, and ``len``
    comes back one higher in its own form: an int (checked on the host: a
    slot past a non-ring cache raises), a 0-d or (B,) tensor, or a
    ``Sharded`` leaf."""
    spmd.check_mesh(mesh)
    tokens = spmd._local_batch({"tokens": tokens}, mesh, "tokens")
    b = tokens.shape[0]
    lay = spmd.layout(cfg, params, mesh, b, 1)
    n = cache["len"]
    if "k" in cache and not isinstance(n, (torch.Tensor, pm.Sharded)) and \
            not cfg.window and n >= cache["k"].shape[2]:
        raise IndexError(f"decode: position {n} is past the cache's "
                         f"{cache['k'].shape[2]} slots")
    if cfg.family == "encdec" and isinstance(n, torch.Tensor) and n.dim():
        raise ValueError(f"encdec decode: len of shape {tuple(n.shape)}; "
                         f"the family decodes a lockstep batch (a scalar "
                         f"len) only")
    pos = _lens(n, mesh, b)
    xs = spmd._embed(cfg, mesh, lay, params, tokens.blocks)
    out = dict(cache)
    if cfg.family in spmd.SSM_FAMILIES:
        from repro_torch.dist import spmd_ssm
        ssm, conv = cache["ssm"], cache["conv"]
        new_ssm: List[list] = [[] for _ in range(mesh.size)]
        layers = params["layers"]

        def mamba(i, xs):
            specs, lws = _layer_blocks(layers, mesh, i)
            return spmd_ssm.decode_layer(cfg, mesh, lay, specs, lws, xs,
                                         ssm, conv, i, new_ssm)

        if cfg.family == "ssm":
            xs = pc.loop("layers", cfg.n_layers,
                         lambda i, xs, *_: mamba(i, xs), xs, grow=new_ssm)
        else:
            dense = hybrid._dense_view(cfg)
            at = _slots(dense, mesh, lay, cache["k"], pos)
            specs, lws = _layer_blocks(params["shared_attn"], mesh)
            ae = cfg.attn_every

            def group(g, xs, *_):
                w = spmd.layer_weights(mesh, lay, specs, lws)
                xs = attn_decode_layer(dense, mesh, lay, w, xs, cache["k"],
                                       cache["v"], g, at, fused=False)
                return pc.loop("layers_per_group", ae,
                               lambda i, xs, *_: mamba(g * ae + i, xs), xs,
                               grow=new_ssm)

            xs = pc.loop("groups", hybrid.n_groups(cfg), group, xs,
                         grow=new_ssm)
        if new_ssm[0]:
            out["ssm"] = ssm.with_blocks([torch.stack(s) for s in new_ssm])
    else:
        at = _slots(cfg, mesh, lay, cache["k"], pos)
        encdec = cfg.family == "encdec"
        if encdec:
            from repro_torch.dist import spmd_encdec

        def layer(i, xs, *_):
            specs, lws = _layer_blocks(
                params["decoder" if encdec else "layers"], mesh, i)
            w = spmd.layer_weights(mesh, lay, specs, lws)
            if encdec:
                return spmd_encdec.decode_layer(cfg, mesh, lay, w, xs, cache,
                                                i, at)
            return attn_decode_layer(cfg, mesh, lay, w, xs, cache["k"],
                                     cache["v"], i, at)

        xs = pc.loop("layers", cfg.n_layers, layer, xs)
    out["len"] = _next_len(n)
    return spmd.head_logits(cfg, mesh, lay, params, xs), lay, out
