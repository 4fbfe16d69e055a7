"""The state-space families on a mesh: the sharded Mamba-2 layer and the
hybrid's backbone (counterpart of ``repro/models/mamba2.py`` and
``hybrid.py`` under the reference's ``mesh``), reached from
``dist/spmd.forward`` for ``family`` "ssm" and "hybrid".

The reference lays a Mamba-2 layer's weights out by ``"ssm_inner":
("model",)`` and constrains only the residual (the batch over its dp axes,
whole over 'model') after every layer; GSPMD computes the rest.  Its
``ssm_inner`` marks contiguous blocks of ``w_in``'s columns ``[z | x | B |
C | dt]`` and of the conv's channels ``[x | B | C]``, which do not line up
with the SSD heads, so the port computes as Megatron's Mamba tensor
parallelism does, where 'model' divides ``ssm_nheads`` and ``gate_ln`` is
stored over it (``Layout.ssm_heads``).  A position with model index a
holds the heads ``[a hl, (a + 1) hl)``, hl = heads / tp:

* ``w_in``, ``conv_w`` and ``conv_b`` are gathered whole over every axis
  they are stored over, a layer at a time, and the position takes its
  columns: z, x and dt of its heads, B and C whole (ngroups is 1, so every
  head reads them).  Gathering the weight rather than the in-projection's
  output moves d x (2 di + 2 n + h) elements a layer instead of b S (2 di
  + 2 n + h), and takes a replicated ``w_in`` (where 'model' does not
  divide its width) the same way;
* ``dt_bias``, ``a_log``, ``d_skip`` (replicated) are sliced to the
  position's heads; ``gate_ln`` and ``w_out``'s rows are its blocks;
* the SSD runs on (b_local, S, hl, P) with B and C whole, on the route
  ``mamba2.pick_ssd_impl`` picks (the kernel on a forward without a
  gradient on the card);
* the gated RMSNorm is taken over all di channels: each position's mean of
  squares over its di / tp channels is summed over 'model' and divided by
  tp;
* ``w_out``'s row block gives a partial (b, S, d), summed over 'model'
  before the residual add, as ``wo`` is in ``spmd._layer_fn``.

Where the heads are not split (tp does not divide them, or ``gate_ln`` is
replicated), each position runs ``mamba2.mamba_block`` whole from the
gathered weights, as GSPMD may.  Autograd through ``all_gather`` sums
each block's gradient over the positions that gathered it; a replicated
leaf gets one gradient a replica, summed by the train step
(``placement.replica_group_sum``).

The hybrid's shared attention + FFN block runs through ``spmd._layer_fn``
unfused (the reference's ``attn_block`` then ``ffn_block``) on the
unstacked ``shared_attn`` tree, before each group of ``attn_every``
layers; autograd sums its gradient over the applications.  As in the
one-device model, ``cfg.remat`` wraps each Mamba-2 layer and not the
shared block.

Serving (``dist/spmd_serve.py``): a prefill keeps each Mamba-2 layer's
final SSD state and conv tail per position (``run_backbone``'s
``kept``), and ``decode_layer`` steps one token against the cache laid
out by ``serve_step.cache_specs``, the SSD on ``ssd_chunked`` from the
carried state.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P
from repro_torch.launch import program_cost as pc
from repro_torch.models import hybrid
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MODEL = spmd.MODEL
_HEAD_LEAVES = ("a_log", "dt_bias", "d_skip", "gate_ln", "w_out")


def _whole(mesh: Mesh, spec: Sequence, blocks: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """A weight's blocks gathered whole on every position: each dim
    stored over mesh axes ``all_gather``ed over them."""
    for dim, part in enumerate(spec):
        names = pm.part_axes(part)
        if names:
            blocks = pm.all_gather(blocks, mesh, names, dim)
    return blocks


def model_whole(mesh: Mesh, spec: Sequence, blocks: List[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Blocks gathered whole over 'model' only (each dim the spec stores
    over 'model'), the other dims left as they lie (a cache's batch over
    the dp axes)."""
    for dim, part in enumerate(spec):
        if MODEL in pm.part_axes(part):
            blocks = pm.all_gather(blocks, mesh, pm.part_axes(part), dim)
    return blocks


def _take(w: torch.Tensor, dim: int,
          ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The (start, length) ranges of ``w``'s ``dim``, concatenated in
    order."""
    return torch.cat([w.narrow(dim, start, n) for start, n in ranges], dim)


def _mamba_step(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout,
                specs: Dict[str, P], impl: str):
    """One Mamba-2 layer over every position in lockstep: ``step(xs, lws,
    state=None, tails=False)``, ``xs`` one (b, S, D) residual a position,
    ``lws`` one dict of this layer's blocks a position, ``impl`` the SSD's
    route; returns (xs, ssm states, conv tails).  ``state`` (a
    decode step's) is one {"ssm", "conv"} a position: the SSD state of the
    heads the position computes (``held_heads``) and the conv state whole
    (b, K-1, d_inner + 2N); None starts from zero (a prefill).  With
    ``tails`` (or a ``state``) each position gets its layer's final SSD
    state (its heads, fp32) and the conv's last K-1 inputs whole: where the
    heads are split, a position's tail holds the x channels of its heads
    only, so their x parts are ``all_gather``ed over 'model' (K-1 rows of
    d_inner / tp a position); else both lists are None."""
    n = mesh.size
    di, sn, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    hl = h // lay.tp if lay.ssm_heads else h
    dl = hl * hp

    def gathered(lws, name):
        return _whole(mesh, specs[name], [lw[name] for lw in lws])

    def whole_step(xs, lws, state=None, tails=False):
        w = {name: gathered(lws, name) for name in specs}
        keep = tails or state is not None
        out, sts, convs = [], [], []
        for p in range(n):
            y, st = mamba2.mamba_block(
                cfg, {k: v[p] for k, v in w.items()}, xs[p],
                state=None if state is None else state[p],
                return_state=keep, impl=impl)
            out.append(y)
            if keep:
                sts.append(st["ssm"])
                convs.append(st["conv"])
        return (out, sts, convs) if keep else (out, None, None)

    def step(xs, lws, state=None, tails=False):
        ln = spmd._local(mesh, specs["ln"], [lw["ln"] for lw in lws])
        w_in, conv_w, conv_b = (gathered(lws, k)
                                for k in ("w_in", "conv_w", "conv_b"))
        heads = {k: spmd._local(mesh, specs[k], [lw[k] for lw in lws], (0,))
                 for k in _HEAD_LEAVES}
        gs, sts, convs = [], [], []
        for p in range(n):
            a = spmd._model_index(mesh, p)
            cols = [(a * dl, dl), (di + a * dl, dl), (2 * di, 2 * sn),
                    (2 * di + 2 * sn + a * hl, hl)]
            chans = [(a * dl, dl), (di, 2 * sn)]
            xn = L.rms_norm(xs[p], ln[p], cfg.norm_eps)
            z, xin, bb, cc, dt, conv = mamba2.mix_in(
                xn, _take(w_in[p], 1, cols), _take(conv_w[p], 1, chans),
                _take(conv_b[p], 0, chans), dl, sn, hl,
                None if state is None else _take(state[p]["conv"], 2, chans))
            y, st = mamba2.ssd_skip(cfg, {k: v[p] for k, v in heads.items()},
                                    xin, dt, bb, cc, impl,
                                    None if state is None else state[p]["ssm"])
            gs.append(y * F.silu(z))
            sts.append(st)
            convs.append(conv)
        # layers.rms_norm over all di channels: the mean of squares of each
        # position's di / tp channels, summed over 'model', over tp
        means = pm.all_reduce_sum(
            [torch.mean(torch.square(g.float()), dim=-1, keepdim=True)
             for g in gs], mesh, MODEL)
        part = []
        for p, g in enumerate(gs):
            y = (g.float() * torch.rsqrt(means[p] / lay.tp + cfg.norm_eps)
                 ).to(g.dtype) * heads["gate_ln"][p]
            part.append(y @ heads["w_out"][p])
        out = pm.all_reduce_sum(part, mesh, MODEL)
        out = [x + o.to(x.dtype) for x, o in zip(xs, out)]
        if not tails and state is None:
            return out, None, None
        xt = pm.all_gather([c[..., :dl] for c in convs], mesh, MODEL, 2)
        return out, sts, [torch.cat([x, c[..., dl:]], -1)
                          for x, c in zip(xt, convs)]

    return step if lay.ssm_heads else whole_step


def held_heads(cfg: ModelConfig, lay: spmd.Layout, mesh: Mesh,
               pos: int) -> Tuple[int, int]:
    """The SSD heads [lo, hi) whose state a position computes: its block
    where the heads are split (``Layout.ssm_heads``), else all of them."""
    if not lay.ssm_heads:
        return 0, cfg.ssm_nheads
    hl = cfg.ssm_nheads // lay.tp
    a = spmd._model_index(mesh, pos)
    return a * hl, (a + 1) * hl


def run_backbone(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, params,
                 xs: List[torch.Tensor], attn_impl: str, ssd_impl: str,
                 remat: bool, kept: Optional[dict] = None
                 ) -> List[torch.Tensor]:
    """The Mamba-2 layers of ``params["layers"]`` (``Sharded`` stacked on a
    leading layer dim) over every position in lockstep, each under
    ``cfg.remat`` when ``remat``; for the hybrid, the shared block before
    each group of ``attn_every`` of them.  ``xs`` one residual a
    position.  ``kept`` (a prefill's) gets one list a layer a position in
    ``kept["ssm"]`` and ``kept["conv"]`` (``_mamba_step``'s states) and
    the shared block's K/V an application in ``kept["kv"]``."""
    layers = params["layers"]
    specs = {name: P(*st.spec[1:]) for name, st in layers.items()}
    apart = spmd.last_apart(mesh, lay, remat)
    n, ae = cfg.n_layers, cfg.attn_every
    if cfg.family == "ssm":
        counts = spmd.apart_counts(n, apart)
    else:   # the first group stands for all but the last, whose last
        #     layer a replay takes apart
        last = (hybrid.n_groups(cfg) - 1) * ae
        counts = (((0, last), (last, ae - 1), (n - 1, 1)) if ae > 1
                  else ((0, n - 1), (n - 1, 1))) if apart and n > 1 else None
    stacked = spmd.layer_stacks(mesh, layers,
                                [c for c in counts if c[1]] if counts
                                else None)
    layer = _mamba_step(cfg, mesh, lay, specs, ssd_impl)
    if kept is None:
        def body(xs, lws):      # the lockstep body cfg.remat checkpoints
            return layer(xs, lws)[0]
        step = T._remat(body, cfg.remat) if remat else body
        grow: tuple = ()
    else:
        def step(xs, lws):
            xs, sts, tails = layer(xs, lws, tails=True)
            kept["ssm"].append(sts)
            kept["conv"].append(tails)
            return xs
        grow = (kept["ssm"], kept["conv"])

    def run(name: str, lo: int, n: int, xs, apart: bool):
        return pc.loop(name, n, lambda i, xs, lws, _: step(xs, lws), xs,
                       inputs=lambda i: spmd.layer_at(stacked, lo + i),
                       grow=grow, grad=remat, retained=remat,
                       last_apart=apart)

    if cfg.family == "ssm":
        return run("layers", 0, n, xs, apart)
    shared = params["shared_attn"]
    devs = mesh.device_list
    arange = {d: torch.arange(xs[0].shape[1], device=d) for d in set(devs)}
    block = spmd._layer_fn(hybrid._dense_view(cfg), mesh, lay,
                           {name: st.spec for name, st in shared.items()},
                           [arange[d] for d in devs], attn_impl, fused=False,
                           kv_out=None if kept is None else kept["kv"])
    shared_blocks = [{name: st.blocks[p] for name, st in shared.items()}
                     for p in range(mesh.size)]
    n_groups = hybrid.n_groups(cfg)

    def group(g, xs, _, blocks):
        return run("layers_per_group", g * ae, ae, block(xs, blocks),
                   apart and g == n_groups - 1)

    return pc.loop("groups", n_groups, group, xs, shared=shared_blocks,
                   grow=() if kept is None else (kept["kv"],) + grow,
                   grad=remat, retained=remat, last_apart=apart)


def decode_layer(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout,
                 specs: Dict[str, P], lws: List[Dict[str, torch.Tensor]],
                 xs: List[torch.Tensor], ssm: pm.Sharded, conv: pm.Sharded,
                 i: int, new_ssm: Optional[list]) -> List[torch.Tensor]:
    """Layer ``i``'s one-token step over every position against the cache
    leaves ``ssm`` and ``conv`` (``Sharded``, laid out by
    ``serve_step.cache_specs``), ``mamba2.decode_layer`` on a mesh.  A
    position reads what its heads need and writes its own blocks back:

    * the conv state is stored in contiguous channel blocks over 'model'
      (``ssm_inner``), which are not the channels a position's heads read
      (x of its heads, B and C whole): each layer ``all_gather``s it whole
      over 'model' ((b, K-1, d_inner + 2N) a position) and, after the
      step, writes its own block of the new state (``_mamba_step``'s
      gathered tail: K-1 rows of d_inner / tp a position);
    * the SSD state is stored with its heads over 'model' where they
      divide it, the heads a position computes where ``Layout.ssm_heads``
      holds; where it does not (the mixer runs whole), the state is
      gathered whole first.

    The new fp32 SSD state is written in place into an fp32 ``ssm`` (the
    served state), else appended to ``new_ssm`` per position."""
    step = _mamba_step(cfg, mesh, lay, specs, "chunked")
    conv_i = [b[i] for b in conv.blocks]
    ssm_i = [b[i] for b in ssm.blocks]
    conv_whole = model_whole(mesh, conv.spec[1:], conv_i)
    ssm_spec = P(*ssm.spec[1:])
    state_ssm = ssm_i if lay.ssm_heads else \
        model_whole(mesh, ssm_spec, ssm_i)
    state = [{"ssm": s, "conv": c} for s, c in zip(state_ssm, conv_whole)]
    xs, sts, tails = step(xs, lws, state)
    for p in range(mesh.size):
        csl = pm.block_slices(conv.shape[1:], P(*conv.spec[1:]), mesh, p)
        conv_i[p].copy_(tails[p][(slice(None),) * 2 + (csl[2],)])
        st = sts[p]
        lo = held_heads(cfg, lay, mesh, p)[0]
        hsl = pm.block_slices(ssm.shape[1:], ssm_spec, mesh, p)[1]
        st = st[:, hsl.start - lo:hsl.stop - lo]
        if ssm.dtype == torch.float32:
            ssm_i[p].copy_(st)
        else:
            new_ssm[p].append(st)
    return xs
