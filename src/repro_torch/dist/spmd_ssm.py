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
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P
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


def _take(w: torch.Tensor, dim: int,
          ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The (start, length) ranges of ``w``'s ``dim``, concatenated in
    order."""
    return torch.cat([w.narrow(dim, start, n) for start, n in ranges], dim)


def _mamba_fn(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout,
              specs: Dict[str, P], impl: str):
    """One Mamba-2 layer over every position (the lockstep body that
    ``cfg.remat`` checkpoints): ``xs`` one (b, S, D) residual a position,
    ``lws`` one dict of this layer's blocks a position; ``impl`` the SSD's
    route."""
    n = mesh.size
    di, sn, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, \
        cfg.ssm_headdim
    hl = h // lay.tp if lay.ssm_heads else h
    dl = hl * hp

    def gathered(lws, name):
        return _whole(mesh, specs[name], [lw[name] for lw in lws])

    def whole_body(xs, lws):
        w = {name: gathered(lws, name) for name in specs}
        return [mamba2.mamba_block(cfg, {k: v[p] for k, v in w.items()},
                                   xs[p], impl=impl)[0] for p in range(n)]

    def body(xs, lws):
        ln = spmd._local(mesh, specs["ln"], [lw["ln"] for lw in lws])
        w_in, conv_w, conv_b = (gathered(lws, k)
                                for k in ("w_in", "conv_w", "conv_b"))
        heads = {k: spmd._local(mesh, specs[k], [lw[k] for lw in lws], (0,))
                 for k in _HEAD_LEAVES}
        gs = []
        for p in range(n):
            a = spmd._model_index(mesh, p)
            cols = [(a * dl, dl), (di + a * dl, dl), (2 * di, 2 * sn),
                    (2 * di + 2 * sn + a * hl, hl)]
            chans = [(a * dl, dl), (di, 2 * sn)]
            xn = L.rms_norm(xs[p], ln[p], cfg.norm_eps)
            z, xin, bb, cc, dt, _ = mamba2.mix_in(
                xn, _take(w_in[p], 1, cols), _take(conv_w[p], 1, chans),
                _take(conv_b[p], 0, chans), dl, sn, hl)
            y, _ = mamba2.ssd_skip(cfg, {k: v[p] for k, v in heads.items()},
                                   xin, dt, bb, cc, impl)
            gs.append(y * F.silu(z))
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
        return [x + o.to(x.dtype) for x, o in zip(xs, out)]

    return body if lay.ssm_heads else whole_body


def run_backbone(cfg: ModelConfig, mesh: Mesh, lay: spmd.Layout, params,
                 xs: List[torch.Tensor], attn_impl: str, ssd_impl: str,
                 remat: bool) -> List[torch.Tensor]:
    """The Mamba-2 layers of ``params["layers"]`` (``Sharded`` stacked on a
    leading layer dim) over every position in lockstep, each under
    ``cfg.remat`` when ``remat``; for the hybrid, the shared block before
    each group of ``attn_every`` of them.  ``xs`` one residual a
    position."""
    layers = params["layers"]
    specs = {name: P(*st.spec[1:]) for name, st in layers.items()}
    stacked = [{name: st.blocks[p].unbind(0) for name, st in layers.items()}
               for p in range(mesh.size)]
    body = _mamba_fn(cfg, mesh, lay, specs, ssd_impl)
    step = T._remat(body, cfg.remat) if remat else body

    def run(lo: int, hi: int, xs):
        for i in range(lo, hi):
            xs = step(xs, [{name: w[i] for name, w in st.items()}
                           for st in stacked])
        return xs

    if cfg.family == "ssm":
        return run(0, cfg.n_layers, xs)
    shared = params["shared_attn"]
    devs = mesh.device_list
    arange = {d: torch.arange(xs[0].shape[1], device=d) for d in set(devs)}
    block = spmd._layer_fn(hybrid._dense_view(cfg), mesh, lay,
                           {name: st.spec for name, st in shared.items()},
                           [arange[d] for d in devs], attn_impl, fused=False)
    shared_blocks = [{name: st.blocks[p] for name, st in shared.items()}
                     for p in range(mesh.size)]
    ae = cfg.attn_every
    for g in range(hybrid.n_groups(cfg)):
        xs = run(g * ae, (g + 1) * ae, block(xs, shared_blocks))
    return xs
