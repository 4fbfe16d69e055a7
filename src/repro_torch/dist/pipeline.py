"""MPMD pipeline runner (counterpart of ``repro/dist/pipeline.py``).

Each pipeline stage runs its own programs (forward, backward, optimizer
update) on its own devices, and activations and their gradients move
between stages by copies.  ``even_stages(cfg, tps=[2, 1])`` splits the
layers over two stages, the first at tp 2.  Stage ``i`` holds the
('data', 'model') mesh ``data_model_mesh(st.dp, st.tp, devices[off:off +
st.n_devices])``, its devices taken in order as the reference takes them.

* A one-device stage holds plain tensors and runs the stage body
  (``_stage_apply``) on its device, eagerly or as CUDA graphs.
* A stage of more positions (a mesh stage) holds its params, AdamW
  state and gradient buffers as ``placement.Sharded`` trees laid out by
  ``param_specs(stage_decls(cfg, st), policy, mesh)`` and runs the same
  body through ``dist/spmd.py``'s lockstep layer (the unfused seam,
  ``ln_f``, the head and the vocab-parallel CE), eagerly.  Its block
  gradients are summed over their replicas after the microbatches
  (``placement.replica_group_sum``) and its update is
  ``optimizer.apply_sharded_updates``, clipped by the stage's own norm.

Devices: one per mesh position, ``cuda:0 ... cuda:{n-1}`` by default (the
reference's ``jax.devices()`` prefix).  A caller may repeat a device
(``[cuda:0] * 3``): the positions then run on it in turn, which is how a
``[2, 1]`` plan runs on one card.

Stage boundaries (``_to_stage``): an activation, the labels and an
activation's gradient are laid out on the receiving stage as the
reference lays them out, by ``batch_spec(mesh, B)`` (the batch split over
'data' where dp divides it, whole elsewhere): a sharded one is gathered
from its owners (index 0 on every replica axis) and re-split.  What a
stage keeps is always a copy.  Autograd through a mesh stage gives each
'model' copy of its input only its own path's share of the gradient, so
the gradient sent back is the sum over the input's 'model' group, in
group order; the gradient received is fed to the owners of the output,
the copies the next stage read.

Schedule: microbatched 1F1B-style, at most ``n_stages`` microbatches in
flight; each backward recomputes its stage's forward from the stage input
kept by the forward, so only the stage inputs are retained.  Gradients
add up over microbatches in fp32 buffers, one per block (as the port's
single-device step does; the reference adds them in the params' dtype),
and the per-stage AdamW update runs in place where the params live.

Programs as CUDA graphs (``graphed=``, the servers' convention and the
counterpart of the reference's per-stage ``jax.jit``): None graphs the
one-device stages on a CUDA device and runs the others eagerly, True
graphs every stage (a CPU stage or a mesh stage raises), False runs every
stage eagerly.  A stage's graphs are ``graphs.GraphedShapes``: one graph
per (program, input shape), its first call eager, its second captured.
A graph writes its outputs into the same tensors at every replay, so
every input a stage keeps is a copy and losses are cloned.

Telemetry (``attach_telemetry``, the reference's sample schema and fault
injection): each stage program and transfer is timed from an idle card
(every CUDA device of the pipeline synchronized) to every CUDA device its
output lies on synchronized, where the reference blocks on its output
only: work dispatched before a span (the gradient sums) would otherwise
land in it.  ``step_time`` runs to the update's end on the card.
Detached, the step reads no clock and synchronizes nothing.

The pipeline matches the single-device step: running layers [0, k) then
[k, n) is running [0, n), and the loss and update math are
``models/model.py``'s and ``train/optimizer.py``'s.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.device import resolve_device
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.mesh import Mesh, data_model_mesh
from repro_torch.dist.sharding import (POLICIES, Decl, P, batch_spec,
                                       init_from_decls, param_specs)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import masked_ce_sums
from repro_torch.train import optimizer as opt_lib

@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: layers [start, stop) at (dp, tp)."""
    index: int
    start: int
    stop: int
    tp: int
    dp: int = 1
    first: bool = False
    last: bool = False

    @property
    def n_layers(self) -> int:
        return self.stop - self.start

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp


def even_stages(cfg: ModelConfig, tps: Sequence[int],
                dp: int = 1) -> List[Stage]:
    """Split ``cfg.n_layers`` as evenly as possible over ``len(tps)`` stages.

    Remainder layers go to the earliest stages.  Device-agnostic, so the
    planner can call it.
    """
    n_stages = len(tps)
    if not 1 <= n_stages <= cfg.n_layers:
        raise ValueError(f"{n_stages} stages for {cfg.n_layers} layers")
    base, rem = divmod(cfg.n_layers, n_stages)
    stages, start = [], 0
    for i, tp in enumerate(tps):
        stop = start + base + (1 if i < rem else 0)
        stages.append(Stage(index=i, start=start, stop=stop, tp=int(tp),
                            dp=int(dp), first=(i == 0),
                            last=(i == n_stages - 1)))
        start = stop
    return stages


def stage_decls(cfg: ModelConfig, stage: Stage) -> Dict[str, Any]:
    """Parameter declarations owned by one stage."""
    sub = dataclasses.replace(cfg, n_layers=stage.n_layers)
    d: Dict[str, Any] = {"layers": transformer.layer_decls(sub)}
    if stage.first:
        d["embed"] = Decl((cfg.vocab_size, cfg.d_model),
                          ("vocab", "embed"), init="embed")
    if stage.last:
        d["ln_f"] = Decl((cfg.d_model,), ("embed",), init="ones")
        d["lm_head"] = Decl((cfg.d_model, cfg.vocab_size),
                            ("embed", "vocab"), scale_dim=-2)
    return d


def _stage_view(full: Any, stage: Stage) -> Dict[str, Any]:
    """The stage's slice of a full params tree, as views."""
    out: Dict[str, Any] = {"layers": {
        k: v[stage.start:stage.stop] for k, v in full["layers"].items()}}
    for k in (("embed",) if stage.first else ()) + (
            ("ln_f", "lm_head") if stage.last else ()):
        out[k] = full[k]
    return out


def _slice_full_params(full: Any, stage: Stage,
                       device: torch.device) -> Dict[str, Any]:
    """The stage's slice of a full params tree, copied onto ``device``
    (a copy also where ``full`` lies there: the stage's in-place update
    must not write into ``full``)."""
    return pm.tree_map(lambda _, t: t.to(device, copy=True),
                       _stage_view(full, stage))


def _stage_apply(cfg: ModelConfig, stage: Stage, params, x):
    """Stage forward: tokens (first) or hidden states -> hidden states:
    ``attn_block`` then ``ffn_block`` a layer, unfused, each layer under
    ``cfg.remat`` when a gradient will be taken."""
    if stage.first:
        x = transformer.embed(cfg, params, x)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    impl = L.pick_attn_impl(cfg.attn_impl, s, x.device)

    def body(h, lp):
        h, _ = transformer.attn_block(cfg, lp, h, positions, impl)
        return transformer.ffn_block(cfg, lp, h)

    step = transformer._remat(body, cfg.remat) \
        if transformer._needs_grad(params) else body
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(stage.n_layers):
        x = step(x, {name: w[i] for name, w in stacked.items()})
    if stage.last:
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x


def _stage_loss(cfg: ModelConfig, stage: Stage, params, x, labels):
    """Last-stage tail: layers + final norm + head + masked CE
    (``model.masked_ce_sums``, the single-device loss's math)."""
    h = _stage_apply(cfg, stage, params, x)
    logits = (h @ params["lm_head"].to(h.dtype)).float()
    nll_sum, n_tok, _ = masked_ce_sums(logits, labels)
    return nll_sum / torch.clamp_min(n_tok, 1)


def _leaves(params):
    """Detached leaves that share ``params``' storage, the gradients' leaves
    (as ``train_step.loss_and_grads_on_device`` takes them), and the tree
    of them."""
    paths, leaves = zip(*[(k, p.detach().requires_grad_())
                          for k, p in graphs.tree_leaves(params)])
    return paths, leaves, opt_lib.tree_unflatten(zip(paths, leaves))


def stage_programs(cfg: ModelConfig, stage: Stage,
                   opt_cfg: opt_lib.OptimizerConfig) -> Dict[str, Callable]:
    """The stage's three programs (the reference's ``_build_programs``):
    ``fwd(p, x)``; ``bwd``, which recomputes the forward with autograd:
    ``bwd_last(p, x, labels) -> (loss, grads, gx)`` (gx None on a single
    stage, whose x is tokens), ``bwd_mid(p, x, gy) -> (grads, gx)``,
    ``bwd_first(p, x, gy) -> grads``; and ``update(p, o, g)``, the in-place
    AdamW step, which keeps ``o["step"]`` the tensor it was (the counterpart
    of the reference's donated update).  None of them syncs with the host,
    so each can be captured as a CUDA graph."""
    def fwd(p, x):
        with torch.no_grad():
            return _stage_apply(cfg, stage, p, x)

    def bwd_last(p, x, labels):
        paths, leaves, tree = _leaves(p)
        if stage.first:
            loss = _stage_loss(cfg, stage, tree, x, labels)
            grads = torch.autograd.grad(loss, leaves)
            return (loss.detach(),
                    opt_lib.tree_unflatten(zip(paths, grads)), None)
        xl = x.detach().requires_grad_()
        loss = _stage_loss(cfg, stage, tree, xl, labels)
        *grads, gx = torch.autograd.grad(loss, leaves + (xl,))
        return loss.detach(), opt_lib.tree_unflatten(zip(paths, grads)), gx

    def bwd_mid(p, x, gy):
        paths, leaves, tree = _leaves(p)
        xl = x.detach().requires_grad_()
        y = _stage_apply(cfg, stage, tree, xl)
        *grads, gx = torch.autograd.grad(y, leaves + (xl,), gy)
        return opt_lib.tree_unflatten(zip(paths, grads)), gx

    def bwd_first(p, x, gy):
        paths, leaves, tree = _leaves(p)
        y = _stage_apply(cfg, stage, tree, x)
        grads = torch.autograd.grad(y, leaves, gy)
        return opt_lib.tree_unflatten(zip(paths, grads))

    def update(p, o, g):
        step = o["step"]
        try:
            opt_lib.apply_updates(p, g, o, opt_cfg)
            step.copy_(o["step"])
        finally:
            o["step"] = step

    if stage.last:
        bwd = bwd_last
    elif stage.first:
        bwd = bwd_first
    else:
        bwd = bwd_mid
    return {"fwd": fwd, "bwd": bwd, "update": update}


def _mesh_stage_apply(cfg: ModelConfig, stage: Stage, mesh: Mesh, params,
                      x: pm.Sharded):
    """``_stage_apply`` on ``mesh`` in lockstep (``dist/spmd.py``), up to
    the last layer: ``x`` the tokens (first stage) or hidden states laid
    out by ``batch_spec``; returns one hidden-state block a position and
    the ``spmd.Layout``.  Each layer runs under ``cfg.remat`` when a
    gradient will be taken."""
    b, s = x.shape[:2]
    lay = spmd.layout(cfg, params, mesh, b, s)
    impl = L.pick_attn_impl(cfg.attn_impl, s, mesh.device_list[0])
    xs = spmd._embed(cfg, mesh, lay, params, x.blocks) if stage.first \
        else list(x.blocks)
    remat = torch.is_grad_enabled() and any(
        blk.requires_grad for _, t in pm.tree_items(params)
        for blk in t.blocks)
    return spmd.run_layers(cfg, mesh, lay, params["layers"], xs, impl, remat,
                           fused=False), lay


def _sharded_leaves(params):
    """``_leaves`` for a tree of ``Sharded``: (paths, leaves whose blocks
    are detached and require grad, the tree of them, their blocks)."""
    paths, leaves = zip(*[
        (k, x.with_blocks([b.detach().requires_grad_() for b in x.blocks]))
        for k, x in pm.tree_items(params)])
    blocks = [b for x in leaves for b in x.blocks]
    return paths, leaves, opt_lib.tree_unflatten(zip(paths, leaves)), blocks


def _block_grads(paths, leaves, grads) -> Dict[str, Any]:
    """The tree of ``Sharded`` gradients from autograd's flat list (a block
    no counted position reads gets None)."""
    out, start = [], 0
    for x in leaves:
        n = len(x.blocks)
        out.append(x.with_blocks(list(grads[start:start + n])))
        start += n
    return opt_lib.tree_unflatten(zip(paths, out))


def _input_grad(x: pm.Sharded, grads) -> pm.Sharded:
    """The gradient of a stage input: each position's share (None where its
    path reaches no counted loss) summed over its 'model' group in group
    order, never over 'data' (whose positions hold other sequences)."""
    blocks = [torch.zeros_like(b) if g is None else g
              for b, g in zip(x.blocks, grads)]
    return x.with_blocks(pm.all_reduce_sum(blocks, x.mesh, spmd.MODEL))


def mesh_stage_programs(cfg: ModelConfig, stage: Stage,
                        opt_cfg: opt_lib.OptimizerConfig,
                        mesh: Mesh) -> Dict[str, Callable]:
    """``stage_programs`` for a stage on a mesh of more than one position:
    params a tree of ``Sharded``; ``x``, ``gy`` and ``labels`` ``Sharded``
    laid out by ``batch_spec(mesh, B)``.  ``fwd`` returns the hidden
    states as a ``Sharded`` of that layout (every 'model' copy equal); the
    backward programs take the gradient of the output at its owners (the
    copies the next stage reads), and return the parameter gradients as
    ``Sharded`` trees (one block a position, not yet summed over
    replicas) and the input's gradient (``_input_grad``); ``update`` is
    ``apply_sharded_updates`` in place.  Eager only."""
    def hidden(x, xs):
        return pm.Sharded((*x.shape[:2], cfg.d_model),
                          P(x.spec[0], None, None), mesh, xs)

    def requires_grad(x):
        return x.with_blocks([b.detach().requires_grad_() for b in x.blocks])

    def fwd(p, x):
        with torch.no_grad():
            xs, _ = _mesh_stage_apply(cfg, stage, mesh, p, x)
            if stage.last:
                xs = spmd.final_norm(cfg, mesh, p, xs)
        return hidden(x, xs)

    def bwd_last(p, x, labels):
        paths, leaves, tree, blocks = _sharded_leaves(p)
        xin = x if stage.first else requires_grad(x)
        xs, lay = _mesh_stage_apply(cfg, stage, mesh, tree, xin)
        loss, _ = spmd.ce_loss(mesh, lay,
                               spmd.head_logits(cfg, mesh, lay, tree, xs),
                               labels.blocks)
        ins = blocks if stage.first else blocks + xin.blocks
        gs = torch.autograd.grad(loss, ins, allow_unused=True)
        gx = None if stage.first else _input_grad(xin, gs[len(blocks):])
        return loss.detach(), _block_grads(paths, leaves, gs), gx

    def backward(p, x, gy, with_input):
        paths, leaves, tree, blocks = _sharded_leaves(p)
        xin = requires_grad(x) if with_input else x
        xs, _ = _mesh_stage_apply(cfg, stage, mesh, tree, xin)
        own = pm.owners(gy.spec, mesh)
        ins = blocks + xin.blocks if with_input else blocks
        gs = torch.autograd.grad([xs[q] for q in own], ins,
                                 [gy.blocks[q] for q in own],
                                 allow_unused=True)
        grads = _block_grads(paths, leaves, gs)
        if not with_input:
            return grads
        return grads, _input_grad(xin, gs[len(blocks):])

    def update(p, o, g):
        opt_lib.apply_sharded_updates(p, g, o, opt_cfg)

    bwd = bwd_last if stage.last else functools.partial(
        backward, with_input=not stage.first)
    return {"fwd": fwd, "bwd": bwd, "update": update}


def _tensors(tree) -> List[Optional[torch.Tensor]]:
    """Every tensor of a tree whose leaves are tensors or ``Sharded`` (a
    leaf's blocks in position order), in path order."""
    out: List[Optional[torch.Tensor]] = []
    for _, x in pm.tree_items(tree):
        out.extend(x.blocks if isinstance(x, pm.Sharded) else [x])
    return out


def _full(x) -> torch.Tensor:
    """A leaf as a whole tensor: a ``Sharded`` one gathered to the CPU."""
    return pm.unshard(x, "cpu") if isinstance(x, pm.Sharded) else x


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """Copy a gradient leaf (a tensor or ``Sharded``, on any device) into a
    buffer leaf of the same logical shape."""
    if not isinstance(dst, pm.Sharded):
        dst.copy_(pm.unshard(src, dst.device)
                  if isinstance(src, pm.Sharded) else src)
        return
    full = _full(src)
    for pos, blk in enumerate(dst.blocks):
        blk.copy_(full[pm.block_slices(dst.shape, dst.spec, dst.mesh, pos)])


def _cuda_devices(out: Any) -> set:
    """The CUDA devices a stage output's tensors lie on: a tensor, a
    ``Sharded`` (every block's), or a tuple, list or dict of them."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, pm.Sharded):
        return {b.device for b in out.blocks if b.is_cuda}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*map(_cuda_devices, out))
    return set()


def _synchronize(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def _default_devices() -> List[torch.device]:
    resolve_device(None)            # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class MPMDPipeline:
    """Multi-program multi-data pipeline over per-stage meshes.

    Supports the dense and MoE families with untied embeddings (a mesh
    stage places the experts as ``dist/spmd.py`` does); stage 0 owns the
    embedding table, the last stage owns the final norm + LM head.
    ``devices`` (one ``torch.device`` a mesh position, stages in order; a
    device may repeat), ``policy`` (the sharding policy of the mesh
    stages' params; a no-op for one-device stages, as the reference's on
    a one-device mesh) and ``graphed`` are described in the module
    docstring.  ``meshes[i]`` is stage ``i``'s mesh.
    """

    def __init__(self, cfg: ModelConfig, stages: Sequence[Stage],
                 opt_cfg: opt_lib.OptimizerConfig,
                 devices: Optional[Sequence] = None,
                 policy: str = "fsdp_tp", graphed: Optional[bool] = None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"MPMD pipeline supports the dense and moe families, not "
                f"{cfg.family!r}")
        if cfg.tie_embeddings:
            raise NotImplementedError(
                "tied embeddings span first+last stage; untie for MPMD")
        if stages[0].start != 0 or stages[-1].stop != cfg.n_layers:
            raise ValueError(f"stages do not cover [0, {cfg.n_layers})")
        for a, b in zip(stages, stages[1:]):
            if a.stop != b.start:
                raise ValueError(f"stages not contiguous: [{a.start},{a.stop})"
                                 f" then [{b.start},{b.stop})")
        if (not stages[0].first or not stages[-1].last
                or any(s.first for s in stages[1:])
                or any(s.last for s in stages[:-1])):
            raise ValueError("stage first/last flags inconsistent with order")
        # with one device a stage every policy places every tensor whole
        if policy not in POLICIES:
            raise KeyError(f"unknown sharding policy {policy!r}; "
                           f"known: {sorted(POLICIES)}")
        self.cfg = cfg
        self.stages = list(stages)
        self.opt_cfg = opt_cfg
        devices = _default_devices() if devices is None else \
            [torch.device(d) for d in devices]
        need = sum(st.n_devices for st in self.stages)
        if need > len(devices):
            raise ValueError(f"plan needs {need} devices, "
                             f"have {len(devices)}")
        self.devices: List[torch.device] = devices[:need]
        self.meshes: List[Mesh] = []
        off = 0
        for st in self.stages:
            self.meshes.append(data_model_mesh(
                st.dp, st.tp, self.devices[off:off + st.n_devices]))
            off += st.n_devices
        self._specs = [param_specs(stage_decls(cfg, st), policy, m)
                       if st.n_devices > 1 else None
                       for st, m in zip(self.stages, self.meshes)]
        if graphed:
            for st in self.stages:
                if st.n_devices > 1:
                    raise ValueError(
                        f"MPMDPipeline(graphed=True): stage {st.index} is a "
                        f"mesh stage (dp={st.dp}, tp={st.tp}), which runs "
                        f"eagerly; pass graphed=None or False")
        if graphed and any(d.type != "cuda" for d in self.devices):
            raise ValueError(f"MPMDPipeline(graphed=True): a CUDA graph "
                             f"needs every stage on a CUDA device, got "
                             f"{[str(d) for d in self.devices]}")
        self.graphed = graphed
        self.params: Optional[List[Any]] = None
        self.opt_states: Optional[List[Any]] = None
        self._acc: List[Any] = []
        self._programs = [
            mesh_stage_programs(cfg, st, opt_cfg, m) if st.n_devices > 1
            else stage_programs(cfg, st, opt_cfg)
            for st, m in zip(self.stages, self.meshes)]
        self.graphs: List[Optional[graphs.GraphedShapes]] = []
        self._static: List[Dict[Any, List[torch.Tensor]]] = []
        self._telemetry = None          # TelemetryBus (attach_telemetry)
        self._injector = None           # telemetry.FaultInjector
        self._tel_zones: List[str] = []
        self._tel_step = 0

    # --- telemetry (opt-in; nothing added when detached) -----------------------

    def attach_telemetry(self, bus, injector=None,
                         zones: Optional[Sequence[str]] = None) -> None:
        """Stream per-microbatch timings onto a ``telemetry.TelemetryBus``.

        When attached, ``train_step`` times every per-stage forward /
        backward program and inter-stage transfer, each from an idle card
        to its output's devices synchronized (so timings are the card's
        work, not dispatch), and emits the shared sample schema —
        ``fwd_time``/``bwd_time`` keyed ``(stage, 0)``, ``p2p_time`` keyed
        ``(stage, stage+1, 0, 0)``, per-stage heartbeats, and
        ``step_time`` — then closes the step with ``bus.end_step``.
        ``zones`` labels each stage's pool in the sample meta (defaults
        to ``stage<i>``) so detectors and the RCA layer can map streams
        to cluster coordinates.  ``injector`` (a
        ``telemetry.FaultInjector``) perturbs the *real* pipeline: active
        compute-delay/link-degrade faults matching a stage's zone sleep
        the corresponding extra seconds, and hung stages stop
        heartbeating.  Attached, the step adds synchronizations and host
        sleeps only: the same launches, graphs and losses as detached.
        """
        self._telemetry = bus
        self._injector = injector
        self._tel_zones = list(zones) if zones is not None else \
            [f"stage{i}" for i in range(len(self.stages))]
        self._tel_step = 0

    def _emit(self, metric: str, key, value: float, **meta) -> None:
        from repro_torch.telemetry.bus import Sample, wall_clock
        self._telemetry.emit(Sample(metric, key, wall_clock(),
                                    self._tel_step, value, meta))

    def _idle(self) -> None:
        """Wait for every card the pipeline runs on."""
        _synchronize({d for d in self.devices if d.type == "cuda"})

    def _timed(self, fn, metric: str, key, zone: str, acc: str = "host",
               **meta):
        """Run ``fn`` from an idle card, wait for its output, emit its wall
        seconds; inject fault delay."""
        self._idle()
        t0 = time.perf_counter()
        out = fn()
        _synchronize(_cuda_devices(out))
        dt = time.perf_counter() - t0
        if self._injector is not None:
            if metric in ("fwd_time", "bwd_time"):
                extra = self._injector.compute_delay_s(
                    self._tel_step, zone, acc, dt)
            elif metric == "p2p_time":
                extra = dt * (self._injector.link_factor(
                    self._tel_step, zone, meta.get("zone_b", "")) - 1.0)
            else:
                extra = 0.0
            if extra > 0:
                time.sleep(extra)
                dt += extra
        self._emit(metric, key, dt, zone=zone, acc_type=acc, **meta)
        return out

    def _span(self, fn, metric: str, key, stage: int,
              to: Optional[int] = None):
        """``fn()``; with a bus attached, timed (``_timed``) as ``metric``
        in stage ``stage``'s zone (a transfer: towards stage ``to``'s)."""
        if self._telemetry is None:
            return fn()
        meta = {} if to is None else {"zone_b": self._tel_zones[to]}
        return self._timed(fn, metric, key, self._tel_zones[stage], **meta)

    # --- parameter loading -----------------------------------------------------

    def _on_mesh(self, i: int) -> bool:
        return self.stages[i].n_devices > 1

    def _device(self, i: int) -> torch.device:
        """Stage ``i``'s device (its mesh's first position's)."""
        return self.meshes[i].device_list[0]

    def _loaded(self, params: List[Any]) -> None:
        """Optimizer state, gradient buffers and each stage's graphs for
        freshly loaded params (graphs are bound to the params' storage)."""
        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

        self.params = params
        self.opt_states, self._acc = [], []
        for i, p in enumerate(params):
            if self._on_mesh(i):
                self.opt_states.append(opt_lib.init_sharded_state(p))
                self._acc.append(pm.tree_map(
                    lambda _, x: x.with_blocks([zeros(b) for b in x.blocks]),
                    p))
            else:
                self.opt_states.append(opt_lib.init_state(p))
                self._acc.append(opt_lib.tree_unflatten(
                    (k, zeros(t)) for k, t in graphs.tree_leaves(p)))
        self.graphs, self._static = [], []
        for i, p in enumerate(params):
            dev = self._device(i)
            on = (dev.type == "cuda" and not self._on_mesh(i)) \
                if self.graphed is None else self.graphed
            g = None
            if on:
                g = graphs.GraphedShapes(p, f"pipeline stage {i}")
                # made before any capture (they cannot be made inside one)
                fused_mod.ticket_counters(g.device, g.stream)
                fa.bwd_ticket_counters(g.device, g.stream)
            self.graphs.append(g)
            self._static.append({})

    def _place(self, i: int, params: Any) -> Any:
        """A mesh stage's full params laid out on its mesh (copies)."""
        return pm.shard_tree(params, self._specs[i], self.meshes[i])

    def full_params_like(self, full: Any) -> Any:
        """Load a full single-program params tree (the port's layout, as
        ``bridge.params_from_numpy`` makes it) into the pipeline: each stage
        gets a copy of its slice on its device (a mesh stage: laid out on
        its mesh), and fresh AdamW state.  Returns ``full`` unchanged (the
        stages never write into it), so a single-program reference can run
        on the same weights."""
        self._loaded([
            self._place(i, _stage_view(full, st)) if self._on_mesh(i)
            else _slice_full_params(full, st, self._device(i))
            for i, st in enumerate(self.stages)])
        return full

    def init_params(self, seed: int) -> None:
        """Seeded per-stage params (no full copy): stage i draws from its
        own ``torch.Generator`` on its device, seeded by the i-th child of
        ``np.random.SeedSequence(seed)`` (the reference splits its key);
        a mesh stage then lays its tensors out on its mesh, so one seed
        gives the same logical params whatever the stages' (dp, tp)."""
        kids = np.random.SeedSequence(seed).spawn(len(self.stages))
        params = []
        for i, (st, kid) in enumerate(zip(self.stages, kids)):
            dev = self._device(i)
            gen = torch.Generator(device=dev).manual_seed(
                int(kid.generate_state(1)[0]))
            p = init_from_decls(stage_decls(self.cfg, st), gen,
                                self.cfg.param_dtype, dev)
            params.append(self._place(i, p) if self._on_mesh(i) else p)
        self._loaded(params)

    # --- programs and transfers ------------------------------------------------

    def _run(self, i: int, name: str, *inputs):
        """Stage ``i``'s program ``name`` on its params: eagerly, or through
        the stage's graph for these input shapes (the inputs copied into
        the graph's static buffers first)."""
        prog = self._programs[i][name]
        g = self.graphs[i]
        if name == "update":    # reads the stage's gradient buffers
            def update():
                return prog(self.params[i], self.opt_states[i], self._acc[i])
            return update() if g is None else g.run(
                (name,), update, f" at stage {i} update")
        if g is None:
            return prog(self.params[i], *inputs)
        key = (name,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        static = self._static[i].get(key)
        if static is None:
            static = self._static[i][key] = [torch.empty_like(t)
                                             for t in inputs]
        for s, t in zip(static, inputs):
            s.copy_(t)
        return g.run(key, lambda: prog(self.params[i], *static),
                     f" at stage {i} {name} {[tuple(t.shape) for t in inputs]}")

    def _to_stage(self, idx: int, arr):
        """A copy of ``arr`` (numpy, a tensor, or a ``Sharded`` of another
        stage) on stage ``idx``: on its device, or laid out on its mesh by
        ``batch_spec`` (a ``Sharded`` source gathered from its owners
        first); a copy also where it already lies there: what the schedule
        keeps must not be a graph's output, which its next replay
        overwrites."""
        dev = self._device(idx)
        if isinstance(arr, pm.Sharded):
            full = pm.unshard(arr, dev)
        else:
            full = torch.as_tensor(arr)
            if not self._on_mesh(idx):
                return full.to(dev, copy=True)
        if not self._on_mesh(idx):
            return full
        mesh = self.meshes[idx]
        return pm.shard(full, batch_spec(mesh, full.shape[0]), mesh)

    # --- the step --------------------------------------------------------------

    def _forward_micro(self, tokens) -> Dict[str, Any]:
        """Run one microbatch through every stage; keep per-stage inputs
        (backward recomputes the stage forward from them)."""
        inputs = []
        x = tokens
        for i in range(len(self.stages)):
            x = self._to_stage(0, x) if i == 0 else self._span(
                lambda x=x, i=i: self._to_stage(i, x),
                "p2p_time", (i - 1, i, 0, 0), i - 1, to=i)
            inputs.append(x)
            x = self._span(lambda i=i, x=x: self._run(i, "fwd", x),
                           "fwd_time", (i, 0), i)
        return {"inputs": inputs}

    def _backward_micro(self, ctx: Dict[str, Any], labels):
        """Reverse sweep; returns (loss, per-stage grads)."""
        n = len(self.stages)
        grads: List[Any] = [None] * n
        labels = self._to_stage(n - 1, labels)
        loss, grads[n - 1], gx = self._span(
            lambda: self._run(n - 1, "bwd", ctx["inputs"][n - 1], labels),
            "bwd_time", (n - 1, 0), n - 1)
        for i in range(n - 2, 0, -1):
            gx = self._span(lambda gx=gx, i=i: self._to_stage(i, gx),
                            "p2p_time", (i, i + 1, 0, 0), i, to=i + 1)
            grads[i], gx = self._span(
                lambda i=i, gx=gx: self._run(i, "bwd", ctx["inputs"][i], gx),
                "bwd_time", (i, 0), i)
        if n > 1:
            gx = self._span(lambda gx=gx: self._to_stage(0, gx),
                            "p2p_time", (0, 1, 0, 0), 0, to=1)
            grads[0] = self._span(
                lambda gx=gx: self._run(0, "bwd", ctx["inputs"][0], gx),
                "bwd_time", (0, 0), 0)
        return loss, grads

    @torch.no_grad()
    def _accumulate(self, grads: List[Any], wm: Optional[float],
                    first: bool) -> None:
        for acc, g in zip(self._acc, grads):
            for a, gi in zip(_tensors(acc), _tensors(g), strict=True):
                if gi is None:          # a block no counted position read
                    if first:
                        a.zero_()
                    continue
                if wm is not None:
                    gi = gi.float() * wm
                if first:
                    a.copy_(gi)
                else:
                    a.add_(gi)

    @torch.no_grad()
    def _replica_sums(self) -> None:
        """Each mesh stage's block gradients summed over their replicas,
        in place (``train_step.sharded_loss_and_grads``' last step)."""
        for i, acc in enumerate(self._acc):
            if not self._on_mesh(i):
                continue
            for _, x in pm.tree_items(acc):
                for dst, src in zip(x.blocks,
                                    pm.replica_group_sum(x).blocks):
                    if src is not dst:
                        dst.copy_(src)

    def grad_step(self, batch: Dict[str, Any],
                  weights: Optional[Sequence[float]] = None):
        """Forward/backward over a (num_micro, batch, seq) token batch
        WITHOUT applying the optimizer update.

        Returns ``(loss, grads)``, ``grads`` the per-stage combined
        gradient trees: the pipeline's fp32 gradient buffers (``Sharded``
        trees on a mesh stage, every replica of a block equal), which the
        next ``grad_step`` overwrites.  ``weights=None`` averages
        microbatches uniformly (``g = (1/M) sum_m g_m``).  With ``weights``
        given, microbatch ``m`` contributes ``weights[m] * g_m`` and the
        loss is the same weighted sum (float64 on the host) — the adaptive
        combine where microbatch ``m`` of ``b_m`` samples carries ``w_m =
        b_m / B``.  Weights may sum to less than 1 when a DP group
        (:class:`AdaptiveDPGroup`) normalizes across its replicas.  The
        losses are read back once, at the end.
        """
        if self.params is None:
            raise RuntimeError("load parameters first (full_params_like / "
                               "init_params)")
        tokens, labels = batch["tokens"], batch["labels"]
        num_micro = tokens.shape[0]
        n = len(self.stages)
        w = None
        if weights is not None:
            w = np.asarray(weights, dtype=np.float32)
            if w.shape != (num_micro,):
                raise ValueError(f"weights shape {w.shape} does not match "
                                 f"{num_micro} microbatches")
        losses: List[torch.Tensor] = []

        # 1F1B-style: bound in-flight microbatches by the stage count; each
        # backward drains the oldest pending forward.
        pending: collections.deque = collections.deque()
        next_mb = 0
        while next_mb < num_micro or pending:
            if next_mb < num_micro and len(pending) < n:
                pending.append(
                    (next_mb, self._forward_micro(tokens[next_mb])))
                next_mb += 1
            else:
                mb, ctx = pending.popleft()
                loss, grads = self._backward_micro(ctx, labels[mb])
                losses.append(loss.clone())    # a graph output: kept apart
                self._accumulate(grads, None if w is None else float(w[mb]),
                                 first=len(losses) == 1)

        host = torch.stack(losses).cpu().numpy()
        if w is None:
            inv = 1.0 / num_micro
            with torch.no_grad():
                for acc in self._acc:
                    for a in _tensors(acc):
                        a.mul_(inv)
            loss = float(np.sum(host) * inv)
        else:
            loss = float(np.sum(host.astype(np.float64)
                                * w.astype(np.float64)))
        self._replica_sums()
        return loss, list(self._acc)

    def apply_grads(self, grads: Sequence[Any]) -> None:
        """Apply per-stage gradient trees (tensors on any device, or
        ``Sharded``) through the stage optimizers — the update half of
        :meth:`train_step`.  Trees other than the pipeline's own buffers
        are copied into them first (a whole tensor into a mesh stage's
        buffers block by block)."""
        if self.params is None:
            raise RuntimeError("load parameters first (full_params_like / "
                               "init_params)")
        for i in range(len(self.stages)):
            if grads[i] is not self._acc[i]:
                for (_, a), (_, g) in zip(pm.tree_items(self._acc[i]),
                                          pm.tree_items(grads[i]),
                                          strict=True):
                    _copy_into(a, g)
            self._run(i, "update")

    def train_step(self, batch: Dict[str, Any],
                   weights: Optional[Sequence[float]] = None) -> float:
        """One optimizer step over a (num_micro, batch, seq) token batch.

        Returns the mean over microbatches of the per-microbatch masked
        mean loss, at the pre-update parameters — the normalization of the
        single-program ``train_step.loss_and_grads``.  With ``weights``,
        gradient accumulation and the loss use the given per-microbatch
        weights instead (see :meth:`grad_step`).  With telemetry
        attached, ``step_time`` runs to the update's end on the card.
        """
        tel = self._telemetry
        t_start = time.perf_counter() if tel is not None else 0.0
        out, grads = self.grad_step(batch, weights)
        self.apply_grads(grads)
        if tel is not None:
            from repro_torch.telemetry.bus import wall_clock
            self._idle()
            for i in range(len(self.stages)):
                zone = self._tel_zones[i]
                if self._injector is None or \
                        not self._injector.hung(self._tel_step, zone, "host"):
                    self._emit("heartbeat", (i, 0), 1.0, zone=zone,
                               acc_type="host",
                               chips=self.stages[i].n_devices)
            self._emit("step_time", (), time.perf_counter() - t_start)
            tel.end_step(self._tel_step, wall_clock())
            self._tel_step += 1
        return out


class AdaptiveDPGroup:
    """Data-parallel group of :class:`MPMDPipeline` replicas under an
    adaptive per-replica batch assignment.

    Replica ``r`` runs its OWN microbatch stack (``n_r`` microbatches of
    ``b_r`` sequences); gradients combine on the host with the unbiased
    weights ``w_r = b_r * n_r / B`` — inside a replica each microbatch
    carries ``w_r / n_r = b_r / B``, so the group total equals the
    full-batch mean gradient (up to float association).

    ``staleness=k`` opts into bounded-staleness sync: the combined
    gradient of step ``t`` is applied at step ``t + k`` (the first ``k``
    steps apply nothing).  ``k=0`` applies the current combined gradient
    immediately — the synchronous path.
    """

    def __init__(self, replicas: Sequence[MPMDPipeline],
                 weights: Optional[Sequence[float]] = None,
                 staleness: int = 0):
        if not replicas:
            raise ValueError("empty DP group")
        self.replicas = list(replicas)
        r = len(self.replicas)
        self.weights = [1.0 / r] * r if weights is None \
            else [float(x) for x in weights]
        if len(self.weights) != r:
            raise ValueError(f"{len(self.weights)} weights for {r} replicas")
        if staleness < 0:
            raise ValueError(f"staleness={staleness} (must be >= 0)")
        self.staleness = int(staleness)
        self._pending: collections.deque = collections.deque()

    @classmethod
    def from_assignment(cls, replicas: Sequence[MPMDPipeline], assignment,
                        staleness: int = 0) -> "AdaptiveDPGroup":
        """Group with weights from a planner ``plan.BatchAssignment``."""
        return cls(replicas, weights=list(assignment.weights()),
                   staleness=staleness)

    def train_step(self, batches: Sequence[Dict[str, Any]]) -> float:
        """One DP step: per-replica weighted grad accumulation over each
        replica's own (n_r, b_r, seq) stack, host-side weighted combine,
        delayed apply under bounded staleness.  Returns the group loss
        (the ``w_r``-weighted mean microbatch loss)."""
        if len(batches) != len(self.replicas):
            raise ValueError(f"{len(batches)} batches for "
                             f"{len(self.replicas)} replicas")
        loss = 0.0
        grads_per_rep: List[Sequence[Any]] = []
        for r, (rep, batch) in enumerate(zip(self.replicas, batches)):
            n_micro = batch["tokens"].shape[0]
            w_micro = [self.weights[r] / n_micro] * n_micro
            l_r, g_r = rep.grad_step(batch, weights=w_micro)
            loss += l_r
            grads_per_rep.append(g_r)
        self._pending.append(self._combine(grads_per_rep))
        if len(self._pending) > self.staleness:
            self._apply(self._pending.popleft())
        return loss

    def flush(self) -> int:
        """Apply every still-buffered combined gradient (end-of-training
        drain under ``staleness > 0``).  Returns how many were applied."""
        n = 0
        while self._pending:
            self._apply(self._pending.popleft())
            n += 1
        return n

    @staticmethod
    def _combine(grads_per_rep: Sequence[Sequence[Any]]) -> List[Any]:
        """Host-side sum of the replicas' already-weighted per-stage
        gradient trees, as fp32 CPU tensors added in replica order (the
        reference's ``np.add``); a ``Sharded`` leaf is gathered whole to
        the CPU first."""
        out: List[Any] = []
        for i in range(len(grads_per_rep[0])):
            acc = {k: _full(t).to("cpu", torch.float32, copy=True)
                   for k, t in pm.tree_items(grads_per_rep[0][i])}
            for g_r in grads_per_rep[1:]:
                for k, t in pm.tree_items(g_r[i]):
                    acc[k].add_(_full(t).to("cpu", torch.float32))
            out.append(opt_lib.tree_unflatten(acc.items()))
        return out

    def _apply(self, combined: List[Any]) -> None:
        for rep in self.replicas:
            rep.apply_grads(combined)


def shard_batch_by_assignment(batch: Dict[str, Any], assignment
                              ) -> List[Dict[str, Any]]:
    """Split a flat (B, seq) batch (numpy arrays or tensors) into
    per-replica (n_r, b_r, seq) microbatch stacks following a
    ``plan.BatchAssignment`` (contiguous split; exact conservation
    guarantees the slices tile the batch)."""
    out: List[Dict[str, Any]] = []
    off = 0
    for rb in assignment.replicas:
        take = rb.samples
        rep_batch = {}
        for k, v in batch.items():
            sl = v[off:off + take]
            rep_batch[k] = sl.reshape((rb.n_micro, rb.mbs) + tuple(
                sl.shape[1:]))
        out.append(rep_batch)
        off += take
    return out
