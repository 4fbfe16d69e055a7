"""Train step factory: microbatched gradient accumulation + AdamW update
(counterpart of the single-device half of ``repro/train/train_step.py``).

The step consumes a batch shaped ``(num_micro, micro_batch, seq)`` and
loops over the leading dim accumulating fp32 gradients, so only one
microbatch of activations is live at a time (``cfg.remat`` inside the
layer loop bounds it further).  Gradients come from
``torch.autograd.grad`` over the parameter leaves.

The mesh half (``mesh=`` a ``dist.mesh.Mesh``, ``batch_shardings``,
``jit_train_step``) takes params and AdamW moments as trees of
``dist.placement.Sharded`` laid out by ``param_specs(decls,
cfg.sharding, mesh)``, the step replicated, and the batch by
``batch_spec(mesh, micro_batch)``.  Each microbatch runs the sharded
forward and loss (``dist/spmd.py``) over every position in lockstep;
autograd gives each block its own path's gradient, and after the
microbatches each block's fp32 sum is summed over its replicas
(``placement.replica_group_sum``), which is the reference's gradient
all-reduce.  The update is ``optimizer.apply_sharded_updates``.
``jit_train_step`` runs it eagerly or, on a mesh whose positions all lie
on one card, as a CUDA graph (``GraphedShardedTrainStep``).  A ``mesh``
that is not a ``Mesh`` raises ``TypeError``.

A step is a host part (``device_inputs``: the batch onto the device) and
a device body (``train_step_on_device``; on a mesh
``sharded_train_step_on_device``) that makes no host sync.
``make_train_step`` runs both eagerly; ``make_graphed_train_step``, the
counterpart of ``jax.jit(make_train_step(...))``, captures the body once
as a CUDA graph and replays it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import graphs
from repro_torch.device import device_of
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.sharding import P, batch_spec, param_specs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.launch import program_cost as pc
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib


def microbatch_fields(cfg: ModelConfig) -> Tuple[str, ...]:
    fields = ["tokens", "labels"]
    if cfg.family == "encdec":
        fields.append("frames")
    if cfg.family == "vlm":
        fields.append("patches")
    return tuple(fields)


def device_inputs(cfg: ModelConfig, params, batch, micro_weights=None):
    """The host part of a step: the batch's fields (numpy arrays or
    tensors) and ``micro_weights`` as tensors on the params' device.
    Returns ``(batch, w)``, ``w`` None for the uniform path."""
    dev = device_of(params)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return batch, _weights(micro_weights, batch["tokens"].shape[0], dev)


def _weights(micro_weights, n_micro: int, dev) -> Optional[torch.Tensor]:
    if micro_weights is None:
        return None
    w = torch.as_tensor(micro_weights, dtype=torch.float32).to(dev)
    if tuple(w.shape) != (n_micro,):
        raise ValueError(f"micro_weights shape {tuple(w.shape)} != "
                         f"({n_micro},)")
    return w


def loss_and_grads_on_device(cfg: ModelConfig, params, batch, w=None):
    """The device body of ``loss_and_grads``: ``batch`` and ``w`` already on
    the params' device (``device_inputs``).  It makes no host sync, copies
    nothing to or from the host and branches on no tensor's value, so a
    CUDA graph can capture it.

    One microbatch with no weights returns its gradients as autograd
    gives them, in the params' dtype, with no fp32 copy: there is nothing
    to sum, and AdamW and the global norm take each gradient in fp32, so
    the update is the fp32 sum's bit for bit (``g.float()`` of a bf16
    ``g`` is exact) at the memory of one copy fewer (18 GB at dbrx-132b's
    one layer, 4.49 B params)."""
    n_micro = batch["tokens"].shape[0]
    dev = device_of(params)
    # detached leaves that share the caller's storage: the grads are taken
    # against them, and the caller's tensors need no requires_grad
    paths, leaves = zip(*[(k, p.detach().requires_grad_())
                          for k, p in opt_lib.tree_leaves(params)])
    tree = opt_lib.tree_unflatten(zip(paths, leaves))
    fields = microbatch_fields(cfg)
    if n_micro == 1 and w is None:
        loss, _ = model_lib.loss_fn(cfg, tree, {k: batch[k][0]
                                                for k in fields})
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), opt_lib.tree_unflatten(zip(paths, grads))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n_micro):
        mb = {k: batch[k][i] for k in fields}
        loss, _ = model_lib.loss_fn(cfg, tree, mb)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            wi = None if w is None else w[i]
            for a, g in zip(acc, grads):
                a.add_(g.float() if wi is None else wi * g.float())
            loss_sum = loss_sum + (loss.detach() if wi is None
                                   else wi * loss.detach())
    if w is None:
        inv = 1.0 / n_micro
        for a in acc:
            a.mul_(inv)
        loss_sum = loss_sum * inv
    return loss_sum, opt_lib.tree_unflatten(zip(paths, acc))


def loss_and_grads(cfg: ModelConfig, params, batch, mesh=None,
                   micro_weights=None):
    """Loop over microbatches, accumulating fp32 grads and mean loss.

    ``micro_weights`` (shape ``(num_micro,)``, summing to 1) weights each
    microbatch's gradient and loss instead of the uniform ``1/num_micro``
    (the single-mesh form of the adaptive-batching gradient weights).
    ``None`` is the exact uniform path.  Returns ``(loss, grads)``, grads
    a nested dict of fp32 tensors shaped like ``params`` (with one
    microbatch and no weights, in the params' dtype: see
    ``loss_and_grads_on_device``).  With ``mesh``,
    ``params`` is a tree of ``Sharded`` and so are the grads (each block
    the true gradient: ``sharded_loss_and_grads``).
    """
    if mesh is not None:
        mesh = spmd.check_mesh(mesh)
        return sharded_loss_and_grads(cfg, params, shard_batch(
            cfg, batch, mesh), mesh, micro_weights)
    batch, w = device_inputs(cfg, params, batch, micro_weights)
    return loss_and_grads_on_device(cfg, params, batch, w)


def train_step_on_device(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                         params, opt_state, batch, w=None):
    """One step's device body: ``loss_and_grads_on_device`` then the
    in-place AdamW update.  Returns ``(params, opt_state, metrics)``."""
    loss, grads = loss_and_grads_on_device(cfg, params, batch, w)
    params, opt_state, om = opt_lib.apply_updates(params, grads, opt_state,
                                                  opt_cfg)
    metrics: Dict[str, Any] = {"loss": loss, **om}
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                    mesh=None, micro_weights=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``{"loss", "grad_norm", "lr"}`` as 0-d tensors.  The
    update is in place (``optimizer.apply_updates``): the returned params
    and state are the ones passed in.  With ``mesh``, the sharded step
    (``sharded_train_step``)."""
    if mesh is not None:
        return sharded_train_step(cfg, opt_cfg, spmd.check_mesh(mesh),
                                  micro_weights)

    def train_step(params, opt_state, batch):
        batch, w = device_inputs(cfg, params, batch, micro_weights)
        return train_step_on_device(cfg, opt_cfg, params, opt_state, batch,
                                    w)

    return train_step


# --- the mesh half ---------------------------------------------------------------

def batch_shardings(cfg: ModelConfig, mesh, num_micro: int,
                    micro_batch: int) -> Dict[str, P]:
    """Specs of the (num_micro, micro_batch, ...) input batch's fields
    (the reference's ``NamedSharding``s, as specs)."""
    spec2 = batch_spec(mesh, micro_batch)
    out = {"tokens": P(None, spec2[0], None),
           "labels": P(None, spec2[0], None)}
    if cfg.family == "encdec":
        out["frames"] = P(None, spec2[0], None, None)
    if cfg.family == "vlm":
        out["patches"] = P(None, spec2[0], None, None)
    return out


def shard_batch(cfg: ModelConfig, batch, mesh) -> Dict[str, pm.Sharded]:
    """The batch's fields (numpy arrays, tensors, or ``Sharded`` already)
    laid out by ``batch_shardings``."""
    out = {}
    shape = tuple(batch["tokens"].shape)
    specs = batch_shardings(cfg, mesh, shape[0], shape[1])
    for k in microbatch_fields(cfg):
        v = batch[k]
        if not isinstance(v, pm.Sharded):
            v = pm.shard(torch.as_tensor(v), specs[k], mesh)
        out[k] = v
    return out


def sharded_loss_and_grads(cfg: ModelConfig, params, batch, mesh,
                           micro_weights=None):
    """``loss_and_grads`` on a mesh: ``params`` a tree of ``Sharded``,
    ``batch`` ``shard_batch``'s.  Per microbatch the sharded loss over the
    global microbatch and the gradient of every block (a block no counted
    position reads gets none); the fp32 sums are then summed over each
    block's replicas.  Returns ``(loss, grads)``: the loss a 0-d tensor on
    the first position's device, the grads a tree of fp32 ``Sharded``
    laid out as ``params``, every replica of a block bit for bit equal.
    The host part (``micro_weights`` onto the first position's device)
    then ``sharded_loss_and_grads_on_device``."""
    w = _weights(micro_weights, batch["tokens"].shape[0],
                 mesh.device_list[0])
    return sharded_loss_and_grads_on_device(cfg, params, batch, mesh, w)


def sharded_loss_and_grads_on_device(cfg: ModelConfig, params, batch, mesh,
                                     w=None):
    """The device body of ``sharded_loss_and_grads``: ``w`` None or the
    microbatch weights already on the first position's device.  It makes
    no host sync, so a CUDA graph can capture it where every position
    lies on one card."""
    n_micro = batch["tokens"].shape[0]
    devs = mesh.device_list
    w_on = {d: None if w is None else w.to(d) for d in set(devs)}
    paths, leaves = zip(*[
        (k, x.with_blocks([b.detach().requires_grad_() for b in x.blocks]))
        for k, x in pm.tree_items(params)])
    tree = opt_lib.tree_unflatten(zip(paths, leaves))
    blocks = [b for x in leaves for b in x.blocks]
    acc = [torch.zeros(b.shape, dtype=torch.float32, device=b.device)
           for b in blocks]

    def micro(i, loss_sum, *_):
        """Microbatch ``i``'s gradients added into ``acc``; its loss into
        ``loss_sum`` (its gradients die with the call, before the next
        microbatch's forward)."""
        mb = {k: pm.Sharded(x.shape[1:], P(*x.spec[1:]), mesh,
                            [blk[i] for blk in x.blocks])
              for k, x in batch.items()}
        loss, _ = model_lib.loss_fn(cfg, tree, mb, mesh=mesh)
        grads = torch.autograd.grad(loss, blocks, allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                if g is not None:
                    wi = w_on[a.device]
                    a.add_(g.float() if wi is None else wi[i] * g.float())
            return loss_sum + (loss.detach() if w is None
                               else w[i] * loss.detach())

    # the fp32 sums are made before the loop, so every microbatch's live
    # bytes are the first's (the dry run replays one: program_cost.loop)
    loss_sum = pc.loop("microbatches", n_micro, micro, torch.zeros(
        (), dtype=torch.float32, device=devs[0]))
    if w is None:
        inv = 1.0 / n_micro
        for a in acc:
            a.mul_(inv)
        loss_sum = loss_sum * inv
    out, start = [], 0
    with torch.no_grad():
        for x in leaves:
            n = len(x.blocks)
            out.append(pm.replica_group_sum(
                x.with_blocks(acc[start:start + n])))
            start += n
    return loss_sum, opt_lib.tree_unflatten(zip(paths, out))


def sharded_train_step_on_device(cfg: ModelConfig,
                                 opt_cfg: opt_lib.OptimizerConfig, mesh,
                                 params, opt_state, batch, w=None):
    """One sharded step's device body: ``sharded_loss_and_grads_on_device``
    (``batch`` ``shard_batch``'s, on the mesh's devices) then the in-place
    ``apply_sharded_updates``.  Returns ``(params, opt_state, metrics)``."""
    loss, grads = sharded_loss_and_grads_on_device(cfg, params, batch, mesh,
                                                   w)
    params, opt_state, om = opt_lib.apply_sharded_updates(
        params, grads, opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **om}


def sharded_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                       mesh, micro_weights=None) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on ``mesh``: ``sharded_loss_and_grads`` then the in-place
    ``apply_sharded_updates``; trees of ``Sharded`` in and out, metrics
    ``{"loss", "grad_norm", "lr"}`` as 0-d tensors on the first
    position's device."""
    def train_step(params, opt_state, batch):
        batch = shard_batch(cfg, batch, mesh)
        w = _weights(micro_weights, batch["tokens"].shape[0],
                     mesh.device_list[0])
        return sharded_train_step_on_device(cfg, opt_cfg, mesh, params,
                                            opt_state, batch, w)

    return train_step


class JitTrainStep:
    """``jit_train_step``'s step: ``step(params, opt_state, batch)`` ->
    ``(params, opt_state, metrics)``, eager (``sharded_train_step``) or,
    with ``graphed``, through a ``GraphedShardedTrainStep`` made at the
    first call for the params and state of that call (the graph is bound
    to their storage: a caller that replaces them makes a new step).
    ``param_specs`` and ``batch_specs`` are the layouts it takes;
    ``graph_step`` the graphed step once made, ``capture_seconds`` its
    capture's host seconds (None before the capture and when eager)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                 mesh, num_micro: int, micro_batch: int, micro_weights,
                 graphed: bool):
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        self.shape = (num_micro, micro_batch)
        self.micro_weights = micro_weights
        self.graphed = graphed
        self.param_specs = param_specs(model_lib.decls(cfg), cfg.sharding,
                                       mesh)
        self.batch_specs = batch_shardings(cfg, mesh, num_micro, micro_batch)
        self.graph_step: Optional[GraphedShardedTrainStep] = None
        self._eager = sharded_train_step(cfg, opt_cfg, mesh, micro_weights)

    @property
    def capture_seconds(self) -> Optional[float]:
        return None if self.graph_step is None else \
            self.graph_step.capture_seconds

    def __call__(self, params, opt_state, batch):
        shape = tuple(batch["tokens"].shape[:2])
        if shape != self.shape:
            raise ValueError(f"jit_train_step: batch of {shape} (num_micro, "
                             f"micro_batch); this step was made for "
                             f"{self.shape}")
        if not self.graphed:
            return self._eager(params, opt_state, batch)
        if self.graph_step is None:
            self.graph_step = GraphedShardedTrainStep(
                self.cfg, self.opt_cfg, self.mesh, params, opt_state, batch,
                self.micro_weights)
        return self.graph_step(params, opt_state, batch)


def jit_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig, mesh,
                   num_micro: int, micro_batch: int, micro_weights=None,
                   graphed: Optional[bool] = None) -> JitTrainStep:
    """The sharded step for a concrete mesh and batch shape (the
    reference's jitted, fully-sharded step).  Params and AdamW ``m``/``v``
    go in laid out by ``step.param_specs``, the step replicated, the batch
    (numpy, tensors or ``Sharded``) by ``step.batch_specs``; a batch of
    another leading shape raises.

    ``graphed`` (the counterpart of ``jax.jit``, a CUDA graph a step,
    ``GraphedShardedTrainStep``): None graphs where every position of
    ``mesh`` lies on one CUDA card and runs eagerly elsewhere (the CPU, a
    mesh over several cards); True graphs, and raises ``ValueError`` on
    CPU positions and on positions over several cards before anything is
    made; False runs eagerly."""
    mesh = spmd.check_mesh(mesh)
    on = graphs.wants_graph(mesh.device_list, graphed,
                            "jit_train_step(graphed=True)")
    return JitTrainStep(cfg, opt_cfg, mesh, num_micro, micro_batch,
                        micro_weights, on)


def _state_leaves(opt_state) -> list:
    return (graphs.tree_leaves(opt_state["m"], "m")
            + graphs.tree_leaves(opt_state["v"], "v")
            + graphs.tree_leaves(opt_state["step"], "step"))


class _GraphedTrain(graphs.GraphedStep):
    """The call of a graphed train step (``GraphedTrainStep``,
    ``GraphedShardedTrainStep``): the bound params and state checked, the
    batch loaded (``_load``), then the first call eager on the side
    stream, the second captured, later ones replayed; metrics cloned.
    ``_run_body`` is the step's device body; the new step is written into
    the bound ``opt_state["step"]``, which stays the object it was."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                 params, opt_state, who: str):
        super().__init__(params, who)
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self._params = graphs.tree_leaves(params)
        self._state = _state_leaves(opt_state)
        self._step = opt_state["step"]
        self._copied: Optional[torch.cuda.Event] = None
        self._captured: Optional[graphs.Captured] = None
        self.calls = 0

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return self._captured.graph if self._captured else None

    @property
    def capture_launches(self) -> Optional[Dict[str, int]]:
        return self._captured.launches if self._captured else None

    @property
    def capture_seconds(self) -> Optional[float]:
        return self._captured.seconds if self._captured else None

    @property
    def capture_collectives(self) -> Optional[list]:
        return self._captured.collectives if self._captured else None

    def _check_batch(self, name: str, t, shape, dtype) -> None:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(
                f"{self.who}: batch[{name!r}] is {tuple(t.shape)} {t.dtype}; "
                f"the graph was captured for {tuple(shape)} {dtype}")

    def _wait_pinned(self) -> None:
        """Wait for the pinned buffers' last copy to the card."""
        if self._copied is not None:
            self._copied.synchronize()

    def _loaded(self) -> None:
        self._copied = torch.cuda.Event()
        self._copied.record()

    def _body(self, params, opt_state) -> Dict[str, torch.Tensor]:
        try:
            _, state, metrics = self._run_body(params, opt_state)
            for (_, a), (_, b) in zip(graphs.tree_leaves(self._step),
                                      graphs.tree_leaves(state["step"])):
                a.copy_(b)
        finally:
            opt_state["step"] = self._step
        return metrics

    def _first(self, params, opt_state) -> Dict[str, torch.Tensor]:
        fused_mod.ticket_counters(self.device, self.stream)
        fa.bwd_ticket_counters(self.device, self.stream)
        return self._body(params, opt_state)

    def __call__(self, params, opt_state, batch):
        self.check_alive()
        self.check_bound("params", self._params, graphs.tree_leaves(params))
        self.check_bound("optimizer state", self._state,
                         _state_leaves(opt_state))
        self._load(batch)
        if self.calls == 0:
            out = self.eager(lambda: self._first(params, opt_state))
        else:
            if self._captured is None:
                self._captured = self.capture(
                    lambda: self._body(params, opt_state), keep_graph=True)
            out = self._captured.replay()
        self.calls += 1
        return params, opt_state, {k: v.clone() for k, v in out.items()}


class GraphedTrainStep(_GraphedTrain):
    """``make_graphed_train_step``'s step.  Every call is one training
    step, as ``make_train_step``'s is:

    1. the first runs the device body eagerly on the step's own side
       stream: it builds the kernels, loads every instantiation the step
       launches (none may load inside a capture) and creates the stream's
       ticket counters (the fused norm's and the fp32 attention
       backward's) before any capture;
    2. the second captures the body on that stream into one
       ``torch.cuda.CUDAGraph``, then replays it;
    3. every later call replays it.

    Before each, the batch is copied into static device buffers (through
    pinned host buffers, ``non_blocking``), on the caller's current
    stream, where the replay runs too.  The graph reads and writes the
    storage of the params and optimizer state it was made with (the update
    is in place), so other tensors, or a batch of another shape or dtype,
    raise.  ``opt_state["step"]`` stays the tensor it was: the body writes
    the new step into it.  Metrics come back as clones, so the next replay
    does not overwrite them.  ``capture_launches`` holds the kernel
    launches the capture recorded, added to ``ops.LAUNCHES`` on every
    replay (a replay calls no wrapper); ``capture_seconds`` the capture's
    host time; ``graph`` the ``CUDAGraph`` (its ``cudaGraph_t`` kept).
    The warm call, the capture, the replay and a failed capture's latch
    are ``graphs.GraphedStep``'s."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                 params, opt_state, batch, micro_weights=None):
        super().__init__(cfg, opt_cfg, params, opt_state,
                         "graphed train step")
        dev = self.device
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        self._static = {k: torch.empty(t.shape, dtype=t.dtype, device=dev)
                        for k, t in host.items()}
        self._pinned = {k: torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
                        for k, t in host.items()}
        self._w = _weights(micro_weights, host["tokens"].shape[0], dev)

    def _load(self, batch) -> None:
        """Copy the batch into the static buffers on the current stream."""
        if set(batch) != set(self._static):
            raise ValueError(f"graphed train step: batch fields "
                             f"{sorted(batch)} != {sorted(self._static)}")
        for k, v in batch.items():
            dst = self._static[k]
            self._check_batch(k, torch.as_tensor(v), dst.shape, dst.dtype)
        self._wait_pinned()
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.is_cuda:
                self._static[k].copy_(t)
            else:
                self._pinned[k].copy_(t)
                self._static[k].copy_(self._pinned[k], non_blocking=True)
        self._loaded()

    def _run_body(self, params, opt_state):
        return train_step_on_device(self.cfg, self.opt_cfg, params,
                                    opt_state, self._static, self._w)


class GraphedShardedTrainStep(_GraphedTrain):
    """``jit_train_step``'s graphed step on a mesh whose positions all lie
    on one card (params and state trees of ``Sharded`` whose blocks are
    all on one CUDA device, else ``ValueError``): ``GraphedTrainStep``'s
    contract (the first call eager on the side stream, the second
    captured, later ones replayed; params, ``m`` and ``v`` updated in
    place in the blocks the graph is bound to, ``opt_state["step"]`` the
    ``Sharded`` it was with its blocks written in place; other tensors or
    another batch shape raise; metrics cloned) over
    ``sharded_train_step_on_device``.  The batch (numpy, tensors or
    ``Sharded`` of ``batch_specs``) is copied into one static block a
    position, through one pinned host buffer a position.  The microbatch
    weights are a static tensor made here.  A replay adds the capture's
    launches to ``ops.LAUNCHES`` and its collectives to every active
    ``placement.record_collectives()``: an eager step's, entry for
    entry."""

    def __init__(self, cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                 mesh, params, opt_state, batch, micro_weights=None):
        super().__init__(cfg, opt_cfg, params, opt_state,
                         "graphed sharded train step")
        self.mesh = mesh = spmd.check_mesh(mesh)
        dev = self.device
        shape = tuple(batch["tokens"].shape)
        specs = batch_shardings(cfg, mesh, shape[0], shape[1])
        self._static: Dict[str, pm.Sharded] = {}
        self._pinned: Dict[str, List[torch.Tensor]] = {}
        for k in microbatch_fields(cfg):
            v = batch[k]
            full = tuple(v.shape)
            dtype = v.dtype if isinstance(v, pm.Sharded) else \
                torch.as_tensor(v).dtype
            spec = pm.check_spec(full, specs[k], mesh)
            sizes = [tuple(s.stop - s.start for s in pm.block_slices(
                full, spec, mesh, p)) for p in range(mesh.size)]
            self._static[k] = pm.Sharded(full, spec, mesh, [
                torch.empty(sz, dtype=dtype, device=dev) for sz in sizes])
            self._pinned[k] = [torch.empty(sz, dtype=dtype, pin_memory=True)
                               for sz in sizes]
        self._w = _weights(micro_weights, shape[0], dev)

    def _load(self, batch) -> None:
        """Copy each position's block of the batch into its static block on
        the current stream."""
        mesh = self.mesh
        fields = {k: batch[k] for k in self._static}
        for k, v in fields.items():
            dst = self._static[k]
            if isinstance(v, pm.Sharded):
                if v.spec != dst.spec or v.mesh is not mesh:
                    raise ValueError(f"{self.who}: batch[{k!r}] is laid out "
                                     f"by {v.spec}; the step takes "
                                     f"{dst.spec} on its mesh")
            self._check_batch(k, v if isinstance(v, pm.Sharded)
                              else torch.as_tensor(v), dst.shape, dst.dtype)
        self._wait_pinned()
        for k, v in fields.items():
            dst = self._static[k]
            if isinstance(v, pm.Sharded):
                for a, b in zip(dst.blocks, v.blocks):
                    a.copy_(b)
                continue
            t = torch.as_tensor(v)
            for p, blk in enumerate(dst.blocks):
                part = t[pm.block_slices(dst.shape, dst.spec, mesh, p)]
                if t.is_cuda:
                    blk.copy_(part)
                else:
                    self._pinned[k][p].copy_(part)
                    blk.copy_(self._pinned[k][p], non_blocking=True)
        self._loaded()

    def _run_body(self, params, opt_state):
        return sharded_train_step_on_device(
            self.cfg, self.opt_cfg, self.mesh, params, opt_state,
            self._static, self._w)


def make_graphed_train_step(cfg: ModelConfig,
                            opt_cfg: opt_lib.OptimizerConfig, params,
                            opt_state, batch,
                            micro_weights=None) -> GraphedTrainStep:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) with ``make_train_step``'s contract, the step's device body
    captured once as a CUDA graph and replayed (``GraphedTrainStep``).
    ``params`` and ``opt_state`` are the tensors every call must pass (the
    graph is bound to their storage); ``batch`` gives the batch's fields,
    shapes and dtypes.  Raises on params that are not on a CUDA device."""
    return GraphedTrainStep(cfg, opt_cfg, params, opt_state, batch,
                            micro_weights)
