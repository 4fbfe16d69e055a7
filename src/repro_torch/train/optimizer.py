"""AdamW by hand (counterpart of ``repro/train/optimizer.py``).

The same optimizer as the reference: global-norm clipping, linear warmup
then cosine decay to a 0.1 floor (or ``constant``), weight decay on every
leaf, fp32 moments ``m`` and ``v`` beside params kept in their own dtype
with no master copy; the update math runs in fp32 and casts back once.

Where the reference returns new arrays, ``apply_updates`` writes the new
params, ``m``, ``v`` and ``step`` into the tensors and the state dict it
was given (under ``torch.no_grad``) and returns them: the caller's
``params`` and ``state`` ARE the results.  That halves the optimizer's
memory on the card; it is a deliberate divergence (``ROADMAP.md`` §3).
Scalars (``step``, the learning rate, the clip scale, the bias
corrections) stay 0-d tensors on the params' device, so a step makes no
host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.dist.placement import Sharded, owners, tree_items, tree_map
from repro_torch.dist.sharding import P, set_path
from repro_torch.graphs import tree_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | constant


def tree_unflatten(items) -> Dict[str, Any]:
    """Nested dict from (path, value) pairs."""
    out: Dict[str, Any] = {}
    for path, value in items:
        set_path(out, path, value)
    return out


def init_state(params: Any) -> Dict[str, Any]:
    """Zero fp32 moments beside every leaf and a 0-d int32 step, on the
    params' device."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": tree_unflatten((k, zeros(p)) for k, p in leaves),
        "v": tree_unflatten((k, zeros(p)) for k, p in leaves),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0][1].device),
    }


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(p.float()))
                          for _, p in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: OptimizerConfig) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step, in place. grads may be any float dtype; math is
    fp32.  Returns ``(params, state, {"grad_norm", "lr"})``, the first two
    the very objects passed in."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    lr = lr_at(cfg, step)
    bc = _bias_corrections(cfg, step)
    for (path, p), (_, g), (_, m), (_, v) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), strict=True):
        _adamw(cfg, p, g, m, v, scale, lr, bc)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _clip_scale(cfg: OptimizerConfig, gnorm: torch.Tensor) -> torch.Tensor:
    if cfg.grad_clip > 0:
        return torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    return torch.ones((), dtype=torch.float32, device=gnorm.device)


def _bias_corrections(cfg: OptimizerConfig, step: torch.Tensor):
    return 1.0 - cfg.beta1 ** step.float(), 1.0 - cfg.beta2 ** step.float()


def _adamw(cfg: OptimizerConfig, p, g, m, v, scale, lr, bc) -> None:
    """One leaf's AdamW update, in place, in fp32."""
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = bc
    g32 = g.float() * scale
    m.mul_(b1).add_((1.0 - b1) * g32)
    v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    delta = delta + cfg.weight_decay * p32
    p.copy_((p32 - lr * delta).to(p.dtype))


# --- on a mesh ----------------------------------------------------------------------

def init_sharded_state(params: Any) -> Dict[str, Any]:
    """``init_state`` for a tree of ``dist.placement.Sharded``: zero fp32
    moments laid out as their params, and a 0-d int32 step replicated
    (spec ``P()``: one a position), as the reference's ``opt_shard``."""
    def zeros(_, x):
        return x.with_blocks([torch.zeros(b.shape, dtype=torch.float32,
                                          device=b.device) for b in x.blocks])
    mesh = next(x for _, x in tree_items(params)).mesh
    step = Sharded((), P(), mesh, [torch.zeros((), dtype=torch.int32,
                                               device=d)
                                   for d in mesh.device_list])
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def sharded_global_norm(grads: Any) -> torch.Tensor:
    """The global norm of a tree of ``Sharded`` gradients, each logical
    element counted once: a block's squares from its replica at index 0
    of every axis it is replicated over, added in a fixed order on the
    first position's device."""
    total = None
    for _, g in tree_items(grads):
        dev0 = g.mesh.device_list[0]
        for pos in owners(g.spec, g.mesh):
            sq = torch.sum(torch.square(g.blocks[pos].float())).to(dev0)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_sharded_updates(params: Any, grads: Any, state: Dict[str, Any],
                          cfg: OptimizerConfig
                          ) -> Tuple[Any, Dict[str, Any], Dict]:
    """``apply_updates`` on a mesh: params, grads (true gradients, every
    replica equal: ``placement.replica_group_sum``), ``m`` and ``v`` trees
    of ``Sharded`` of one layout; each position applies the same AdamW to
    its own blocks, in place, with the clip scale of the global norm
    (``sharded_global_norm``) copied to its device, so replicas stay bit
    for bit equal.  Returns ``(params, state, {"grad_norm", "lr"})``, the
    metrics on the first position's device."""
    gnorm = sharded_global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    old = state["step"]
    steps = [s + 1 for s in old.blocks]
    lrs = [lr_at(cfg, s) for s in steps]
    bcs = [_bias_corrections(cfg, s) for s in steps]
    scales = [scale.to(s.device) for s in steps]
    for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_items(params), tree_items(grads), tree_items(state["m"]),
            tree_items(state["v"]), strict=True):
        for pos in range(len(p.blocks)):
            _adamw(cfg, p.blocks[pos], g.blocks[pos], m.blocks[pos],
                   v.blocks[pos], scales[pos], lrs[pos], bcs[pos])
    state["step"] = old.with_blocks(steps)
    return params, state, {"grad_norm": gnorm, "lr": lrs[0]}
