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

from repro_torch.dist.sharding import set_path
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
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for (path, p), (_, g), (_, m), (_, v) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), strict=True):
        g32 = g.float() * scale
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
