"""Train step factory: microbatched gradient accumulation + AdamW update
(counterpart of the single-device half of ``repro/train/train_step.py``).

The step consumes a batch shaped ``(num_micro, micro_batch, seq)`` and
loops over the leading dim accumulating fp32 gradients, so only one
microbatch of activations is live at a time (``cfg.remat`` inside the
layer loop bounds it further).  Gradients come from
``torch.autograd.grad`` over the parameter leaves.  The mesh half
(``batch_shardings``, ``jit_train_step``) waits for the sharded slice: a
``mesh`` argument raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.device import device_of
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("train_step: the mesh-sharded step is not "
                                  "ported yet (single device only)")


def loss_and_grads(cfg: ModelConfig, params, batch, mesh=None,
                   micro_weights=None):
    """Loop over microbatches, accumulating fp32 grads and mean loss.

    ``micro_weights`` (shape ``(num_micro,)``, summing to 1) weights each
    microbatch's gradient and loss instead of the uniform ``1/num_micro``
    (the single-mesh form of the adaptive-batching gradient weights).
    ``None`` is the exact uniform path.  Returns ``(loss, grads)``, grads
    a nested dict of fp32 tensors shaped like ``params``.
    """
    _no_mesh(mesh)
    dev = device_of(params)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    n_micro = batch["tokens"].shape[0]
    w = None
    if micro_weights is not None:
        w = torch.as_tensor(micro_weights, dtype=torch.float32).to(dev)
        if tuple(w.shape) != (n_micro,):
            raise ValueError(f"micro_weights shape {tuple(w.shape)} != "
                             f"({n_micro},)")
    # detached leaves that share the caller's storage: the grads are taken
    # against them, and the caller's tensors need no requires_grad
    paths, leaves = zip(*[(k, p.detach().requires_grad_())
                          for k, p in opt_lib.tree_leaves(params)])
    tree = opt_lib.tree_unflatten(zip(paths, leaves))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    fields = microbatch_fields(cfg)
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


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                    mesh=None, micro_weights=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``{"loss", "grad_norm", "lr"}`` as 0-d tensors.  The
    update is in place (``optimizer.apply_updates``): the returned params
    and state are the ones passed in."""
    _no_mesh(mesh)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch,
                                     micro_weights=micro_weights)
        params, opt_state, om = opt_lib.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics: Dict[str, Any] = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step
