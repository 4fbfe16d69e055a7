"""Params and optimizer state between numpy and the port, keyed like the
reference's checkpoints.

Keys are the "/"-joined pytree paths that ``repro/train/checkpoint.py``'s
``_flatten`` writes (``embed``, ``ln_f``, ``layers/wq``, ...; the AdamW
state's ``m/layers/wq``, ``v/...`` and ``step``).  So a JAX pytree
flattened to numpy and the reference's ``state.npz`` checkpoints (whose
params sit under ``params/``: pass ``prefix="params/"``) both load (a bf16 leaf
of such a file comes back from ``np.load`` as raw 2-byte ``|V2`` records,
whether ``ml_dtypes`` is imported or not, and is read as bfloat16 bits),
and both packages can start from the same weights and optimizer state.
The ``sharded_*`` functions do the same for a mesh: the tree laid out by
``param_specs(decls, cfg.sharding, mesh)`` (``dist.placement``), and back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceArg, resolve_device, torch_dtype
from repro_torch.dist.placement import shard, shard_tree, unshard_tree
from repro_torch.dist.sharding import P, iter_decls, param_specs, set_path
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    # ml_dtypes' bfloat16 (JAX arrays), or the raw |V2 records np.load
    # returns for it from an .npz: bfloat16 bits either way
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))   # owned, writable


def params_from_numpy(cfg: ModelConfig, flat: Dict[str, np.ndarray],
                      device: DeviceArg = None, prefix: str = ""):
    """Nested params dict of ``cfg.param_dtype`` tensors on ``device`` from
    ``flat[prefix + path]``.  Every declared tensor must be present with its
    declared shape."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    out: Dict = {}
    for path, decl in iter_decls(model_lib.decls(cfg)):
        key = prefix + path
        if key not in flat:
            raise KeyError(f"params_from_numpy: {key!r} missing")
        arr = flat[key]
        if tuple(arr.shape) != decl.shape:
            raise ValueError(f"params_from_numpy: {key!r} has shape "
                             f"{tuple(arr.shape)}, {cfg.name} declares "
                             f"{decl.shape}")
        set_path(out, path, _to_tensor(arr).to(device=dev, dtype=dtype))
    return out


def params_to_numpy(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``.  bfloat16 tensors come back as
    float32 arrays (exact: every bfloat16 is a float32), since numpy has no
    bfloat16 of its own."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            t = tree.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            flat[prefix + path] = t.numpy()
            return
        for k in sorted(tree):
            walk(tree[k], f"{path}/{k}" if path else k)

    walk(params, "")
    return flat


def opt_state_from_numpy(cfg: ModelConfig, flat: Dict[str, np.ndarray],
                         device: DeviceArg = None, prefix: str = ""):
    """AdamW state (``train.optimizer.init_state``'s layout) from
    ``flat[prefix + "m/" + path]``, ``[... "v/" + path]`` and
    ``[prefix + "step"]``: fp32 moments of the declared shapes and a 0-d
    int32 step on ``device``."""
    dev = resolve_device(device)
    state: Dict = {"m": {}, "v": {}}
    for path, decl in iter_decls(model_lib.decls(cfg)):
        for part in ("m", "v"):
            key = f"{prefix}{part}/{path}"
            if key not in flat:
                raise KeyError(f"opt_state_from_numpy: {key!r} missing")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != decl.shape:
                raise ValueError(f"opt_state_from_numpy: {key!r} has shape "
                                 f"{tuple(arr.shape)}, {cfg.name} declares "
                                 f"{decl.shape}")
            set_path(state[part], path, _to_tensor(arr).to(
                device=dev, dtype=torch.float32))
    step = np.asarray(flat[prefix + "step"])
    if step.shape != ():
        raise ValueError(f"opt_state_from_numpy: step has shape {step.shape}")
    state["step"] = torch.tensor(int(step), dtype=torch.int32, device=dev)
    return state


def opt_state_to_numpy(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``opt_state_from_numpy``: fp32 moments and an int32 0-d
    step, under the reference's keys."""
    flat = params_to_numpy(state["m"], prefix + "m/")
    flat.update(params_to_numpy(state["v"], prefix + "v/"))
    flat[prefix + "step"] = np.asarray(
        int(state["step"].detach().cpu()), dtype=np.int32)
    return flat


def _specs(cfg: ModelConfig, mesh):
    return param_specs(model_lib.decls(cfg), cfg.sharding, mesh)


def sharded_params_from_numpy(cfg: ModelConfig, flat: Dict[str, np.ndarray],
                              mesh, prefix: str = ""):
    """``params_from_numpy`` laid out on ``mesh`` by ``cfg.sharding``: a
    tree of ``dist.placement.Sharded``."""
    return shard_tree(params_from_numpy(cfg, flat, "cpu", prefix),
                      _specs(cfg, mesh), mesh)


def sharded_params_to_numpy(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``sharded_params_from_numpy``."""
    return params_to_numpy(unshard_tree(params, "cpu"), prefix)


def sharded_opt_state_from_numpy(cfg: ModelConfig,
                                 flat: Dict[str, np.ndarray], mesh,
                                 prefix: str = ""):
    """``opt_state_from_numpy`` on ``mesh``: the moments laid out as the
    params, the step replicated (``P()``)."""
    state = opt_state_from_numpy(cfg, flat, "cpu", prefix)
    specs = _specs(cfg, mesh)
    return {"m": shard_tree(state["m"], specs, mesh),
            "v": shard_tree(state["v"], specs, mesh),
            "step": shard(state["step"], P(), mesh)}


def sharded_opt_state_to_numpy(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``sharded_opt_state_from_numpy``."""
    return opt_state_to_numpy(unshard_tree(state, "cpu"), prefix)
