"""Tensor declarations and seeded init (counterpart of ``repro/dist/sharding.py``).

Every parameter and cache tensor is declared once as a :class:`Decl`: a
shape, *logical* axis names ("embed", "heads", ...) and an init recipe.
The logical axes are kept so the mesh rules can be ported later; this
slice uses only the shapes and the recipes.

Init draws from a ``torch.Generator`` with the reference's recipes and
standard deviations.  It cannot give JAX's PRNG bits: where the two
packages must hold the same weights, the tests hand both the same numpy
arrays through ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.device import torch_dtype

Axis = Optional[str]


@dataclasses.dataclass(frozen=True)
class Decl:
    """Shape + logical axes + init recipe for one tensor.

    ``init``: scaled | normal | zeros | ones | embed | a_log | dt_bias
    ("scaled"/"normal": gaussian with std ``shape[scale_dim]**-0.5`` when
    ``scale_dim`` is set, else 0.02).
    """
    shape: Tuple[int, ...]
    axes: Tuple[Axis, ...]
    init: str = "scaled"
    scale_dim: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"Decl shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def iter_decls(decls: Any, prefix: str = "") -> Iterator[Tuple[str, Decl]]:
    """(path, Decl) leaves of a nested dict in sorted-key order, the order
    ``jax.tree_util`` flattens a dict in.  Paths are "/"-joined, as the
    reference's checkpoints key them (``layers/wq``)."""
    if isinstance(decls, Decl):
        yield prefix, decls
        return
    for k in sorted(decls):
        yield from iter_decls(decls[k], f"{prefix}/{k}" if prefix else k)


def set_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    """Store ``value`` at a "/"-joined path of a nested dict."""
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _init_one(d: Decl, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    if d.init == "a_log":
        # mamba2: A ~ U[1, 16), stored as log A
        a = torch.rand(d.shape, **f32) * 15.0 + 1.0
        return torch.log(a).to(dtype)
    if d.init == "dt_bias":
        # mamba2: dt ~ logU[1e-3, 1e-1), stored as softplus^-1(dt)
        u = torch.rand(d.shape, **f32)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        return torch.log(torch.expm1(dt)).to(dtype)
    if d.init == "embed":
        std = 0.02
    elif d.init in ("scaled", "normal"):
        std = (d.shape[d.scale_dim] ** -0.5 if d.scale_dim is not None
               else 0.02)
    else:
        raise ValueError(f"unknown init {d.init!r} for {d}")
    return (torch.randn(d.shape, **f32) * std).to(dtype)


def init_from_decls(decls: Any, gen: torch.Generator,
                    dtype: Union[str, torch.dtype],
                    device: Union[str, torch.device]) -> Any:
    """Initialize a nested dict of Decl into tensors of ``dtype``.

    Leaves draw from ``gen`` one after another in sorted-key order, so the
    result depends only on the seed and the declarations.  ``gen`` must
    live on ``device`` (``torch.Generator(device=...)``).
    """
    dtype = torch_dtype(dtype)
    device = torch.device(device)
    if isinstance(decls, Decl):
        return _init_one(decls, gen, dtype, device)
    out: Dict[str, Any] = {}
    for path, d in iter_decls(decls):
        set_path(out, path, _init_one(d, gen, dtype, device))
    return out
