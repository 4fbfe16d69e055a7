"""Tensor declarations and seeded init (counterpart of ``repro/dist/sharding.py``).

Every parameter and cache tensor is declared once as a :class:`Decl`: a
shape, *logical* axis names ("embed", "heads", ...) and an init recipe.
A sharding *policy* maps logical axes to candidate mesh axes;
:func:`logical_to_spec` resolves a declaration against a mesh into a
:class:`P` (a ``PartitionSpec``) under the reference's two rules: a dim
that does not divide its mesh axis is replicated, and each mesh axis is
used at most once per tensor (first dim, left to right).  The rules are
plain copies of the reference's and read only ``mesh.shape``, an ordered
mapping of axis name to size (``dist.mesh.Mesh``, or a test's fake).
:func:`sanitize` is the reference's ``constrain`` rule: the port has no
compiler to hint, so the sharded forward (``dist/spmd.py``) lays out what
it computes by the sanitized spec itself.

Init draws from a ``torch.Generator`` with the reference's recipes and
standard deviations.  It cannot give JAX's PRNG bits: where the two
packages must hold the same weights, the tests hand both the same numpy
arrays through ``repro_torch.bridge``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import torch_dtype

Axis = Optional[str]
Rules = Mapping[str, Tuple[str, ...]]


class P(tuple):
    """A ``PartitionSpec``: one part a dim, each ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim split over their product,
    the first name major).  ``P("data", None) == ("data", None)``, as the
    reference's specs compare with tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


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


# --- mesh rules (plain copies of the reference's) ------------------------------

_TP_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    # MoE: expert parallelism when n_experts divides 'model' (dbrx 16e/16),
    # else tensor parallelism inside each expert (mixtral 8e/16).
    "experts": ("model",),
    "e_ff": ("model",),
    "ssm_inner": ("model",),
}

POLICIES: Dict[str, Rules] = {
    "replicated": {},
    "tp": _TP_RULES,
    "fsdp_tp": {**_TP_RULES, "embed": ("data",)},
}


def policy_rules(name: str) -> Rules:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown sharding policy {name!r}; "
                       f"known: {sorted(POLICIES)}") from None


def _mesh_sizes(mesh) -> Dict[str, int]:
    # works for dist.mesh.Mesh and the dict-shaped fakes in tests
    return dict(mesh.shape)


def logical_to_spec(shape: Sequence[int], axes: Sequence[Axis],
                    rules: Rules, mesh) -> P:
    """Resolve logical axes to a spec on ``mesh``.

    Non-divisible dims replicate; each mesh axis is assigned at most once
    (first dim, left to right).
    """
    sizes = _mesh_sizes(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        pick = None
        for cand in (rules.get(ax, ()) if ax is not None else ()):
            if cand in sizes and cand not in used and dim % sizes[cand] == 0:
                pick = cand
                break
        if pick is not None:
            used.add(pick)
        parts.append(pick)
    return P(*parts)


def param_specs(decls: Any, policy: str, mesh) -> Any:
    """Nested dict of Decl -> nested dict of P under ``policy``."""
    rules = policy_rules(policy)
    if isinstance(decls, Decl):
        return logical_to_spec(decls.shape, decls.axes, rules, mesh)
    out: Dict[str, Any] = {}
    for path, d in iter_decls(decls):
        set_path(out, path, logical_to_spec(d.shape, d.axes, rules, mesh))
    return out


# --- data-parallel batch dim -----------------------------------------------------

DP_AXIS_NAMES = ("pod", "data")


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim may shard over, in mesh order ('pod' first)."""
    return tuple(n for n in _mesh_sizes(mesh) if n in DP_AXIS_NAMES)


def batch_spec(mesh, batch: int, *rest: Axis) -> P:
    """Spec for a ``(batch, ...)`` tensor: batch over the flattened dp axes.

    Divisibility fallback drops the outermost (slowest, 'pod') axis first:
    e.g. on a (pod=2, data=16, model=16) mesh batch=256 -> ('pod','data'),
    batch=16 -> 'data', batch=1 -> replicated.  ``rest`` entries are passed
    through for the trailing dims (validated later by :func:`sanitize`).
    """
    axes = dp_axes(mesh)
    sizes = _mesh_sizes(mesh)
    for i in range(len(axes)):
        group = axes[i:]
        if batch % math.prod(sizes[a] for a in group) == 0:
            return P(group if len(group) > 1 else group[0], *rest)
    return P(None, *rest)


def sanitize(shape: Sequence[int], spec: Sequence, sizes: Dict[str, int]
             ) -> P:
    """The reference's ``_sanitize`` (``constrain``'s rule): a part whose
    names are unknown, already used, or whose product does not divide the
    dim becomes ``None``."""
    used: set = set()
    parts = []
    for dim, part in zip(shape, tuple(spec)):
        names = (part,) if isinstance(part, str) else tuple(part or ())
        ok = (names
              and all(n in sizes and n not in used for n in names)
              and dim % math.prod(sizes[n] for n in names) == 0)
        if ok:
            used.update(names)
            parts.append(part)
        else:
            parts.append(None)
    return P(*parts)
