"""Sharded tensors on a mesh and the collectives between their blocks
(counterpart of ``NamedSharding``, ``jax.device_put`` and the collectives
XLA inserts for the reference's mesh step).

A :class:`Sharded` tensor holds its global shape, its spec
(``sharding.P``), its mesh and one contiguous block a mesh position, on
that position's device.  A dim whose spec part names mesh axes is split
into equal parts over the product of their sizes (the first name major);
a dim whose part is ``None`` is whole in every block, so a block is the
same on every position that differs only along an axis the spec does not
name: those positions are its replicas.  Every block is its own storage,
also where positions share a device.

The collectives take one tensor a position (a list in position order) and
return one a position.  They are built from ``.to(device)`` copies and
out-of-place sums or concatenations in the group's fixed order
(``Mesh.groups``), so autograd differentiates them and every member of a
group on the same kind of device gets the same bits.  Members that share a
device share the result tensor (nothing writes into it).

Every collective goes through ``_collective``, so a record there is the
port's ground truth of what a program communicates (as the post-SPMD HLO
is the reference's): ``with record_collectives() as rec:`` appends one
``CollectiveEntry`` a call to ``rec.entries``.  Autograd runs the
backward's collectives through the copies and sums, and no call reaches
``_collective``: a gradient hook on the outputs of a call whose outputs
require a gradient records its transpose (all-reduce to all-reduce,
all-gather to reduce-scatter) when the first of their gradients is
computed; the hook reads the gradient's size and changes no value (an
output reached with no gradient records nothing).  A forward that runs
again inside the backward (a checkpoint's recompute) records again, as
``"recompute"``.  With no record active the collectives record and hook
nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import operator
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.device import dtype_name
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P, set_path

Axes = Union[str, Sequence[str]]


def part_axes(part) -> Tuple[str, ...]:
    """The mesh axes one part of a spec names."""
    return (part,) if isinstance(part, str) else tuple(part or ())


def check_spec(shape: Sequence[int], spec: Sequence, mesh: Mesh) -> P:
    """``spec`` as a ``P`` of ``len(shape)`` parts, or ``ValueError``: each
    named axis in the mesh, used once, its sizes dividing the dim."""
    spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has more parts than shape {shape}")
    used: set = set()
    for dim, part in zip(shape, spec):
        names = part_axes(part)
        for n in names:
            if n not in mesh.shape or n in used:
                raise ValueError(f"spec {spec}: axis {n!r} is not in mesh "
                                 f"{dict(mesh.shape)} or is used twice")
            used.add(n)
        if dim % math.prod(mesh.shape[n] for n in names):
            raise ValueError(f"spec {spec}: dim {dim} of {tuple(shape)} does "
                             f"not divide over {names}")
    return spec


def block_slices(shape: Sequence[int], spec: P, mesh: Mesh,
                 pos: int) -> Tuple[slice, ...]:
    """Where position ``pos``'s block lies in the global tensor."""
    coords = mesh.coords(pos)
    out = []
    for dim, part in zip(shape, spec):
        names = part_axes(part)
        idx = 0
        for n in names:
            idx = idx * mesh.shape[n] + coords[n]
        size = dim // math.prod(mesh.shape[n] for n in names)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def replica_axes(spec: P, mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes a block is replicated over: those ``spec`` leaves out."""
    named = {n for part in spec for n in part_axes(part)}
    return tuple(a for a in mesh.axis_names if a not in named)


def owners(spec: P, mesh: Mesh) -> List[int]:
    """One position a distinct block: the replica at index 0 of every axis
    the block is replicated over, in position order."""
    rep = replica_axes(spec, mesh)
    return [p for p in range(mesh.size)
            if all(mesh.coords(p)[a] == 0 for a in rep)]


@dataclasses.dataclass(eq=False)
class Sharded:
    """A global tensor of ``shape`` laid out by ``spec`` on ``mesh``:
    ``blocks[pos]`` is position ``pos``'s block, on its device."""
    shape: Tuple[int, ...]
    spec: P
    mesh: Mesh
    blocks: List[torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def with_blocks(self, blocks: List[torch.Tensor]) -> "Sharded":
        """The same layout over other blocks (gradients, moments)."""
        return Sharded(self.shape, self.spec, self.mesh, list(blocks))


def shard(full: torch.Tensor, spec: Sequence, mesh: Mesh) -> Sharded:
    """Lay ``full`` out on ``mesh``: each position's block copied to its
    device, contiguous and its own storage."""
    full = torch.as_tensor(full)
    spec = check_spec(full.shape, spec, mesh)
    blocks = [full[block_slices(full.shape, spec, mesh, p)].to(
        device=d, memory_format=torch.contiguous_format, copy=True)
        for p, d in enumerate(mesh.device_list)]
    return Sharded(tuple(full.shape), spec, mesh, blocks)


def unshard(x: Sharded, device: Union[str, torch.device]) -> torch.Tensor:
    """The global tensor on ``device``, each distinct block copied in once
    (from its replica at index 0)."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for p in owners(x.spec, x.mesh):
        out[block_slices(x.shape, x.spec, x.mesh, p)] = x.blocks[p].to(device)
    return out


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict whose leaves are ``Sharded`` or
    tensors, in sorted-key order with "/"-joined paths."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_items(tree[k], f"{prefix}/{k}" if prefix else k)


def tree_map(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    if not isinstance(tree, dict):
        return fn("", tree)
    out: Dict[str, Any] = {}
    for path, leaf in tree_items(tree):
        set_path(out, path, fn(path, leaf))
    return out


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """``shard`` every leaf of ``tree`` by the spec at its path."""
    flat = dict(tree_items(specs))
    return tree_map(lambda path, t: shard(t, flat[path], mesh), tree)


def unshard_tree(tree: Any, device: Union[str, torch.device]) -> Any:
    return tree_map(lambda _, x: unshard(x, device), tree)


# --- collectives --------------------------------------------------------------------

def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class CollectiveEntry:
    """One collective as the record holds it: ``kind`` (``all-reduce``,
    ``all-reduce-max``, ``all-reduce-min``, ``all-gather``, or a
    backward's ``reduce-scatter``), the mesh ``axes`` it runs over, its
    ``groups`` as flat positions (``Mesh.groups``), the bytes and dtype
    of one member's result, and its ``phase`` (``fwd``, ``bwd``, or
    ``recompute`` for a forward run inside the backward)."""
    kind: str
    axes: Tuple[str, ...]
    groups: Tuple[Tuple[int, ...], ...]
    nbytes: int
    dtype: str
    phase: str


class CollectiveRecord:
    """The collectives run while the record was active, in order."""

    def __init__(self):
        self.entries: List[CollectiveEntry] = []


_RECORDS: List[CollectiveRecord] = []
_TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter"}


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveRecord]:
    """Record every collective (and the backward's transposes) run in the
    block; records nest, each getting every entry."""
    rec = CollectiveRecord()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


@contextlib.contextmanager
def record_apart() -> Iterator[CollectiveRecord]:
    """Record the block's collectives in a record of its own, which alone
    is active inside it: the records active outside get none of its
    entries (a CUDA graph's capture communicates nothing; its replays add
    the entries with ``add_to_records``)."""
    outer = list(_RECORDS)
    _RECORDS.clear()
    try:
        with record_collectives() as rec:
            yield rec
    finally:
        _RECORDS[:] = outer


def add_to_records(entries: Sequence[CollectiveEntry]) -> None:
    """Append ``entries`` to every active record (a replayed graph's)."""
    for rec in list(_RECORDS):
        rec.entries.extend(entries)


def _record(kind: str, axes: Tuple[str, ...], groups: List[List[int]],
            out: List[torch.Tensor]) -> None:
    first = out[groups[0][0]]
    in_backward = torch._C._current_graph_task_id() != -1
    groups_t = tuple(tuple(g) for g in groups)
    entry = CollectiveEntry(kind, axes, groups_t, first.nbytes,
                            dtype_name(first.dtype),
                            "recompute" if in_backward else "fwd")
    recs = list(_RECORDS)
    for rec in recs:
        rec.entries.append(entry)
    if kind not in _TRANSPOSE or not torch.is_grad_enabled():
        return
    outs = {id(t): t for t in out if t.requires_grad}
    fired = []

    def hook(grad: Optional[torch.Tensor]) -> None:
        if fired or grad is None:   # None: a dry run's replay reached an
            return                  # output no gradient flows through
        fired.append(True)
        nbytes = grad.nbytes
        if kind == "all-gather":
            nbytes //= len(groups_t[0])
        back = CollectiveEntry(_TRANSPOSE[kind], axes, groups_t, nbytes,
                               dtype_name(grad.dtype), "bwd")
        for rec in recs:
            if rec in _RECORDS:
                rec.entries.append(back)

    for t in outs.values():
        t.register_hook(hook)


def _collective(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes,
                combine: Callable[[List[torch.Tensor]], torch.Tensor],
                kind: str) -> List[torch.Tensor]:
    """Per group of ``mesh.groups(axes)``, per distinct device among its
    members: ``combine`` of the members' tensors copied to that device,
    in group order.  ``kind`` names it in an active record."""
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size}")
    devs = mesh.device_list
    out: List[Any] = [None] * mesh.size
    groups = mesh.groups(_axes(axes))
    for group in groups:
        if len(group) == 1:
            out[group[0]] = xs[group[0]]
            continue
        made: Dict[torch.device, torch.Tensor] = {}
        for p in group:
            if devs[p] not in made:
                made[devs[p]] = combine([xs[q].to(devs[p]) for q in group])
            out[p] = made[devs[p]]
    if _RECORDS and len(groups[0]) > 1:
        _record(kind, tuple(a for a in _axes(axes) if a in mesh.shape),
                groups, out)
    return out


def all_reduce_sum(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axes: Axes) -> List[torch.Tensor]:
    """Each member of a group over ``axes`` gets the sum of the group's
    tensors, added in group order.  Differentiable (its own transpose)."""
    return _collective(xs, mesh, axes,
                       lambda ts: functools.reduce(operator.add, ts),
                       "all-reduce")


def all_reduce_max(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axes: Axes) -> List[torch.Tensor]:
    """The elementwise max over each group (for a softmax's shift; take it
    of detached tensors)."""
    return _collective(xs, mesh, axes,
                       lambda ts: functools.reduce(torch.maximum, ts),
                       "all-reduce-max")


def all_reduce_min(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axes: Axes) -> List[torch.Tensor]:
    return _collective(xs, mesh, axes,
                       lambda ts: functools.reduce(torch.minimum, ts),
                       "all-reduce-min")


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes,
               dim: int) -> List[torch.Tensor]:
    """Each member gets the group's tensors concatenated along ``dim`` in
    group order (the blocks of a dim sharded over ``axes``, whole again).
    Differentiable: the backward sums each block's gradient over the
    members that gathered it (a reduce-scatter)."""
    return _collective(xs, mesh, axes, lambda ts: torch.cat(ts, dim),
                       "all-gather")


def replica_group_sum(x: Sharded) -> Sharded:
    """Sum each block over its replicas (the positions that hold the same
    block: the axes its spec leaves out), in group order; every replica
    gets the same bits.  Autograd through the lockstep graph gives each
    copy of a replicated block only its own path's gradient; this sum is
    the block's true gradient."""
    return x.with_blocks(all_reduce_sum(x.blocks, x.mesh,
                                        replica_axes(x.spec, x.mesh)))
