"""FLOPs, bytes and live memory of one eager program, per device
(counterpart of ``repro/launch/hlo_cost.py``).

The reference re-derives costs from the post-SPMD HLO text and walks the
call graph to multiply every computation by its enclosing
``known_trip_count``: a scan over 32 layers is costed once and counted 32
times.  The port's counterpart is the trip scope below: under
``replay()`` (which only the dry run arms, ``launch/dryrun.py``) every
loop of the step that goes through ``loop`` runs its first iteration once,
as a trip of the loop's count, and passes that iteration's output on as
the loop's (on fakes only the shapes count).  :class:`ProgramCost` is a
``TorchDispatchMode`` of the port's own (not the private
``torch.distributed._tools`` trackers, whose API moves between releases);
run under ``FakeTensorMode`` on the dry run's stand-ins it allocates and
computes nothing.

Cost model per op, charged to the device of its first output:

  * FLOPs: the aten ops by ``torch.utils.flop_counter``'s registered
    formulas (``mm``, ``bmm``, ``addmm``, convolutions, ...); each kernel
    wrapper's fake route by ``kernels.ops.fake_cost``, the planner's own
    formulas (``kernel_costs.op_flops_bytes``), so a kernel is not priced
    as its plain version's arithmetic;
  * bytes accessed: the bytes of every tensor operand plus every output of
    each op that moves data.  Views, ``detach``, allocations and metadata
    ops (the counterpart of the reference's ``_SKIP_BYTES``: parameters,
    bitcasts, tuples, loop glue) move none and are skipped;
  * peak live bytes: every storage counts from the op that made it until
    it is freed (a ``weakref.finalize`` on the storage).  Storages alive
    when the count starts (parameters, optimizer state, the batch), given
    as ``base``, count from the start, as XLA's argument bytes do.

A trip of count n (``loop``; trips nest, a layer inside a microbatch
counts ``L x n_micro``) charges n times what its one iteration ran: each
op's FLOPs and bytes, each fake kernel call (``ops.FAKE_CALLS`` and
``kernel_calls``), and each ``CollectiveEntry`` the collective record
took (the iteration's entries appended n times, in order).  Its live
bytes follow the loop's n iterations, each taken to change the live bytes
as a steady iteration does: a storage the iteration leaves alive stands
for n storages (``_mult``), except the loop's carry, whose iteration
frees the one before it; the peak is the highest of the n iterations'.
The backward of a trip that takes a gradient runs in the autograd engine,
after the loop: gradient brackets (an ``_Open`` on each of the iteration's
outputs, one ``_Close`` on all its inputs, weights included) make it a
trip of its own, the remat recompute inside it, so it too is charged n
times, and a stored copy the forward multiplied is freed one copy at a
time inside it, as each of the n backward iterations frees its own.
Where the loss reads the last iteration's output of only some positions
(``last_apart``: logits whole on every 'model' position), the last
iteration runs apart, after a trip of n - 1.  A loop-invariant input
that takes a gradient (``shared``: encdec's encoder states, the hybrid's
shared block) gathers one gradient an iteration in the full program: the
n - 1 additions the replay does not run are charged as their bytes, and
the summed gradient counts once (each of those additions holds one more
such gradient for a moment, which the peak does not count).  Stacked
weights reach the replayed
iteration through ``unstack`` (the chunked loss's chunks through
``split``), whose backward stacks (concatenates) the replayed gradient n
times, as ``unbind``'s (``split``'s) does the n iterations'.

Collective traffic comes from the collective record
(``placement.record_collectives``, priced by ``launch/comm.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import placement as pm
from repro_torch.kernels import ops

_aten = torch.ops.aten
# ops that move no bytes themselves: allocations, aliasing, metadata
_SKIP_BYTES = frozenset({
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty,
    _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.set_, _aten.resize_,
    _aten._local_scalar_dense})


@dataclasses.dataclass
class CostSummary:
    """One device's costs (the reference's fields, plus ``peak_bytes``)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_traffic: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_bytes: int = 0


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class ProgramCost(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and live storage bytes per device of
    every op run under it (and every fake kernel call).  ``base`` is the
    tensors alive before the program (their storages count from the
    start)."""

    def __init__(self, base: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.live: Dict[str, int] = defaultdict(int)
        self.peak: Dict[str, int] = defaultdict(int)
        self.base: Dict[str, int] = defaultdict(int)
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.dispatched = 0     # ops run under it (the host's work; a
        #                         trip does not multiply it)
        # storage key -> (its finalizer, device, bytes)
        self._storages: Dict[int, Tuple[Any, str, int]] = {}
        # storage key -> the trips that multiplied it (``_Trip.exit``)
        self._mult: Dict[int, List["_Trip"]] = {}
        for t in base:
            self._track(t)
        for dev, n in self.live.items():
            self.base[dev] = n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        dev, n = str(t.device), st.nbytes()
        self._storages[key] = (weakref.finalize(st, self._free, key),
                               dev, n)
        for trip in _TRIPS:
            trip.created.add(key)
        self._add(dev, n)

    def _free(self, key: int) -> None:
        info = self._storages.pop(key)
        _, dev, n = info
        tags = self._mult.pop(key, ())
        copies = 1
        for trip in tags:
            if not trip.bwd_open:       # else its backward frees one copy
                copies *= trip.n
        for trip in _TRIPS:
            if key in trip.created:
                trip.created.discard(key)
            else:
                trip.freed.append((key, info, n * copies, tags))
        self._add(dev, -n * copies)

    def _add(self, dev: str, n: int) -> None:
        self.live[dev] += n
        self._raise(dev, self.live[dev])

    def _raise(self, dev: str, level: int) -> None:
        if level > self.peak[dev]:
            self.peak[dev] = level
        for trip in _TRIPS:
            if level > trip.wpeak.get(dev, 0):
                trip.wpeak[dev] = level

    def _kernel(self, name: str, flops: float, nbytes: float,
                device: torch.device) -> None:
        self.flops[str(device)] += flops
        self.bytes[str(device)] += nbytes
        self.kernel_calls[name] += 1

    def __enter__(self):
        ops.FAKE_SINKS.append(self._kernel)
        _COSTS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.FAKE_SINKS.remove(self._kernel)
        _COSTS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.dispatched += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        dev = str(outs[0].device)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[dev] += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if not func.is_view and packet not in _SKIP_BYTES:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes[dev] += sum(t.nbytes for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def summary(self) -> Dict[str, CostSummary]:
        """Per device (by name) its FLOPs, bytes and peak live bytes."""
        devs = sorted(set(self.flops) | set(self.bytes) | set(self.peak))
        return {d: CostSummary(flops=self.flops[d],
                               bytes_accessed=self.bytes[d],
                               peak_bytes=self.peak[d]) for d in devs}


# --- trip counts --------------------------------------------------------------------

_ARMED: List[Dict[str, int]] = []   # each armed replay's trips, by loop
_TRIPS: List["_Trip"] = []          # the open trips, outermost first
_COSTS: List[ProgramCost] = []      # the ProgramCost the trips charge


@contextlib.contextmanager
def replay() -> Iterator[Dict[str, int]]:
    """Arm the trip scope: every ``loop`` in the block runs one iteration
    as a trip of its count.  Yields the trips taken, loop name -> count
    (``{"layers": 32, "microbatches": 8, ...}``).  Raises if a backward
    trip is still open at the end (a replay that cannot be taken is an
    error, not a full run)."""
    _ARMED.append({})
    try:
        yield _ARMED[-1]
    finally:
        _ARMED.pop()
        left = list(_TRIPS)
        _TRIPS.clear()
        if left:
            raise RuntimeError(f"replay: {len(left)} trip(s) left open (a "
                               f"backward bracket that never closed)")


def _cost() -> Optional[ProgramCost]:
    return _COSTS[-1] if _COSTS else None


class _Trip:
    """One replayed iteration counted ``n`` times: a loop's forward, or
    (``fwd`` set) the backward of the forward trip ``fwd``."""

    def __init__(self, n: int, retained: bool = False,
                 fwd: Optional["_Trip"] = None):
        self.n, self.retained, self.fwd = n, retained, fwd
        self.bwd_open = False
        self.bwd_trip: Optional["_Trip"] = None
        # the carry's storages as the iteration got them: key -> finalizer
        self.carry_in: Dict[int, Any] = {}
        self.once: set = set()          # storages counted once at the exit
        self.created: set = set()       # storages made inside, still alive
        # storages alive at the entry freed inside: (key, info, bytes, tags)
        self.freed: List[Tuple[int, Any, int, Sequence["_Trip"]]] = []
        self.extra: Dict[str, float] = defaultdict(float)
        self.wpeak: Dict[str, int] = {}
        self.once_bytes: Dict[str, int] = {}

    def carry(self, t: torch.Tensor) -> None:
        """``t`` is among the carry the iteration was given."""
        cost = _cost()
        k = _key(t)
        if cost is not None and k in cost._storages:
            self.carry_in[k] = cost._storages[k]

    def enter(self, carry_in: Sequence[torch.Tensor] = ()) -> None:
        cost = _cost()
        self.fake0 = dict(ops.FAKE_CALLS)
        self.recs = [(rec, len(rec.entries)) for rec in pm._RECORDS]
        if cost is not None:
            self.flops0 = dict(cost.flops)
            self.bytes0 = dict(cost.bytes)
            self.calls0 = dict(cost.kernel_calls)
            self.live0 = dict(cost.live)
            self.wpeak = dict(cost.live)
        for t in carry_in:
            self.carry(t)
        _TRIPS.append(self)
        if self.fwd is not None:
            self.fwd.bwd_open = True

    def exit(self) -> None:
        if not _TRIPS or _TRIPS[-1] is not self:
            raise RuntimeError("replay: trips closed out of order")
        _TRIPS.pop()
        if self.fwd is not None:
            self.fwd.bwd_open = False
        n = self.n
        if n == 1:
            return
        for name, was in self.fake0.items():
            ops.FAKE_CALLS[name] += (n - 1) * (ops.FAKE_CALLS[name] - was)
        for rec, start in self.recs:
            rec.entries.extend(rec.entries[start:] * (n - 1))
        cost = _cost()
        if cost is None:
            return
        for now, was in ((cost.flops, self.flops0), (cost.bytes, self.bytes0),
                         (cost.kernel_calls, self.calls0)):
            for k in list(now):
                now[k] += (n - 1) * (now[k] - was.get(k, 0))
        once: Dict[str, int] = defaultdict(int)
        for k in self.created:
            _, dev, nb = cost._storages[k]
            if k in self.once:
                once[dev] += nb
            else:
                cost._mult.setdefault(k, []).append(self)
        self.once_bytes = once
        # what the iteration freed of what was alive before it: the carry
        # it was given (a steady iteration frees the one before it made),
        # a copy the forward multiplied (each backward iteration frees its
        # own), the carry a retaining forward was given (each backward
        # iteration frees the carry its forward kept: one carry's worth,
        # which the loop's first input need not be, its blocks shared by
        # positions on one device), or else what the full program frees
        # once, after its last iteration (a loop invariant's last use)
        carry: Dict[str, int] = defaultdict(int)
        other: Dict[str, int] = defaultdict(int)
        fwd = self.fwd
        for k, info, nb, tags in self.freed:
            if self.carry_in.get(k) is info:
                carry[info[1]] += info[2]
            elif fwd is not None and fwd in tags:
                continue
            else:
                other[info[1]] += nb
        if fwd is not None and fwd.retained:
            for dev, nb in fwd.once_bytes.items():
                other[dev] -= nb
        for dev in set(cost.live) | set(self.live0):
            d1 = cost.live[dev] - self.live0.get(dev, 0) + other[dev]
            ds = d1 if self.retained else d1 - once[dev] + carry[dev]
            top = self.wpeak.get(dev, 0) + max(0, d1 + (n - 2) * max(0, ds))
            cost.live[dev] += (n - 1) * ds
            cost._raise(dev, top)
            cost._raise(dev, cost.live[dev])
        for dev, b in self.extra.items():
            cost.bytes[dev] += b


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Open(torch.autograd.Function):
    """Identity on one output of a replayed iteration; the first of these
    to run in the backward opens the iteration's backward trip (every
    other node of that backward needs their gradients).  One a tensor:
    an output the loss does not reach (a position whose logits no
    counted sum reads) stays out of the backward, as in the full
    program."""

    @staticmethod
    def forward(ctx, trip, t):
        ctx.trip = trip
        ctx.set_materialize_grads(False)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        fwd = ctx.trip
        if fwd.bwd_trip is None:
            fwd.bwd_trip = _Trip(fwd.n, fwd=fwd)
            fwd.bwd_trip.enter()
        if g is not None:
            fwd.bwd_trip.carry(g)
        return None, g


class _Close(torch.autograd.Function):
    """Identity on a replayed iteration's inputs (carry, per-iteration
    weights, loop invariants: ``kinds``); its backward, which runs once
    every gradient of them is summed, closes the backward trip and only
    then hands the gradients on, so nothing before the loop (a stacked
    weight's ``unstack``) runs inside it.  The carry's gradient (passed
    on to the iteration before) and each invariant's (summed over the
    iterations) count once; each invariant is charged the n - 1
    additions the full backward runs."""

    @staticmethod
    def forward(ctx, trip, kinds, *ts):
        ctx.trip, ctx.kinds = trip, kinds
        ctx.set_materialize_grads(False)
        return ts

    @staticmethod
    def backward(ctx, *gs):
        trip = ctx.trip
        bwd = trip.bwd_trip
        if bwd is None or not trip.bwd_open:
            raise RuntimeError("replay: a backward bracket closed that "
                               "never opened")
        for kind, g in zip(ctx.kinds, gs):
            if g is None or kind == "per":
                continue
            bwd.once.add(_key(g))
            if kind == "shared":
                bwd.extra[str(g.device)] += (trip.n - 1) * 3.0 * g.nbytes
        # a gradient that reaches an input unchanged (a pass-through) may
        # be a storage the backward did not make
        bwd.once &= bwd.created
        bwd.exit()
        trip.bwd_trip = None
        return (None, None, *gs)


def loop(name: str, n: int, body: Callable, carry, *,
         inputs: Optional[Callable[[int], Any]] = None, shared=None,
         grow: Sequence[list] = (), grad: bool = False,
         retained: bool = False, last_apart: bool = False):
    """``carry = body(i, carry, inputs(i), shared)`` for ``i`` in
    ``range(n)``; returns the last carry; ``name`` names the loop in
    ``replay()``'s trips.  ``carry``, ``inputs(i)`` (the
    iteration's own tensors, e.g. layer ``i``'s weights) and ``shared``
    (loop invariants) are trees of tensors.

    Under ``replay()`` it runs ``body`` once, for ``i`` 0, as a trip of
    ``n``: the lists in ``grow`` (what the iterations append to) get the
    iteration's appended items n times.  ``grad``: a gradient will be
    taken through the loop, so the iteration runs between gradient
    brackets and its backward is a trip of n too.  ``retained``: the
    iteration keeps its carry input for its backward (a layer's input,
    saved by its first norm or its checkpoint), so the carries of every
    iteration stay alive together.  ``last_apart``: the last iteration's
    carry is read otherwise than the others' (the loss reads only some
    positions' last layer, the next layer reads every position's), so
    the replay is iteration 0 as a trip of n - 1, then the last one as
    itself (``inputs(n - 1)`` must be there: ``unstack``'s counts)."""
    if _ARMED and last_apart and n >= 2:
        carry = loop(name, n - 1, body, carry, inputs=inputs, shared=shared,
                     grow=grow, grad=grad, retained=retained)
        _ARMED[-1][name] = n
        return body(n - 1, carry, None if inputs is None else inputs(n - 1),
                    shared)
    if not _ARMED:
        for i in range(n):
            carry = body(i, carry, None if inputs is None else inputs(i),
                         shared)
        return carry
    _ARMED[-1][name] = n
    if n == 0:
        return carry
    marks = [len(g) for g in grow]
    trip = _Trip(n, retained=retained)
    trip.enter(_tensors(carry))
    ins = None if inputs is None else inputs(0)
    if grad:
        carry, ins, shared = _close_in(trip, carry, ins, shared)
    carry = body(0, carry, ins, shared)
    del ins, shared
    if grad:
        flat, spec = tree_flatten(carry)
        if not any(isinstance(t, torch.Tensor) and t.requires_grad
                   for t in flat):
            raise RuntimeError("replay: a loop run for a gradient gave no "
                               "carry that takes one")
        carry = tree_unflatten([
            _Open.apply(trip, t) if isinstance(t, torch.Tensor)
            and t.requires_grad else t for t in flat], spec)
    trip.once.update(k for k in map(_key, _tensors(carry))
                     if k in trip.created)
    trip.exit()
    for g, m in zip(grow, marks):
        g.extend(g[m:] * (n - 1))
    return carry


def _close_in(trip: _Trip, carry, ins, shared) -> tuple:
    """``carry``, ``ins`` and ``shared`` with every tensor of them that
    takes a gradient passed through one ``_Close``."""
    flats = [tree_flatten(t) for t in (carry, ins, shared)]
    picked = [(flat, j, kind)
              for kind, (flat, _) in zip(("carry", "per", "shared"), flats)
              for j, t in enumerate(flat)
              if isinstance(t, torch.Tensor) and t.requires_grad]
    if not picked:
        raise RuntimeError("replay: a loop run for a gradient has no input "
                           "that takes one")
    outs = _Close.apply(trip, tuple(kind for *_, kind in picked),
                        *[flat[j] for flat, j, _ in picked])
    for (flat, j, _), t in zip(picked, outs):
        flat[j] = t
    return tuple(tree_unflatten(flat, spec) for flat, spec in flats)


class _Unstack(torch.autograd.Function):
    """The replayed layers' views of a stacked weight (``counts``: each
    replayed layer and how many layers it stands for); the gradient is
    each view's stacked as many times, as ``unbind``'s backward stacks
    the layers' (an undefined one as its zeros)."""

    @staticmethod
    def forward(ctx, w, counts):
        ctx.counts = counts
        ctx.set_materialize_grads(False)
        return tuple(w.select(0, i) for i, _ in counts)

    @staticmethod
    def backward(ctx, *gs):
        some = next((g for g in gs if g is not None), None)
        if some is None:    # a position the loss does not reach
            return None, None
        parts = []
        for g, (_, c) in zip(gs, ctx.counts):
            if g is None:
                g = torch.zeros((), dtype=some.dtype,
                                device=some.device).expand(some.shape)
            parts += [g] * c
        return torch.stack(parts), None


def unstack(w: torch.Tensor, counts: Optional[Sequence[Tuple[int, int]]]
            = None):
    """A stacked weight's layers, indexable by layer: ``w.unbind(0)``, or
    under ``replay()`` the replayed layers only: ``counts``, (layer, how
    many layers it stands for) pairs, by default the first standing for
    all."""
    if not _ARMED:
        return w.unbind(0)
    counts = tuple(counts or ((0, w.shape[0]),))
    return dict(zip((i for i, _ in counts), _Unstack.apply(w, counts)))


class _Split(torch.autograd.Function):
    """The first of ``n`` chunks of ``size`` along ``dim``; the gradient
    is that chunk's concatenated n times, as ``split``'s backward
    concatenates the n chunks'."""

    @staticmethod
    def forward(ctx, x, size, dim, n):
        ctx.dim, ctx.n = dim, n
        ctx.set_materialize_grads(False)
        return x.narrow(dim, 0, size)

    @staticmethod
    def backward(ctx, g):
        if g is None:       # a position the loss does not reach
            return None, None, None, None
        return torch.cat([g] * ctx.n, ctx.dim), None, None, None


def split(x: torch.Tensor, size: int, dim: int):
    """``x``'s chunks of ``size`` along ``dim`` (which ``size`` divides),
    indexable by chunk: ``x.split(size, dim)``, or under ``replay()`` the
    first only, standing for every chunk."""
    if not _ARMED:
        return x.split(size, dim)
    return {0: _Split.apply(x, size, dim, x.shape[dim] // size)}
