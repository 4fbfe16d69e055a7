"""FLOPs, bytes and live memory of one eager program, per device
(counterpart of ``repro/launch/hlo_cost.py``).

The reference re-derives costs from the post-SPMD HLO text and walks the
call graph to multiply every computation by its enclosing
``known_trip_count``.  The port's programs are eager PyTorch: the step
runs every layer and every microbatch as calls of their own, so there is
nothing to multiply, and a trace of the ops as they run is the whole
program.  :class:`ProgramCost` is a ``TorchDispatchMode`` of the port's
own (not the private ``torch.distributed._tools`` trackers, whose API
moves between releases); run under ``FakeTensorMode`` on the dry run's
stand-ins (``launch/dryrun.py``) it allocates and computes nothing.

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

Collective traffic comes from the collective record
(``placement.record_collectives``, priced by ``launch/comm.py``).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

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
        self._storages: Dict[int, Any] = {}
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
        self._storages[key] = weakref.finalize(st, self._free, key, dev, n)
        self.live[dev] += n
        self.peak[dev] = max(self.peak[dev], self.live[dev])

    def _free(self, key: int, dev: str, n: int) -> None:
        self._storages.pop(key, None)
        self.live[dev] -= n

    def _kernel(self, name: str, flops: float, nbytes: float,
                device: torch.device) -> None:
        self.flops[str(device)] += flops
        self.bytes[str(device)] += nbytes
        self.kernel_calls[name] += 1

    def __enter__(self):
        ops.FAKE_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.FAKE_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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
