"""What the port's CUDA-graphed steps share (``train_step.GraphedTrainStep``,
``serve_step.GraphedDecodeStep`` and ``serve_step.GraphedPrefill``, the
counterparts of the reference's ``jax.jit``): the params-leaf walk that
binds a graph to its tensors, ``GraphedStep``, the bookkeeping around a
step's device body, and ``GraphedShapes``, a step with one graph per shape.

A graphed step runs its body in three ways:

1. eagerly, on the step's own side stream (``GraphedStep.eager``): the
   first call builds and loads what the body launches and makes what it
   makes on first use (cuBLAS's handle and workspace for the stream, the
   fused norm's and the fp32 attention backward's ticket counters), since
   none of it may be made inside a
   capture (``GraphedShapes`` runs a later shape's first call on the
   caller's stream);
2. captured on that stream (``GraphedStep.capture``): the kernel launches
   the capture recorded are taken back out of ``ops.LAUNCHES`` (a capture
   launches nothing) and kept with the graph, and so are the collectives
   it recorded (``placement.record_apart``: the records active around a
   capture get none of them); a capture that fails raises
   with CUDA's error as its cause, and every later call raises too
   (``GraphedStep.check_alive``): PyTorch's allocator may be left recording
   into the graph's pool, and no path runs the body eagerly instead;
3. replayed (``Captured.replay``), on the caller's current stream, adding
   the recorded launches to ``ops.LAUNCHES`` and the recorded collectives
   to every active ``placement.record_collectives()`` (a replay calls no
   wrapper and runs no host code of the body).

A graph runs on one card.  The tensors it is bound to may be
``placement.Sharded`` blocks (a mesh whose positions share the card:
``train_step.jit_train_step``, ``MPMDPipeline``'s mesh stages); positions
on more than one card raise (``one_card``), since one graph cannot span
cards here.  ``wants_graph`` is the rule of a ``graphed=`` argument.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dist import placement as pm
from repro_torch.kernels import ops


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) leaves of a nested dict in sorted-key order (the
    order ``jax.tree_util`` flattens a dict in), "/"-joined paths; a
    ``placement.Sharded`` leaf gives its blocks, ``path[pos]``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, pm.Sharded):
        return [(f"{prefix}[{p}]", b) for p, b in enumerate(tree.blocks)]
    out: List[Tuple[str, torch.Tensor]] = []
    for k in sorted(tree):
        out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def one_card(devices, who: str) -> torch.device:
    """The one CUDA device of ``devices`` (a mesh's positions, a tree's
    tensors), or ``ValueError`` naming why there is none: a device that is
    not CUDA, or more than one card (one graph cannot span cards here)."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    if not devs or any(d.type != "cuda" for d in devs):
        raise ValueError(f"{who}: a CUDA graph needs every tensor on a CUDA "
                         f"device, got {[str(d) for d in devs]}")
    if len(devs) > 1:
        raise ValueError(f"{who}: the positions lie on more than one card "
                         f"({[str(d) for d in devs]}); a CUDA graph runs on "
                         f"one card, so a mesh over several cards runs "
                         f"eagerly (graphed=None or False)")
    return devs[0]


def wants_graph(devices, graphed: Optional[bool], who: str) -> bool:
    """The rule of a ``graphed=`` argument over the devices a program runs
    on: None graphs where every device is one CUDA card and runs eagerly
    elsewhere; True graphs, and raises where ``one_card`` does; False runs
    eagerly."""
    if graphed is None:
        devs = {torch.device(d) for d in devices}
        return len(devs) == 1 and next(iter(devs)).type == "cuda"
    if graphed:
        one_card(devices, who)
    return bool(graphed)


@dataclasses.dataclass
class Captured:
    """One captured body: its graph, the tensors the graph writes its
    results into (the next replay overwrites them), the kernel launches
    and the collectives the capture recorded, and the capture's host
    seconds."""
    graph: torch.cuda.CUDAGraph
    out: Any
    launches: Dict[str, int]
    seconds: float
    collectives: List[pm.CollectiveEntry]

    def replay(self) -> Any:
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        pm.add_to_records(self.collectives)
        return self.out


class GraphedStep:
    """The bookkeeping of a graphed step (module docstring).  ``who`` names
    the step in its errors; ``shared_pool`` gives every graph the step
    captures one memory pool (``torch.cuda.graph_pool_handle``), for graphs
    that never run at the same time.  Raises on params (tensors or
    ``Sharded`` blocks) that are not all on one CUDA device
    (``one_card``)."""

    def __init__(self, params, who: str, shared_pool: bool = False):
        dev = one_card([t.device for _, t in tree_leaves(params)], who)
        self.who, self.device = who, dev
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle() if shared_pool else None
        self._failed: Optional[str] = None

    def check_bound(self, what: str, want: List[Tuple[str, torch.Tensor]],
                    got: List[Tuple[str, torch.Tensor]]) -> None:
        """Raise unless ``got`` holds the very tensors of ``want`` (the
        graphs read and write their storage)."""
        if [k for k, _ in got] != [k for k, _ in want] or any(
                a is not b for (_, a), (_, b) in zip(got, want)):
            raise ValueError(
                f"{self.who}: these {what} are not the tensors the step was "
                f"made with (its graphs read and write their storage); make "
                f"a new step for them")

    def check_alive(self) -> None:
        if self._failed is not None:
            raise RuntimeError(f"{self.who}: a capture failed earlier "
                               f"({self._failed})")

    def eager(self, body: Callable[[], Any]) -> Any:
        """``body()`` on the step's stream, ordered after the caller's
        stream's work and before its next."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = body()
        main.wait_stream(self.stream)
        return out

    def capture(self, body: Callable[[], Any], where: str = "",
                keep_graph: bool = False) -> Captured:
        """``body()`` captured on the step's stream; ``where`` (" at 4
        rows") names the shape in the error of a failed capture;
        ``keep_graph`` keeps the ``cudaGraph_t`` (instantiated here)."""
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        try:
            with pm.record_apart() as rec, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream):
                out = body()
            if keep_graph:
                graph.instantiate()
        except RuntimeError as err:     # CUDA's errors, and the capture's
            msg = f"{type(err).__name__}: {err}"
            self._failed = f"{where.strip()}: {msg}" if where else msg
            raise RuntimeError(f"{self.who}: the capture failed{where}: "
                               f"{msg}") from err
        finally:
            launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
            ops.LAUNCHES.update(before)   # the capture launched nothing
        return Captured(graph, out, launches, time.perf_counter() - t0,
                        list(rec.entries))


class GraphedShapes(GraphedStep):
    """A graphed step with one graph per shape (the reference's jit traces
    once per shape): ``run(key, body)`` runs ``body`` eagerly at the first
    call with ``key``, captures it at the second and replays it from then
    on.  Only the step's first call runs on its side stream: what the body
    makes per stream is made then, and what it makes per shape (kernels
    loaded, cuBLAS's choices) does not depend on the stream, so a later
    shape's first call runs on the caller's stream, as the eager body
    would, drawing on that stream's cached memory (each stream has its own
    cache, and a shape seen once must cost what the eager body costs).
    ``graphs``, ``capture_launches`` and ``capture_seconds`` are keyed by
    shape."""

    def __init__(self, params, who: str, shared_pool: bool = False):
        super().__init__(params, who, shared_pool)
        self._warm: set = set()
        self._captured: Dict[Any, Captured] = {}

    @property
    def graphs(self) -> Dict[Any, torch.cuda.CUDAGraph]:
        return {key: c.graph for key, c in self._captured.items()}

    @property
    def capture_launches(self) -> Dict[Any, Dict[str, int]]:
        return {key: c.launches for key, c in self._captured.items()}

    @property
    def capture_seconds(self) -> Dict[Any, float]:
        return {key: c.seconds for key, c in self._captured.items()}

    def run(self, key, body: Callable[[], Any], where: str) -> Any:
        """``where`` names the shape in the error of a failed capture."""
        if key not in self._captured:
            if key not in self._warm:
                out = body() if self._warm else self.eager(body)
                self._warm.add(key)
                return out
            self._captured[key] = self.capture(body, where)
        return self._captured[key].replay()
