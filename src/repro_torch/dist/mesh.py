"""Device meshes (counterpart of ``repro/dist/mesh.py``).

All meshes use the reference's axis vocabulary: 'pod' (the slow domain,
multi-pod only), 'data' (data parallelism, plus parameter fsdp under the
``fsdp_tp`` policy) and 'model' (tensor parallelism).  Helpers take
explicit sizes so a planner's (dp, tp[, pods]) maps 1:1 onto a mesh.

The port runs a mesh from one Python process (a single controller, as
JAX does): one process owns every position of the mesh and runs them in
lockstep (``dist/spmd.py``).  A position's device may repeat another's:
``devices=[torch.device("cuda", 0)] * 4`` runs a (2, 2) mesh on one card,
and ``[torch.device("cpu")] * 4`` on the CPU.  With ``devices=None`` a
mesh takes the first ``prod(shape)`` CUDA devices, as the reference takes
a prefix of ``jax.devices()``, and raises without enough cards.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """Named axes over an ndarray of ``torch.device`` in mesh order.

    ``shape`` is an ordered dict of axis name to size (what the sharding
    rules read); ``devices`` has that shape.  A position is an index into
    ``devices.flat`` (C order, the last axis fastest)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh axes {axis_names} do not name the "
                             f"{devices.ndim} dims of a {devices.shape} grid")
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = collections.OrderedDict(
            zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> List[torch.device]:
        """The device of each position, in position order."""
        return list(self.devices.flat)

    def coords(self, pos: int) -> Dict[str, int]:
        """Axis name -> index of position ``pos``."""
        idx = np.unravel_index(pos, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The positions that differ only along ``axes`` (the names this
        mesh has), one list a group, each ordered by its coordinates over
        ``axes`` with the first name major: the members of a collective
        over ``axes``, in the order it sums or concatenates them."""
        axes = tuple(a for a in axes if a in self.shape)
        rest = [a for a in self.axis_names if a not in axes]
        order = [self.axis_names.index(a) for a in rest + list(axes)]
        pos = np.arange(self.size).reshape(self.devices.shape)
        n = math.prod(self.shape[a] for a in axes)
        return pos.transpose(order).reshape(-1, n).tolist()


def _devices(n: int, shape: Tuple[int, ...],
             devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        resolve_device(None)            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())][:n]
    devices = [torch.device(d) for d in np.asarray(devices, dtype=object)
               .reshape(-1)]
    if len(devices) != n:
        raise ValueError(f"need {n} devices for mesh {shape}, "
                         f"got {len(devices)}")
    return devices


def named_mesh(shape: Sequence[int], axes: Sequence[str],
               devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the first ``prod(shape)`` CUDA devices (or the given
    ones, which may repeat a device)."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    grid = np.empty(n, dtype=object)
    grid[:] = _devices(n, shape, devices)
    return Mesh(grid.reshape(shape), axes)


def data_model_mesh(dp: int, tp: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """The workhorse 2-D ('data', 'model') mesh."""
    return named_mesh((dp, tp), ("data", "model"), devices)


def pod_data_model_mesh(pods: int, dp: int, tp: int,
                        devices: Optional[Sequence] = None) -> Mesh:
    """3-D multi-pod mesh; 'pod' is the slow axis."""
    return named_mesh((pods, dp, tp), ("pod", "data", "model"), devices)
