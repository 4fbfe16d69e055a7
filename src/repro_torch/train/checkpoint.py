"""Asynchronous, reshardable checkpointing (counterpart of
``repro/train/checkpoint.py``; paper §4.4).

Sailor uses async checkpointing (CheckFreq/PCcheck-style) to minimize
rollback on reconfiguration.  Here:

  * ``save`` snapshots the train state to host memory (the only
    synchronous part), then a background thread serializes it to disk;
    training continues immediately.  The snapshot is a copy: the port's
    optimizer writes params, ``m`` and ``v`` in place, so a view of a CPU
    tensor would be written with the state of a later step.  A
    ``placement.Sharded`` leaf is gathered whole (``unshard``: each
    distinct block once, from its owner), a tensor copied by
    ``.to("cpu", copy=True)`` (a synchronous device-to-host copy on the
    card);
  * checkpoints are mesh-agnostic (whole host arrays + a manifest), so
    ``restore`` can lay them out onto *any* new mesh
    (``shardings=``), the substrate for elastic reconfiguration with a
    different device count;
  * atomicity: writes go to ``<dir>/tmp-<step>`` and are renamed into
    place; a torn write can never be mistaken for a complete checkpoint.

The files are the reference's: ``state.npz`` keyed by the "/"-joined tree
paths (``params/layers/wq``, ``opt/m/...``, ``opt/step``) and
``manifest.json``.  A bfloat16 tensor is written as the 2-byte ``|V2``
records the reference's ``np.savez`` writes for ml_dtypes' bfloat16 (its
bits), so each package reads the other's files.  On restore the template
decides the dtype: a ``|V2`` leaf whose template leaf is bfloat16 comes
back as bfloat16 bits (the reference hands such a leaf to
``jax.device_put`` as ``|V2``, which refuses it: ``ROADMAP.md`` §3, R7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import set_path

BF16_RECORD = np.dtype("V2")     # how np.savez stores ml_dtypes' bfloat16


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host copy of one leaf as the reference writes it."""
    if isinstance(leaf, pm.Sharded):
        leaf = pm.unshard(leaf, "cpu")          # a new tensor
    elif isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
    else:
        return np.array(leaf, copy=True)
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(BF16_RECORD)
    return leaf.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    """Host copies of a nested dict's leaves (tensors, ``Sharded``, numpy
    arrays or scalars) under "/"-joined paths, in the reference's order."""
    return {path: _to_numpy(leaf) for path, leaf in pm.tree_items(tree)}


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A loaded array as a CPU tensor of ``dtype`` (``|V2`` records as
    bfloat16 bits)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(dtype)


def _restore_leaf(arr: np.ndarray, template: Any, sharding: Any) -> Any:
    """One loaded array as its template leaf (a tensor or ``Sharded``)
    has it: the template's dtype, laid out by ``sharding`` (a
    ``Sharded``, or a (spec, mesh) pair), else like a ``Sharded``
    template, else on the template's device."""
    t = _as_tensor(arr, template.dtype)
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for "
                         f"a template of {tuple(template.shape)}")
    if sharding is None and isinstance(template, pm.Sharded):
        sharding = template
    if isinstance(sharding, pm.Sharded):
        return pm.shard(t, sharding.spec, sharding.mesh)
    if sharding is not None:
        spec, mesh = sharding
        if not isinstance(mesh, Mesh):
            raise TypeError(f"a sharding is a Sharded or a (spec, Mesh) "
                            f"pair, got {type(sharding).__name__}")
        return pm.shard(t, spec, mesh)
    return t.to(template.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 orphan_ttl_s: float = 3600.0):
        self.dir = directory
        self.keep = keep
        self.orphan_ttl_s = orphan_ttl_s
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        """Remove ``tmp-<step>`` dirs left by a crash mid-write.

        A tmp dir only exists between the start of a write and its rename
        into place, so an old one is a torn write that would otherwise
        accumulate forever.  Only dirs older than ``orphan_ttl_s`` are
        swept: a freshly-modified tmp dir may belong to a live writer in
        *another* process (elastic failover starting a replacement trainer
        while the old one's background save is still running)."""
        import time
        now = time.time()
        for name in os.listdir(self.dir):
            if not name.startswith("tmp-"):
                continue
            path = os.path.join(self.dir, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue                  # raced with its own rename
            if age >= self.orphan_ttl_s:
                shutil.rmtree(path, ignore_errors=True)

    # --- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot now (host copies), write in background (unless
        blocking)."""
        self.wait()                      # at most one in-flight write
        host = _flatten(state)

        def _write():
            try:
                tmp = os.path.join(self.dir, f"tmp-{step}")
                final = os.path.join(self.dir, f"step-{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "state.npz"), **host)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump({"step": step, "keys": sorted(host)}, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err}") from err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)

    # --- restore ----------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step-"):
                continue
            suffix = name.split("-", 1)[1]
            # foreign entries (editor droppings, "step-backup", ...) must
            # not take down every restore in the directory
            if suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, int]:
        """Load a checkpoint into ``template``'s structure: tensors of the
        template's dtypes on its devices, or laid out by ``shardings`` (a
        tree of ``Sharded`` or (spec, mesh) leaves; the kill-free elastic
        restore onto a different mesh)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step-{step}", "state.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        how = {} if shardings is None else dict(pm.tree_items(shardings))
        state: Dict[str, Any] = {}
        for key, leaf in pm.tree_items(template):
            value = _restore_leaf(flat[key], leaf, how.get(key))
            if not key:                  # a template that is one leaf
                return value, step
            set_path(state, key, value)
        return state, step
