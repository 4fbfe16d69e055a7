"""KV-cache utilities (counterpart of ``repro/serve/kv_cache.py``).

Cache layouts are declared by each model family (``model.cache_decls``):
stacked-over-layers (L, B, S, K, hd) tensors, ring buffers capped at the
window for SWA archs, constant (L, B, H, P, N) SSM and (L, B, 3, C) conv
states for the state-space families, plus ``len``: a Python int from ``forward``, a
device tensor in the servers' decode state (``serve_step.decode_state``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.dist import placement as pm


def grow_cache(cache: Dict[str, Any], full: Dict[str, Any]) -> Dict[str, Any]:
    """Re-home a prefill-sized cache into a larger decode buffer.

    Copies every tensor of ``cache`` into the leading slots of the
    corresponding (bigger or same-shape) tensor in ``full``, writing into
    ``full``'s buffers in place, cast to their dtype (the reference builds
    new arrays and passes same-shape ring caches through); ``len`` and
    other scalars pass through.  ``full``'s tensors may be views: the
    servers write a prefill's cache into their static cache's prefix.

    On a mesh the leaves are ``placement.Sharded``: ``cache`` laid out by
    ``serve_step.cache_specs(cfg, B, S, mesh)`` (a sharded prefill's),
    ``full`` by ``cache_specs(cfg, B, max_len, mesh)`` (``model.init_cache
    (..., mesh=)``), and each position writes its block of ``full``
    (``_grow_sharded``)."""
    out = {}
    for k, dst in full.items():
        src = cache[k]
        if isinstance(dst, pm.Sharded):
            out[k] = _grow_sharded(src, dst)
            continue
        if k == "len" or not isinstance(src, torch.Tensor) or src.dim() == 0:
            out[k] = src
            continue
        dst[tuple(slice(0, d) for d in src.shape)] = src.to(dst.dtype)
        out[k] = dst
    return out


def _grow_sharded(src: pm.Sharded, dst: pm.Sharded) -> pm.Sharded:
    """``src``'s global tensor written into the leading slots of ``dst``'s,
    block by block, in place.  A dim ``src`` splits where ``dst`` splits it
    otherwise, or at other boundaries (the sequence split of a
    ``max_len`` buffer against an ``S``-slot prefill's), is first
    ``all_gather``ed whole over its axes (recorded as any collective); then
    each position copies the part of its ``dst`` block that ``src`` covers.
    A ring (same shape and layout) is a copy, block for block."""
    blocks, spec = list(src.blocks), list(src.spec)
    for dim, part in enumerate(src.spec):
        axes = pm.part_axes(part)
        if axes and (part != dst.spec[dim]
                     or src.shape[dim] != dst.shape[dim]):
            blocks = pm.all_gather(blocks, src.mesh, axes, dim)
            spec[dim] = None
    spec = pm.P(*spec)
    for p, out in enumerate(dst.blocks):
        have = pm.block_slices(src.shape, spec, src.mesh, p)
        want = pm.block_slices(dst.shape, dst.spec, dst.mesh, p)
        lo = [max(h.start, w.start) for h, w in zip(have, want)]
        hi = [min(h.stop, w.stop) for h, w in zip(have, want)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        out[tuple(slice(a - w.start, b - w.start)
                  for a, b, w in zip(lo, hi, want))] = blocks[p][tuple(
                      slice(a - h.start, b - h.start)
                      for a, b, h in zip(lo, hi, have))].to(out.dtype)
    return dst


def cache_bytes(cache: Dict[str, Any]) -> int:
    """Total bytes held by a cache's tensors (shape x dtype, no copy)."""
    return sum(v.numel() * v.element_size() for v in cache.values()
               if isinstance(v, torch.Tensor))
