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


def grow_cache(cache: Dict[str, Any], full: Dict[str, Any]) -> Dict[str, Any]:
    """Re-home a prefill-sized cache into a larger decode buffer.

    Copies every tensor of ``cache`` into the leading slots of the
    corresponding (bigger or same-shape) tensor in ``full``, writing into
    ``full``'s buffers in place, cast to their dtype (the reference builds
    new arrays and passes same-shape ring caches through); ``len`` and
    other scalars pass through.  ``full``'s tensors may be views: the
    servers write a prefill's cache into their static cache's prefix."""
    out = {}
    for k, dst in full.items():
        src = cache[k]
        if k == "len" or not isinstance(src, torch.Tensor) or src.dim() == 0:
            out[k] = src
            continue
        dst[tuple(slice(0, d) for d in src.shape)] = src.to(dst.dtype)
        out[k] = dst
    return out


def cache_bytes(cache: Dict[str, Any]) -> int:
    """Total bytes held by a cache's tensors (shape x dtype, no copy)."""
    return sum(v.numel() * v.element_size() for v in cache.values()
               if isinstance(v, torch.Tensor))
