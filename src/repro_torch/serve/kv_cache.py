"""KV-cache utilities (counterpart of ``repro/serve/kv_cache.py``).

Cache layouts are declared by each model family (``model.cache_decls``):
stacked-over-layers (L, B, S, K, hd) tensors, ring buffers capped at the
window for SWA archs, plus a Python-int ``len``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def grow_cache(cache: Dict[str, Any], full: Dict[str, Any]) -> Dict[str, Any]:
    """Re-home a prefill-sized cache into a larger decode buffer.

    Copies every tensor of ``cache`` into the leading slots of the
    corresponding (bigger) tensor in ``full``, writing into ``full``'s
    buffers in place (the reference builds new arrays); ``len`` and other
    scalars pass through.  Same-shape (ring) caches pass through, cast to
    ``full``'s dtype."""
    out = {}
    for k, dst in full.items():
        src = cache[k]
        if k == "len" or not isinstance(src, torch.Tensor) or src.dim() == 0:
            out[k] = src
            continue
        if src.shape == dst.shape:
            out[k] = src.to(dst.dtype)
            continue
        dst[tuple(slice(0, d) for d in src.shape)] = src.to(dst.dtype)
        out[k] = dst
    return out


def cache_bytes(cache: Dict[str, Any]) -> int:
    """Total bytes held by a cache's tensors (shape x dtype, no copy)."""
    return sum(v.numel() * v.element_size() for v in cache.values()
               if isinstance(v, torch.Tensor))
