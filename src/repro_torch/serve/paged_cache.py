"""Paged KV-cache block allocator (counterpart of the accounting half of
``repro/serve/paged_cache.py``; vLLM-style page accounting).

The cache of a serving replica is carved into fixed-size pages of
``page_size`` tokens; a sequence at ``ctx`` live tokens holds
``ceil(ctx / page_size)`` pages.  This is the *accounting* layer, plain
Python: the continuous-batching server (``serve/scheduler``) admits and
evicts by it.  The physical cache stays a dense ``(slots, max_ctx, ...)``
buffer per slot (a CUDA graph wants static shapes); paging governs
admission, not the layout.  The reference's ``page_bytes``,
``replica_page_budget`` and ``kv_headroom_bytes`` read the serving
simulator and come with its port.
"""
from __future__ import annotations

from typing import Dict, Optional


class PagedKVAllocator:
    """Fixed pool of KV pages with per-sequence accounting."""

    def __init__(self, total_pages: int, page_size: int):
        assert total_pages >= 0 and page_size >= 1
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self._held: Dict[object, int] = {}   # seq id -> pages held
        self.peak_used = 0

    # --- queries -------------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` of context (at least one)."""
        return max(-(-int(n_tokens) // self.page_size), 1)

    @property
    def used_pages(self) -> int:
        return sum(self._held.values())

    @property
    def free_pages(self) -> int:
        return self.total_pages - self.used_pages

    def pages_of(self, rid) -> int:
        return self._held.get(rid, 0)

    def can_fit(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= self.free_pages

    # --- mutation ------------------------------------------------------------
    def alloc(self, rid, n_tokens: int) -> bool:
        """Admit sequence ``rid`` with ``n_tokens`` of prefilled context.
        False (and no change) if the pool cannot cover it."""
        assert rid not in self._held, f"{rid!r} already resident"
        need = self.pages_needed(n_tokens)
        if need > self.free_pages:
            return False
        self._held[rid] = need
        self.peak_used = max(self.peak_used, self.used_pages)
        return True

    def extend(self, rid, n_tokens: int) -> bool:
        """Grow ``rid``'s allocation to cover ``n_tokens`` total context.
        False (and no change) if the extra pages are not available —
        caller must evict someone and retry."""
        held = self._held[rid]
        need = self.pages_needed(n_tokens)
        if need <= held:
            return True
        if need - held > self.free_pages:
            return False
        self._held[rid] = need
        self.peak_used = max(self.peak_used, self.used_pages)
        return True

    def release(self, rid) -> int:
        """Free all pages of ``rid`` (finish or preemption)."""
        return self._held.pop(rid, 0)
