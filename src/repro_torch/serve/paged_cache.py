"""Paged KV-cache block allocator (counterpart of
``repro/serve/paged_cache.py``; vLLM-style page accounting).

The cache of a serving replica is carved into fixed-size pages of
``page_size`` tokens; a sequence at ``ctx`` live tokens holds
``ceil(ctx / page_size)`` pages.  This is the *accounting* layer, plain
Python: the continuous-batching server (``serve/scheduler``) admits and
evicts by it.  The physical cache stays a dense ``(slots, max_ctx, ...)``
buffer per slot (a CUDA graph wants static shapes); paging governs
admission, not the layout.  ``page_bytes``, ``replica_page_budget`` and
``kv_headroom_bytes`` size the page budget from the memory model
(``core/simulator/memory``), for the serving simulator and planner; the
server and the simulator share this module's arithmetic, so they cannot
drift.
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


def page_bytes(cfg, page_size: int) -> int:
    """HBM bytes of ONE page of ONE sequence, from the model's own cache
    declarations (attention K/V for ``page_size`` tokens; SSM/conv state
    is constant per sequence and rides the first page)."""
    from repro_torch.core.simulator.memory import kv_cache_bytes
    return kv_cache_bytes(cfg, batch=1, ctx=page_size, page_size=page_size)


def replica_page_budget(cfg, kv_budget_bytes: float,
                        page_size: int) -> int:
    """Pages a replica can hold given ``kv_budget_bytes`` of HBM headroom
    (usable memory minus the params + working-set peak)."""
    pb = page_bytes(cfg, page_size)
    if pb <= 0 or kv_budget_bytes <= 0:
        return 0
    return int(kv_budget_bytes // pb)


def kv_headroom_bytes(profile, layer_lo: int, layer_hi: int, batch: int,
                      tp: int, gpu_type: str, mem_cfg=None) -> float:
    """Unsharded KV bytes that fit on one replica: invert the affine
    ``serving_stage_peak_bytes`` in its ``kv_bytes`` argument against
    usable HBM.  Shared by the simulator's page-budget derivation and the
    planner's replica sizing."""
    from repro_torch.core.profiler.hw_specs import get_accelerator
    from repro_torch.core.simulator import memory as mem
    if mem_cfg is None:
        mem_cfg = mem.serving_mem_cfg()
    usable = get_accelerator(gpu_type).usable_mem_bytes
    base = mem.serving_stage_peak_bytes(profile, layer_lo, layer_hi,
                                        batch, tp, 0.0, mem_cfg)
    if base >= usable:
        return 0.0
    # peak(kv) = base + kv/tp * fragmentation  (kv rides the static stream)
    return (usable - base) * tp / mem_cfg.fragmentation
