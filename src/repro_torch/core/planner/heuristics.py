"""Search-space pruning heuristics H1-H6 (paper §4.2.1).

H1  TP stays within one node -> tp options are powers of two up to
    chips_per_node, and every stage replica uses a single GPU type.
H2  Minimum TP per (stage, GPU type) from the memory model; smaller TP is
    never explored.  Availability-independent, so cached and reused across
    re-plans (``TPTable``).
H3  max-throughput: iterate D in DECREASING order, stop once throughput
    stops improving.
H4  min-cost: iterate D in INCREASING order, stop once a solution inside
    the throughput constraint is found / cost stops decreasing.
H5  DP stays within one region; PP may cross regions (stage -> region
    assignment is monotone over an ordered region list).
H6  zones within a region are planned as one pool; concrete zone spread is
    re-introduced when the plan is materialized.

A copy of ``repro/core/planner/heuristics.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.core.simulator import memory as mem_mod


def tp_options(gpu_type: str) -> List[int]:
    """H1: powers of two within a node."""
    n = get_accelerator(gpu_type).chips_per_node
    out = []
    t = 1
    while t <= n:
        out.append(t)
        t *= 2
    return out


class TPTable:
    """H2: min/valid TP per (P, stage split, mbs, gpu_type); cached.

    Routed through the shared ``stage_peak_bytes`` kernel against *usable*
    HBM, with the schedule carried by ``mem_cfg`` — so the precompute can
    never admit a (stage, tp) the simulator's final check rejects.  Still
    availability-independent (the in-flight count skips the microbatch
    cap), so it survives every replan."""

    def __init__(self, profile: JobProfile,
                 mem_cfg: mem_mod.MemoryModelConfig = mem_mod.DEFAULT_MEM):
        self.profile = profile
        self.mem_cfg = mem_cfg

    @functools.lru_cache(maxsize=None)
    def min_tp(self, pp: int, stage_idx: int, lo: int, hi: int, mbs: int,
               gpu_type: str) -> Optional[int]:
        return mem_mod.min_tp_for_stage(
            self.profile, pp, stage_idx, lo, hi, mbs, gpu_type,
            tuple(tp_options(gpu_type)), self.mem_cfg)


def region_pools(cluster: ClusterSpec) -> Tuple[List[str], List[Dict[str, int]]]:
    """H6: aggregate zone capacity at region granularity.

    Regions ordered by total capacity (descending) so pipelines start in
    the best-provisioned region."""
    regions = cluster.regions
    caps = []
    for r in regions:
        pool: Dict[str, int] = {}
        for z in cluster.zones_in_region(r):
            for t, n in z.capacity.items():
                pool[t] = pool.get(t, 0) + n
        caps.append(pool)
    order = sorted(range(len(regions)),
                   key=lambda i: -sum(caps[i].values()))
    return [regions[i] for i in order], [caps[i] for i in order]


def dp_candidates(global_batch: int, mbs: int, max_d: int,
                  decreasing: bool) -> List[int]:
    """H3/H4: feasible D values ordered per objective.

    ``d * mbs`` must divide ``global_batch``, i.e. ``d`` divides
    ``global_batch // mbs`` — enumerated as divisors in O(sqrt) instead of
    scanning ``1..max_d`` (the scan made the outer loop O(global_batch)
    per (pp, mbs) group at large batch sizes)."""
    if mbs <= 0 or global_batch % mbs:
        return []                # d * mbs can never divide global_batch
    q = global_batch // mbs
    lim = min(max_d, q)
    out = []
    i = 1
    while i * i <= q:
        if q % i == 0:
            if i <= lim:
                out.append(i)
            j = q // i
            if j != i and j <= lim:
                out.append(j)
        i += 1
    return sorted(out, reverse=decreasing)


def mbs_candidates(global_batch: int, cap: int = 8) -> List[int]:
    out = []
    m = 1
    while m <= cap and global_batch % m == 0:
        out.append(m)
        m *= 2
    return out


def pp_candidates(n_layers: int, total_chips: int,
                  max_pp: int = 16) -> List[int]:
    """Pipeline degrees explored (Megatron-style set: small values + powers
    of two and 3/6/12 for odd layer counts), bounded by layers and chips."""
    lim = min(n_layers, total_chips, max_pp)
    cands = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]
    return [p for p in cands if p <= lim]


# Canonical machine balance (bf16 FLOPs per HBM byte) used to weigh
# bytes-bound layers (the embedding gather has ~zero FLOPs but real memory
# traffic) against compute-bound ones in ``balanced_split``.  A fixed
# constant in the middle of the accelerator catalog's balance range — NOT a
# lookup into the catalog, so removing any spec cannot crash the split, and
# GPU-only jobs are no longer weighted by one specific accelerator's
# roofline.  Splits depend only on *relative* layer weights, so any balance
# in the catalog's band yields near-identical cuts (pinned by test).
CANONICAL_FLOPS_PER_BYTE = 132.3


def balanced_split(profile: JobProfile, pp: int) -> List[Tuple[int, int]]:
    """Split the unrolled layer sequence into pp contiguous ranges with
    near-equal compute (embed/head get folded into first/last stages).

    Layer weight is a machine-free roofline at a reference microbatch of
    one: ``max(flops, CANONICAL_FLOPS_PER_BYTE * bytes_moved)``."""
    kinds = profile.layer_kinds()
    cfg = profile.cfg
    tokens = profile.job.seq_len         # mbs = 1 reference microbatch
    n = len(kinds)
    w = []
    for k in kinds:
        flops = profile._layer_flops_per_token(k) * tokens
        bytes_moved = (profile._layer_params(k) * DTYPE_BYTES
                       + 2 * tokens * cfg.d_model * DTYPE_BYTES)
        w.append(max(flops, CANONICAL_FLOPS_PER_BYTE * bytes_moved, 1e-12))
    total = sum(w)
    bounds = [0]
    acc = 0.0
    j = 1
    for i, wi in enumerate(w):
        acc += wi
        while j < pp and acc >= total * j / pp and n - (i + 1) >= pp - j:
            bounds.append(i + 1)
            j += 1
    while len(bounds) < pp:              # force remaining cut points
        bounds.append(bounds[-1] + 1)
    bounds.append(n)
    for k in range(1, pp + 1):           # monotone, non-empty
        bounds[k] = max(bounds[k], bounds[k - 1] + 1)
    for k in range(pp, 0, -1):           # leave room for later stages
        bounds[k] = min(bounds[k], n - (pp - k))
    return [(bounds[i], bounds[i + 1]) for i in range(pp)]
