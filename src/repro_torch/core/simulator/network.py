"""Collective- and point-to-point communication time models (copy of
``repro/core/simulator/network.py``).

The Sailor profiler fits bandwidth-vs-message-size curves per link class
(§4.1) and the simulator uses them for p2p (pipeline sends) and collectives
(TP/DP all-reduce) (§4.3).  We use the standard alpha-beta ring formulation:

    p2p(n)          = alpha + n / beta
    all_reduce(n,k) = 2 (k-1)/k * n / beta + 2 (k-1) alpha
    all_gather(n,k) = (k-1)/k * n / beta + (k-1) alpha   (n = gathered size)
    reduce_scatter  = all_gather
    all_to_all(n,k) = (k-1)/k * n / beta + (k-1) alpha

which matches NCCL/ICI ring behaviour to first order and is exactly the
family of curves the paper fits with a polynomial.
"""
from __future__ import annotations

from repro_torch.core.profiler.hw_specs import LinkSpec


def p2p_time(link: LinkSpec, nbytes: float) -> float:
    return link.time(nbytes)


def all_reduce_time(link: LinkSpec, nbytes: float, k: int) -> float:
    """Ring all-reduce of an ``nbytes`` buffer over ``k`` participants."""
    if k <= 1:
        return 0.0
    return 2.0 * (k - 1) / k * nbytes / link.beta + 2.0 * (k - 1) * link.alpha


def all_gather_time(link: LinkSpec, nbytes: float, k: int) -> float:
    """Ring all-gather; ``nbytes`` is the full gathered size."""
    if k <= 1:
        return 0.0
    return (k - 1) / k * nbytes / link.beta + (k - 1) * link.alpha


def reduce_scatter_time(link: LinkSpec, nbytes: float, k: int) -> float:
    return all_gather_time(link, nbytes, k)


def all_to_all_time(link: LinkSpec, nbytes: float, k: int) -> float:
    if k <= 1:
        return 0.0
    return (k - 1) / k * nbytes / link.beta + (k - 1) * link.alpha


def hierarchical_all_reduce_time(fast: LinkSpec, slow: LinkSpec,
                                 nbytes: float, k_fast: int,
                                 k_slow: int) -> float:
    """Two-level all-reduce: reduce-scatter inside the fast domain, all-reduce
    of the 1/k_fast shard across the slow domain, all-gather back.

    This models both NCCL's tree/hierarchical mode across nodes and the
    ICI-then-DCN pattern on multi-pod TPU, and is what Sailor's H5 exploits:
    the slow-link traffic shrinks by the fast-domain size."""
    if k_fast <= 1:
        return all_reduce_time(slow, nbytes, k_slow)
    if k_slow <= 1:
        return all_reduce_time(fast, nbytes, k_fast)
    t = reduce_scatter_time(fast, nbytes, k_fast)
    t += all_reduce_time(slow, nbytes / k_fast, k_slow)
    t += all_gather_time(fast, nbytes, k_fast)
    return t
