"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

Fixed-capacity top-k routing (ties to the lower expert, as
``lax.top_k``), dispatched with a stable sort by expert and
a rank within each expert, as the reference does; tokens past an expert's
``capacity`` are dropped.  ``global`` routes the (B*S) tokens as one pool,
``per_seq`` routes each sequence alone (the reference's ``vmap`` over B is
a leading group dim here).

Nothing in the dispatch reads a device value on the host, so the graphed
servers and the graphed train step can capture it: the counts per
expert are a ``scatter_add_`` into a fixed ``(E,)`` tensor (the reference's
``bincount(length=E)``), and the capacity is a host int from static
shapes.  Moves are gathers, so their values and gradients do not depend
on the order of atomic adds:

* dispatch: each (expert, slot) names the selection that fills it (an
  empty slot names a zero row), and the buffer is a gather from the
  tokens repeated k times; each selection fills at most one slot, so the
  gather's backward adds at most one gradient a real row;
* combine: each selection gathers its slot's output, weighted by its gate
  (zero when dropped), and a token's k outputs are summed over the k dim
  in one fixed order (the reference scatter-adds them; the order of that
  sum is the only difference, within fp32 rounding).

The experts' SwiGLU is one batched product over experts, as the
reference's einsums are (no Pallas kernel there either).

Expert placement on a mesh (``dist/spmd.py``): where the experts are
sharded over 'model' (``n_experts % model == 0``), a position holds
experts ``[lo, hi)`` and passes ``experts=(lo, hi)``: it routes over all
experts, runs only its own and returns its partial output; the 'model'
group sums.  Otherwise ``e_ff`` is sharded and each position's products
over its slice of d_ff are partial sums, summed the same way.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import Decl
from repro_torch.models.config import ModelConfig


def moe_decls(cfg: ModelConfig, pre=(), pax=()) -> Dict[str, Decl]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def decl(shape, axes, **kw):
        return Decl(pre + tuple(shape), pax + tuple(axes), **kw)

    return {
        "router": decl((d, e), ("embed", None), scale_dim=-2),
        "we_gate": decl((e, d, f), ("experts", "embed", "e_ff"), scale_dim=-2),
        "we_up": decl((e, d, f), ("experts", "embed", "e_ff"), scale_dim=-2),
        "we_down": decl((e, f, d), ("experts", "e_ff", "embed"), scale_dim=-2),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """fp32 router logits (..., T, E), the top-k experts (..., T, k) and
    their gates, a softmax over the top-k logits.  The top k come from a
    stable descending sort, so equal logits take the lower expert first,
    as ``lax.top_k`` does (``torch.topk`` promises no order on ties: on
    the CPU it took experts 2, 3 of four equal logits)."""
    logits = xf.float() @ router.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_e = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    return logits, top_e, torch.softmax(top_logits, dim=-1)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor,
            per_sequence: Optional[bool] = None,
            experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    ``per_sequence`` (default: ``cfg.moe_dispatch == "per_seq"``) routes
    each sequence alone, with capacity per sequence; otherwise the B*S
    tokens are one pool.  ``experts=(lo, hi)``: ``p``'s expert weights
    hold experts [lo, hi) only, and the result is their part of the
    output (module docstring).
    """
    if per_sequence is None:
        per_sequence = cfg.moe_dispatch == "per_seq"
    b, s, d = x.shape
    if per_sequence and b > 1:
        return _moe_tokens(cfg, p, x, capacity(s, cfg), experts)
    y = _moe_tokens(cfg, p, x.reshape(1, b * s, d), capacity(b * s, cfg),
                    experts)
    return y.reshape(b, s, d)


def _moe_tokens(cfg: ModelConfig, p, xf: torch.Tensor, cap: int,
                experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Route G independent token pools (G, T, D) -> (G, T, D)."""
    g, t, d = xf.shape
    k, e = cfg.top_k, cfg.n_experts
    lo, hi = experts if experts is not None else (0, e)
    dev = xf.device
    tk = t * k

    # --- routing (fp32) ---
    _, top_e, gates = route(cfg, p["router"], xf)          # (G, T, k)

    # --- sort-based dispatch ---
    flat_e = top_e.reshape(g, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, sorted_e, torch.ones_like(sorted_e))
    offsets = torch.cumsum(counts, 1) - counts              # exclusive
    rank = torch.arange(tk, device=dev) - torch.gather(offsets, 1, sorted_e)
    keep = rank < cap
    dest = sorted_e * cap + torch.clamp(rank, max=cap - 1)  # slot of each
    # the selection that fills each (expert, slot); tk (a zero row) where
    # none does; dropped selections all write the spare last entry
    n_slots = e * cap
    src = torch.full((g, n_slots + 1), tk, dtype=torch.long, device=dev)
    src.scatter_(1, torch.where(keep, dest, n_slots), order)
    src = src[:, lo * cap:hi * cap]
    # row j is token j // k; an expand, whose backward sums over k in order
    xk = xf[:, :, None].expand(g, t, k, d).reshape(g, tk, d)
    xk = torch.cat([xk, xk.new_zeros(g, 1, d)], 1)
    buf = torch.gather(xk, 1, src[..., None].expand(-1, -1, d))
    n_loc = hi - lo
    buf = buf.reshape(g, n_loc, cap, d).transpose(0, 1).reshape(
        n_loc, g * cap, d)

    # --- expert FFN (SwiGLU), batched over experts ---
    gt = torch.bmm(buf, p["we_gate"])
    up = torch.bmm(buf, p["we_up"])
    h = torch.bmm(F.silu(gt) * up, p["we_down"])            # (E_loc, G*cap, D)
    h = h.reshape(n_loc, g, cap, d).transpose(0, 1).reshape(g, n_loc * cap, d)

    # --- combine: each selection's slot, in the token's top-k order ---
    slot_of = torch.empty_like(dest).scatter_(1, order, dest)   # (G, T*k)
    kept = torch.empty_like(keep).scatter_(1, order, keep)
    mine = kept & (slot_of >= lo * cap) & (slot_of < hi * cap)
    local = torch.clamp(slot_of - lo * cap, 0, n_loc * cap - 1)
    out = torch.gather(h, 1, local[..., None].expand(-1, -1, d))
    w = (mine.float() * gates.reshape(g, tk)).to(xf.dtype)
    return (out * w[..., None]).reshape(g, t, k, d).sum(2)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (optional, train-time)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    flat = top_e.reshape(-1)
    ce = torch.zeros(n_experts, dtype=torch.float32, device=logits.device)
    ce = ce.scatter_add(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                            device=logits.device))
    ce = ce / ce.sum()
    return n_experts * torch.sum(me * ce)
