"""Analytic training-job profile (the Sailor profiler, §4.1); a copy of
``repro/core/profiler/analytic.py`` that gives the same numbers.

The paper profiles one node of each GPU type with torch hooks (fwd/bwd/
update time per layer, per TP degree and microbatch size).  On this rig the
same *profile format* is produced analytically from the architecture config
and the accelerator catalog — a roofline model per layer:

    t = max(FLOPs / (peak * efficiency), bytes / mem_bw) + TP collectives

Because repeated layers are reduced to one instance (exactly the paper's
trick), a profile is O(3) layer kinds per arch: ``embed``, ``block`` (xL),
``head`` (plus hybrid's shared block).  A kernel cost table registered for
the chip being priced (``measured.calibrate_kernels``) replaces the roofline
share of the custom kernels' ops with measured times.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.hw_specs import (AcceleratorSpec, LinkSpec,
                                          get_accelerator)
from repro_torch.core.simulator import network
from repro_torch.models.config import ModelConfig

DTYPE_BYTES = 2          # bf16 compute dtype
GRAD_BYTES = 4           # fp32 grad accumulation


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Cost of ONE layer instance for a given (gpu, tp, mbs)."""
    fwd: float                 # seconds
    bwd: float
    update: float
    params: int                # full (unsharded) parameter count
    act_out_bytes: int         # p2p payload leaving this layer per microbatch
    act_store_bytes: int       # stored activation bytes per microbatch (remat-aware)


@dataclasses.dataclass(frozen=True)
class TrainJob:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    remat: str = "full"        # matches runtime default


@dataclasses.dataclass(frozen=True)
class ServeJob:
    """An inference workload: the serving sibling of :class:`TrainJob`.

    ``JobProfile`` is workload-generic — it only reads ``cfg``, ``seq_len``,
    ``global_batch`` and ``remat`` — so a ``ServeJob`` maps its serving
    vocabulary onto those names (``seq_len`` = prompt length, the sequence
    the *prefill* phase runs; ``global_batch`` = continuous-batching slots
    per replica, the batch the *decode* phase runs) and adds the
    serving-only knobs: per-request context budget, the paged-KV page
    size, and the diurnal traffic model of the user population
    (``core/simulator/serving.TrafficModel`` is built from these).
    """
    cfg: ModelConfig
    prompt_len: int = 512
    max_new_tokens: int = 128
    decode_batch: int = 8        # continuous-batching slots per replica
    page_size: int = 16          # paged-KV page, tokens
    # traffic model (diurnal load of the user population)
    arrival_rps: float = 1.0     # mean request arrival rate
    diurnal_amp: float = 0.5     # rate swings +-amp around the mean
    diurnal_period_s: float = 86400.0
    remat: str = "full"          # unused for serving; JobProfile compat

    @property
    def seq_len(self) -> int:
        return self.prompt_len

    @property
    def global_batch(self) -> int:
        return self.decode_batch

    @property
    def max_ctx(self) -> int:
        """Per-request context budget: prompt + generation."""
        return self.prompt_len + self.max_new_tokens


class JobProfile:
    """Layer-kind cost tables for one training job."""

    def __init__(self, job: TrainJob):
        self.job = job
        self.cfg = job.cfg

    # --- layer inventory -----------------------------------------------------
    def layer_kinds(self) -> List[str]:
        """The unrolled layer sequence the planner partitions over."""
        return ["embed"] + ["block"] * self.cfg.n_layers + ["head"]

    # --- per-layer primitives ---------------------------------------------------
    def _block_flops_per_token(self) -> float:
        cfg = self.cfg
        s = self.job.seq_len
        if cfg.family in ("ssm", "hybrid"):
            matmul = 2 * cfg.ssm_layer_params()
            # SSD chunked term ~ O(S * chunk) per token
            ssd = 4 * cfg.ssm_chunk * cfg.ssm_nheads * cfg.ssm_headdim
            flops = matmul + ssd
            if cfg.family == "hybrid":
                shared = (2 * (cfg.attn_params() + cfg.ffn_params())
                          + 4 * min(s, 10 ** 9) * cfg.n_heads * cfg.hd * 0.5)
                flops += shared / cfg.attn_every
            return flops
        active = (cfg.attn_params()
                  + (cfg.top_k * cfg.ffn_params()
                     + cfg.d_model * cfg.n_experts
                     if cfg.family == "moe" else cfg.ffn_params()))
        matmul = 2 * active
        attn_span = min(s, cfg.window) if cfg.window else s
        attn = 4 * attn_span * cfg.n_heads * cfg.hd * (0.5 if not cfg.window else 1.0)
        return matmul + attn

    def _layer_params(self, kind: str) -> int:
        cfg = self.cfg
        if kind == "embed":
            return cfg.vocab_size * cfg.d_model
        if kind == "head":
            return (0 if cfg.tie_embeddings
                    else cfg.vocab_size * cfg.d_model) + cfg.d_model
        return cfg.layer_params() + (
            cfg.shared_attn_params() // max(cfg.attn_every, 1)
            if cfg.family == "hybrid" else 0)

    def _layer_flops_per_token(self, kind: str) -> float:
        cfg = self.cfg
        if kind == "embed":
            return 0.0                       # gather, bytes-bound
        if kind == "head":
            return 2 * cfg.d_model * cfg.vocab_size
        return self._block_flops_per_token()

    def _inner_width(self) -> int:
        """Per-token units of live intermediate activations of one block.

        Family-aware: residual in/out plus q/k/v heads and the active FFN
        intermediates (MoE: only the ``top_k`` routed experts materialize
        per token; SSM: x/z/B/C/dt projections and the conv/state stream).
        This is what the old ``inner_mult = 12`` constant hand-waved.
        """
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):
            di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
            inner = 2 * cfg.d_model + 2 * di + 2 * n + h  # x,z,B,C,dt streams
            # chunked-SSD materialization (models/mamba2.ssd_chunked): the
            # within-chunk decay tensors (li/ldec/dec_end and their grads)
            # are (.., Q, Q, H) = Q*H per token each, per-head fp32
            # x/dt/y copies are H*P, and the cross-chunk states amortize
            # to H*P*N/Q — together they dominate the projections.
            q, p = max(cfg.ssm_chunk, 1), cfg.ssm_headdim
            inner += 4 * q * h + 3 * h * p + 2 * h * p * cfg.ssm_state // q
            if cfg.family == "hybrid":
                attn = ((cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                        + 3 * cfg.d_ff)
                inner += attn // max(cfg.attn_every, 1)
            return inner
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f_active = (cfg.top_k * cfg.d_ff if cfg.family == "moe" else cfg.d_ff)
        mats = 3 if cfg.ffn_act == "swiglu" else 2
        return 2 * cfg.d_model + (h + 2 * kv) * hd + mats * f_active

    def _act_store_bytes(self, kind: str, mbs: int) -> int:
        cfg = self.cfg
        s = self.job.seq_len
        boundary = mbs * s * cfg.d_model * DTYPE_BYTES
        if self.job.remat == "full" or kind != "block":
            return boundary
        # no remat: all intermediates
        return mbs * s * self._inner_width() * DTYPE_BYTES

    def _act_work_bytes(self, kind: str, mbs: int,
                        act_bytes: int = DTYPE_BYTES,
                        phase: str = "train") -> int:
        """Live working set of ONE layer while it executes (fwd) or is
        rematerialized during backward — the transient on top of the
        *stored* activations counted by :meth:`_act_store_bytes`.

        Remat-aware: under full remat one block's intermediates are
        materialized at a time during the backward recompute; without
        remat they are already stored, so only the gradient stream of
        those intermediates is transiently live (same width).  The head
        is dominated by the fp32 logits + softmax residency — vocab-wide,
        which the old constant missed entirely.  ``act_bytes`` is the
        activation dtype width (2 on the bf16 runtime, 4 on fp32 host
        rigs); the logits/CE term is fp32 regardless and must NOT scale
        with it.
        """
        cfg = self.cfg
        tokens = mbs * self.job.seq_len
        if kind == "embed":
            return tokens * cfg.d_model * act_bytes
        if kind == "head":
            if phase == "serve":
                # inference: one fp32 logits copy, no gradient stream.
                return int(tokens * cfg.vocab_size * GRAD_BYTES
                           + tokens * cfg.d_model * act_bytes)
            # fp32 logits and their gradient live simultaneously in the CE
            # backward (chunked-CE reduces this; modeled unchunked).
            chunk = cfg.logits_chunk or self.job.seq_len
            frac = min(chunk / self.job.seq_len, 1.0)
            return int(2 * tokens * frac * cfg.vocab_size * GRAD_BYTES
                       + tokens * cfg.d_model * act_bytes)
        return tokens * self._inner_width() * act_bytes

    # --- measured-kernel hooks ---------------------------------------------------
    def _layer_kernel_ops(self, kind: str, tp: int, mbs: int
                          ) -> List[Tuple[str, Tuple[int, ...], int]]:
        """(op, shape-key, count) of the custom-kernel ops one layer of
        ``kind`` runs per microbatch — the part of the roofline guess a
        measured :mod:`kernel_costs` table can replace.  Matmul FLOPs stay
        roofline (library GEMMs track peak*efficiency closely; the custom
        kernels are where block sizes/fusion/masking break the model)."""
        cfg = self.cfg
        s = self.job.seq_len
        tokens = mbs * s
        if kind == "embed":
            return []                      # gather: no custom kernel
        if kind == "head":                 # final norm rides with the head
            return [("rmsnorm", (tokens, cfg.d_model), 1)]
        ops: List[Tuple[str, Tuple[int, ...], int]] = [
            ("rmsnorm", (tokens, cfg.d_model), 2)]
        if cfg.family in ("ssm", "hybrid"):
            ops.append(("ssd_scan",
                        (mbs, s, cfg.ssm_nheads, cfg.ssm_headdim,
                         cfg.ssm_state), 1))
            return ops
        if not cfg.window:                 # SWA runs the jnp path, not FA
            heads = max(cfg.n_heads // tp, 1)
            ops.append(("flash_attention", (mbs * heads, s, s, cfg.hd, 1),
                        1))
        return ops

    def _measured_kernel_delta(self, kind: str, gpu_type: str,
                               acc: AcceleratorSpec, tp: int,
                               mbs: int) -> float:
        """Seconds to add to the fwd roofline: sum over covered ops of
        (measured - roofline); ops without table coverage contribute 0,
        i.e. the roofline estimate stands."""
        table = kernel_costs.get_kernel_table(gpu_type)
        if table is None:
            return 0.0
        delta = 0.0
        for op, shape, count in self._layer_kernel_ops(kind, tp, mbs):
            t_meas = table.lookup(op, shape, self.cfg.dtype)
            if t_meas is None:
                continue
            delta += count * (t_meas - kernel_costs.roofline_time(
                op, shape, self.cfg.dtype, acc))
        return delta

    # --- the profile entry ------------------------------------------------------
    def cost(self, kind: str, gpu_type: str, tp: int, mbs: int) -> LayerCost:
        return self._cost(kind, gpu_type, tp, mbs, kernel_costs.epoch())

    @functools.lru_cache(maxsize=100_000)
    def _cost(self, kind: str, gpu_type: str, tp: int, mbs: int,
              _table_epoch: int) -> LayerCost:
        cfg = self.cfg
        acc = get_accelerator(gpu_type)
        s = self.job.seq_len
        tokens = mbs * s
        flops = self._layer_flops_per_token(kind) * tokens / tp
        params = self._layer_params(kind)
        # bytes moved: weights once + activations in/out
        w_bytes = params * DTYPE_BYTES / tp
        a_bytes = 2 * tokens * cfg.d_model * DTYPE_BYTES
        t_compute = max(flops / (acc.peak_flops * acc.efficiency),
                        (w_bytes + a_bytes) / acc.mem_bw)
        # measured kernel tables: replace the roofline share of covered
        # ops with calibrated wall-clock; floor keeps a pathological
        # table (op roofline > whole-layer roofline) from going negative
        t_compute = max(
            t_compute + self._measured_kernel_delta(kind, gpu_type, acc,
                                                    tp, mbs),
            0.1 * t_compute)
        # Megatron TP collectives: 2 all-reduces of the activation per
        # block fwd (bwd doubles), over the intra-node fabric.
        t_tp = 0.0
        if tp > 1 and kind == "block":
            link = LinkSpec(f"intra-{gpu_type}", alpha=5e-6,
                            beta=acc.intra_node_bw)
            t_tp = 2 * network.all_reduce_time(
                link, tokens * cfg.d_model * DTYPE_BYTES, tp)
        fwd = t_compute + t_tp
        bwd = 2 * t_compute + 2 * t_tp
        upd = params / tp * 20 / acc.mem_bw    # read p,g,m,v + write p,m,v
        return LayerCost(
            fwd=fwd, bwd=bwd, update=upd, params=params,
            act_out_bytes=tokens * cfg.d_model * DTYPE_BYTES,
            act_store_bytes=self._act_store_bytes(kind, mbs))

    # --- decode phase (serving) --------------------------------------------------
    def _decode_flops_per_token(self, kind: str, ctx: int) -> float:
        """FLOPs to decode ONE token through one layer with ``ctx`` tokens
        of live context.  Matmuls shrink to matrix-vector products (2x
        active params); attention reads the whole KV cache (no causal
        halving — the single query attends everything)."""
        cfg = self.cfg
        if kind == "embed":
            return 0.0
        if kind == "head":
            return 2 * cfg.d_model * cfg.vocab_size
        if cfg.family in ("ssm", "hybrid"):
            matmul = 2 * cfg.ssm_layer_params()
            # recurrent state update: h (B,H,P,N) read-modify-write
            state = 4 * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
            flops = matmul + state
            if cfg.family == "hybrid":
                ctx_eff = min(ctx, cfg.window) if cfg.window else ctx
                shared = (2 * (cfg.attn_params() + cfg.ffn_params())
                          + 4 * ctx_eff * cfg.n_heads * cfg.hd)
                flops += shared / cfg.attn_every
            return flops
        active = (cfg.attn_params()
                  + (cfg.top_k * cfg.ffn_params()
                     + cfg.d_model * cfg.n_experts
                     if cfg.family == "moe" else cfg.ffn_params()))
        ctx_eff = min(ctx, cfg.window) if cfg.window else ctx
        return 2 * active + 4 * ctx_eff * cfg.n_heads * cfg.hd

    def _kv_read_bytes(self, kind: str, batch: int, ctx: int, tp: int) -> int:
        """Bytes of cache state one layer streams per decode step."""
        cfg = self.cfg
        if kind != "block":
            return 0
        if cfg.family in ("ssm", "hybrid"):
            # SSM state (H, P, N) fp32 read+write; constant in ctx.
            ssm = 2 * batch * cfg.ssm_nheads * cfg.ssm_headdim \
                * cfg.ssm_state * GRAD_BYTES
            if cfg.family == "hybrid":
                ctx_eff = min(ctx, cfg.window) if cfg.window else ctx
                ssm += (2 * batch * ctx_eff * cfg.n_kv_heads * cfg.hd
                        * DTYPE_BYTES) // max(cfg.attn_every, 1)
            return ssm // tp
        ctx_eff = min(ctx, cfg.window) if cfg.window else ctx
        return 2 * batch * ctx_eff * cfg.n_kv_heads * cfg.hd \
            * DTYPE_BYTES // tp

    def _decode_kernel_ops(self, kind: str, tp: int, batch: int, ctx: int
                           ) -> List[Tuple[str, Tuple[int, ...], int]]:
        """Measured-table hook for the decode step (flash_decode tables
        from the ``flash_attention_decode`` kernel)."""
        cfg = self.cfg
        if kind == "embed":
            return []
        if kind == "head":
            return [("rmsnorm", (batch, cfg.d_model), 1)]
        ops: List[Tuple[str, Tuple[int, ...], int]] = [
            ("rmsnorm", (batch, cfg.d_model), 2)]
        if cfg.family in ("ssm", "hybrid"):
            return ops
        heads = max(cfg.n_heads // tp, 1)
        ctx_eff = min(ctx, cfg.window) if cfg.window else ctx
        ops.append(("flash_decode", (batch * heads, ctx_eff, cfg.hd), 1))
        return ops

    def decode_cost(self, kind: str, gpu_type: str, tp: int, batch: int,
                    ctx: int) -> float:
        """Seconds one layer takes for ONE decode step of a ``batch`` of
        sequences at ``ctx`` live context (per TP shard)."""
        return self._decode_cost(kind, gpu_type, tp, batch, ctx,
                                 kernel_costs.epoch())

    @functools.lru_cache(maxsize=100_000)
    def _decode_cost(self, kind: str, gpu_type: str, tp: int, batch: int,
                     ctx: int, _table_epoch: int) -> float:
        cfg = self.cfg
        acc = get_accelerator(gpu_type)
        flops = self._decode_flops_per_token(kind, ctx) * batch / tp
        # decode is bandwidth-bound: full weight read per step + KV stream
        w_bytes = self._layer_params(kind) * DTYPE_BYTES / tp
        kv_bytes = self._kv_read_bytes(kind, batch, ctx, tp)
        a_bytes = 2 * batch * cfg.d_model * DTYPE_BYTES
        t = max(flops / (acc.peak_flops * acc.efficiency),
                (w_bytes + kv_bytes + a_bytes) / acc.mem_bw)
        table = kernel_costs.get_kernel_table(gpu_type)
        if table is not None:
            delta = 0.0
            for op, shape, count in self._decode_kernel_ops(
                    kind, tp, batch, ctx):
                t_meas = table.lookup(op, shape, cfg.dtype)
                if t_meas is None:
                    continue
                delta += count * (t_meas - kernel_costs.roofline_time(
                    op, shape, cfg.dtype, acc))
            t = max(t + delta, 0.1 * t)
        if tp > 1 and kind == "block":
            link = LinkSpec(f"intra-{gpu_type}", alpha=5e-6,
                            beta=acc.intra_node_bw)
            t += 2 * network.all_reduce_time(
                link, batch * cfg.d_model * DTYPE_BYTES, tp)
        return t

    def stage_decode_time(self, layer_lo: int, layer_hi: int, gpu_type: str,
                          tp: int, batch: int, ctx: int) -> float:
        """Seconds per decode step for layers [lo, hi) — the TPOT
        contribution of one pipeline stage."""
        kinds = self.layer_kinds()
        return sum(self.decode_cost(k, gpu_type, tp, batch, ctx)
                   for k in kinds[layer_lo:layer_hi])

    def stage_prefill_time(self, layer_lo: int, layer_hi: int,
                           gpu_type: str, tp: int, batch: int) -> float:
        """Forward-only seconds for a prefill of ``batch`` prompts of
        ``job.seq_len`` tokens through layers [lo, hi)."""
        fwd, _, _ = self.stage_cost(layer_lo, layer_hi, gpu_type, tp, batch)
        return fwd

    # --- aggregates used by planner/simulator ------------------------------------
    def stage_cost(self, layer_lo: int, layer_hi: int, gpu_type: str,
                   tp: int, mbs: int) -> Tuple[float, float, float]:
        """(fwd, bwd, update) seconds for layers [lo, hi) of the unrolled
        sequence (0 = embed, 1..L = blocks, L+1 = head)."""
        kinds = self.layer_kinds()
        fwd = bwd = upd = 0.0
        for k in kinds[layer_lo:layer_hi]:
            c = self.cost(k, gpu_type, tp, mbs)
            fwd += c.fwd
            bwd += c.bwd
            upd += c.update
        return fwd, bwd, upd

    def stage_params(self, layer_lo: int, layer_hi: int) -> int:
        kinds = self.layer_kinds()
        return sum(self._layer_params(k) for k in kinds[layer_lo:layer_hi])

    def stage_act_store(self, layer_lo: int, layer_hi: int, mbs: int) -> int:
        kinds = self.layer_kinds()
        return sum(self._act_store_bytes(k, mbs)
                   for k in kinds[layer_lo:layer_hi])

    def stage_act_work(self, layer_lo: int, layer_hi: int, mbs: int,
                       act_bytes: int = DTYPE_BYTES,
                       phase: str = "train") -> int:
        """Peak transient working set of the stage: one layer executes (or
        rematerializes) at a time, so the stage-wide peak is the widest
        layer in the range, not the sum.  Absolute bytes at ``act_bytes``
        activation width (the fp32 CE term does not scale with it).
        ``phase="serve"`` drops the gradient streams (forward-only)."""
        kinds = self.layer_kinds()
        return max((self._act_work_bytes(k, mbs, act_bytes, phase)
                    for k in kinds[layer_lo:layer_hi]), default=0)

    def boundary_bytes(self, mbs: int) -> int:
        return mbs * self.job.seq_len * self.cfg.d_model * DTYPE_BYTES

    def replica_rate(self, layer_lo: int, layer_hi: int, gpu_type: str,
                     tp: int, mbs: int) -> float:
        """Steady samples/s of one stage replica at ``mbs``: the rate the
        adaptive-microbatching apportionment balances against."""
        fwd, bwd, _ = self.stage_cost(layer_lo, layer_hi, gpu_type, tp, mbs)
        t = fwd + bwd
        return mbs / t if t > 0.0 else 0.0

    def chain_rates(self, plan) -> List[float]:
        """Per-DP-chain steady throughput (samples/s) at the plan's nominal
        mbs — the bottleneck stage replica of each chain.  Only meaningful
        for uniform per-stage dp (chain ``d`` = replica ``d`` of every
        stage), which is what adaptive plans require."""
        rates: List[float] = []
        for d in range(plan.dp):
            r = min(self.replica_rate(s.layer_start, s.layer_end,
                                      s.replicas[d].gpu_type,
                                      s.replicas[d].tp, plan.mbs)
                    for s in plan.stages)
            rates.append(r)
        return rates

    @property
    def n_partition_units(self) -> int:
        return len(self.layer_kinds())
