"""Per-worker peak-memory model (paper §4.3, validated like Fig. 3/5a).

    M_peak = (M_model + M_activation + M_comm) * fragmentation + overhead

``M_model = stage_params / tp * mul_factor`` where mul_factor covers the
copies the paper lists [41]: parameters + gradients + optimizer moments.
Our runtime keeps bf16 params (2B) + fp32 grads (4B) + fp32 m,v (8B)
= 14 B/param; Megatron-style fp32 master adds 4 more.

``M_activation`` is per-worker, stage- AND schedule-dependent (the paper's
key point versus prior work): the number of microbatches whose stored
activations are in flight comes from the *engine's* warmup depth —
``min(P - i, M)`` under 1F1B, the Megatron virtual-stage warmup under the
interleaved schedule (which holds MORE, the classic interleaving memory
tax) — and the transient working set on top is the profiler's remat-aware
widest-layer accounting (:meth:`JobProfile.stage_act_work`), not a
hand-waved constant.

Everything funnels through ONE kernel, :func:`stage_peak_bytes`:
``worker_peak_bytes`` (the simulator / ``plan_memory``), ``min_tp_for_stage``
(planner H2 precompute) and the baselines' ``plan_fits`` all call it, so a
feasibility verdict is identical everywhere downstream.  Feasibility is
checked against *usable* HBM (``AcceleratorSpec.usable_mem_bytes`` — raw
capacity minus the runtime's reserved fraction), and the ``fragmentation``
/ ``runtime_overhead`` coefficients are fitted against real XLA
``memory_analysis()`` by ``core/profiler/measured.calibrate_memory``
(CI-gated in ``benchmarks/memory_accuracy.py``).

A copy of ``repro/core/simulator/memory.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler import kernel_costs
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile
from repro_torch.core.profiler.hw_specs import get_accelerator


@dataclasses.dataclass(frozen=True)
class MemoryModelConfig:
    param_bytes: int = 2            # bf16 params
    grad_bytes: int = 4             # fp32 grads
    opt_bytes: int = 8              # adam m+v fp32
    master_bytes: int = 0           # optional fp32 master copy
    act_bytes: int = DTYPE_BYTES    # activation dtype (4 on fp32 host rigs)
    # calibratable surface (measured.calibrate_memory fits these three
    # against XLA memory_analysis of compiled training / stage programs):
    fragmentation: float = 1.05     # allocator fragmentation multiplier
    act_fragmentation: float = 1.25    # XLA workspace scales with the
    #                                    activation stream, not the params
    runtime_overhead: float = 0.75e9   # fixed allocator/runtime cost, bytes
    # schedule awareness (simulate() overrides from its EngineConfig so the
    # memory verdict matches the schedule being timed):
    dp_bucket_frac: float = 0.1     # live DP gradient-bucket fraction
    schedule: str = "1f1b"          # "1f1b" | "interleaved"
    virtual_stages: int = 1         # model chunks per worker (interleaved)

    @property
    def mul_factor(self) -> int:
        return (self.param_bytes + self.grad_bytes + self.opt_bytes
                + self.master_bytes)


DEFAULT_MEM = MemoryModelConfig()


def in_flight_microbatches(pp: int, stage_idx: int,
                           schedule: str = "1f1b", virtual_stages: int = 1,
                           num_micro: Optional[int] = None) -> float:
    """Stored-activation microbatches held by stage ``stage_idx``, matching
    the engine's warmup depth (``engine.one_f_one_b_order`` /
    ``engine.interleaved_order``).

    1F1B: stage i fills ``P - i`` forwards before its first backward, so it
    holds ``min(P - i, M)`` microbatches.  Interleaved: worker i warms up
    ``(P - i - 1) * 2 + (v - 1) * P`` chunk-forwards (+1 in flight), each
    chunk storing 1/v of the stage — MORE total than 1F1B, the documented
    memory cost of virtual stages.  ``num_micro=None`` (availability-
    independent callers like the H2 precompute) skips the M cap, which is
    conservative.
    """
    v = max(virtual_stages, 1)
    if schedule == "interleaved" and v > 1:
        chunks = (pp - stage_idx - 1) * 2 + (v - 1) * pp + 1
        if num_micro is not None:
            chunks = min(chunks, num_micro * v)
        return chunks / v
    in_flight = pp - stage_idx
    if num_micro is not None:
        in_flight = min(in_flight, num_micro)
    return float(max(in_flight, 1))


def stage_memory_components(profile: JobProfile, layer_lo: int,
                            layer_hi: int, mbs: int, tp: int,
                            in_flight: float,
                            mem_cfg: MemoryModelConfig = DEFAULT_MEM,
                            kv_bytes: float = 0.0,
                            phase: str = "train") -> Dict[str, float]:
    """Structural bytes of one TP shard, split into the two streams the
    calibration fits independently: ``static`` (params + grads + optimizer
    + comm buffers — exact dtype arithmetic) and ``act`` (stored + working
    activations — where XLA's workspace/padding multiplier lives).

    ``kv_bytes`` is the *unsharded* resident KV/state-cache footprint of
    this stage's share of the model (serving workloads; see
    :func:`kv_cache_bytes`) — it rides the ``static`` stream because,
    like the parameters, it is exact dtype arithmetic with no XLA
    workspace multiplier.  ``phase="serve"`` drops the gradient streams
    from the transient working set."""
    act_scale = mem_cfg.act_bytes / DTYPE_BYTES
    params = profile.stage_params(layer_lo, layer_hi)
    m_model = params / tp * mem_cfg.mul_factor
    # comm buffers: p2p send/recv + the live DP gradient bucket
    m_comm = 2 * profile.boundary_bytes(mbs) * act_scale / tp \
        + mem_cfg.dp_bucket_frac * params / tp * mem_cfg.grad_bytes

    act_store = profile.stage_act_store(layer_lo, layer_hi, mbs) * act_scale
    # the working set takes the dtype width directly: its fp32 CE-logits
    # term must not scale with the activation dtype
    working = profile.stage_act_work(layer_lo, layer_hi, mbs,
                                     mem_cfg.act_bytes, phase)
    m_act = (in_flight * act_store + working) / tp
    return {"static": m_model + m_comm + kv_bytes / tp, "act": m_act}


def combine_peak(static: float, act: float,
                 mem_cfg: MemoryModelConfig = DEFAULT_MEM) -> float:
    """Fold the two structural streams into predicted peak bytes.  The
    calibration benchmark and tests use this same helper, so the gated
    formula cannot drift from what the planner runs."""
    return (static + act * mem_cfg.act_fragmentation) \
        * mem_cfg.fragmentation + mem_cfg.runtime_overhead


def stage_peak_bytes(profile: JobProfile, layer_lo: int, layer_hi: int,
                     mbs: int, tp: int, in_flight: float,
                     mem_cfg: MemoryModelConfig = DEFAULT_MEM,
                     kv_bytes: float = 0.0,
                     phase: str = "train") -> float:
    """THE shared peak-bytes kernel: one TP shard of one stage replica.

    Every feasibility decision (simulate -> planner -> baselines -> manager
    replans, training AND serving) routes through here, so the model cannot
    drift between the search-time precompute and the final OOM check.
    Serving callers pass their resident paged-KV footprint via ``kv_bytes``
    and ``phase="serve"`` (no grads); training callers leave the defaults.
    """
    c = stage_memory_components(profile, layer_lo, layer_hi, mbs, tp,
                                in_flight, mem_cfg, kv_bytes, phase)
    return combine_peak(c["static"], c["act"], mem_cfg)


def worker_peak_bytes(profile: JobProfile, plan: ParallelPlan,
                      stage_idx: int, tp: int,
                      mem_cfg: MemoryModelConfig = DEFAULT_MEM,
                      replica_idx: Optional[int] = None) -> float:
    """Peak bytes for ONE worker (one TP shard of one replica) of a stage.

    ``replica_idx`` selects that replica's OWN microbatch size/count under
    an adaptive :class:`~repro.core.planner.plan.BatchAssignment`; ``None``
    keeps the plan-nominal (largest) size — the conservative bound, and
    byte-identical for uniform plans either way."""
    stage = plan.stages[stage_idx]
    if replica_idx is None:
        mbs, n_micro = plan.mbs, plan.num_microbatches
    else:
        mbs = plan.replica_mbs(replica_idx)
        n_micro = plan.replica_n_micro(replica_idx)
    in_flight = in_flight_microbatches(
        plan.pp, stage_idx, mem_cfg.schedule, mem_cfg.virtual_stages,
        num_micro=max(n_micro, 1))
    peak = stage_peak_bytes(profile, stage.layer_start, stage.layer_end,
                            mbs, tp, in_flight, mem_cfg)
    if plan.staleness > 0:
        # bounded-staleness sync buffers one extra combined-gradient shard
        # per lag slot while the delayed all-reduce drains
        peak += plan.staleness \
            * profile.stage_params(stage.layer_start, stage.layer_end) \
            / tp * mem_cfg.grad_bytes * mem_cfg.fragmentation
    return peak


def plan_memory(profile: JobProfile, plan: ParallelPlan,
                mem_cfg: MemoryModelConfig = DEFAULT_MEM
                ) -> List[List[Dict]]:
    """Per stage, per replica:
    {'gpu_type','tp','peak','capacity','usable','ok'} — ``ok`` gates on
    usable HBM (capacity minus the runtime's reserved fraction).  Adaptive
    plans are gated per replica at that replica's own microbatch size."""
    out: List[List[Dict]] = []
    for i, stage in enumerate(plan.stages):
        row = []
        for d, rep in enumerate(stage.replicas):
            peak = worker_peak_bytes(profile, plan, i, rep.tp, mem_cfg,
                                     replica_idx=d)
            acc = get_accelerator(rep.gpu_type)
            row.append({"gpu_type": rep.gpu_type, "tp": rep.tp,
                        "peak": peak, "capacity": acc.mem_bytes,
                        "usable": acc.usable_mem_bytes,
                        "ok": peak <= acc.usable_mem_bytes})
        out.append(row)
    return out


def plan_fits(profile: JobProfile, plan: ParallelPlan,
              mem_cfg: MemoryModelConfig = DEFAULT_MEM) -> bool:
    return all(r["ok"] for row in plan_memory(profile, plan, mem_cfg)
               for r in row)


def min_tp_for_stage(profile: JobProfile, plan_pp: int, stage_idx: int,
                     layer_lo: int, layer_hi: int, mbs: int,
                     gpu_type: str, tp_options,
                     mem_cfg: MemoryModelConfig = DEFAULT_MEM):
    """Paper H2: smallest TP of ``gpu_type`` that avoids OOM for this stage.

    Independent of cluster availability, so the planner precomputes and
    reuses it across availability changes (the paper notes exactly this) —
    which is why the in-flight count here skips the microbatch cap (M
    depends on the DP degree, which is availability-dependent).  Routes
    through the same :func:`stage_peak_bytes` kernel as the simulator's
    final check, so the precompute can never admit what the check rejects.
    Returns None if even max TP does not fit usable HBM."""
    usable = get_accelerator(gpu_type).usable_mem_bytes
    in_flight = in_flight_microbatches(
        plan_pp, stage_idx, mem_cfg.schedule, mem_cfg.virtual_stages)
    for tp in sorted(tp_options):
        peak = stage_peak_bytes(profile, layer_lo, layer_hi, mbs, tp,
                                in_flight, mem_cfg)
        if peak <= usable:
            return tp
    return None


# --- serving (params + KV residency, no grads/optimizer) ----------------------

def kv_cache_bytes(cfg, batch: int, ctx: int, page_size: int = 16) -> int:
    """Resident bytes of one replica's paged KV/state cache: ``batch``
    sequences at ``ctx`` live tokens each, page-granular —
    ``ceil(ctx/page)`` pages of ``page_size`` tokens are allocated per
    sequence.  Family-aware via the model's own ``cache_decls``: attention
    K/V grow with context (SWA archs cap at the window because the decl
    does), SSM conv/state buffers are constant-size, hybrids mix both."""
    from repro_torch.models.model import cache_decls  # lazy: models pull in torch
    page = max(int(page_size), 1)
    pages = max(-(-int(ctx) // page), 1)
    dt = kernel_costs.DTYPE_BYTES.get(cfg.dtype, DTYPE_BYTES)
    total = 0
    for name, decl in cache_decls(cfg, batch, pages * page).items():
        if name == "len":
            continue
        n = 1
        for d in decl.shape:
            n *= d
        total += n * dt
    return total


def serving_mem_cfg(base: MemoryModelConfig = DEFAULT_MEM
                    ) -> MemoryModelConfig:
    """The memory model an inference replica actually runs: bf16 params
    only (no grads / optimizer moments / master copy / DP buckets)."""
    return dataclasses.replace(base, grad_bytes=0, opt_bytes=0,
                               master_bytes=0, dp_bucket_frac=0.0)


def serving_stage_peak_bytes(profile: JobProfile, layer_lo: int,
                             layer_hi: int, batch: int, tp: int,
                             kv_bytes: float,
                             mem_cfg: Optional[MemoryModelConfig] = None
                             ) -> float:
    """Peak bytes of one TP shard of a serving-stage replica: params + its
    share of the paged KV cache + the transient prefill working set.
    ``kv_bytes`` is the stage's unsharded cache footprint (scale the
    replica-wide :func:`kv_cache_bytes` by the stage's layer fraction).
    Routes through :func:`stage_peak_bytes` — same kernel as training."""
    if mem_cfg is None:
        mem_cfg = serving_mem_cfg()
    return stage_peak_bytes(profile, layer_lo, layer_hi, batch, tp,
                            in_flight=0.0, mem_cfg=mem_cfg,
                            kv_bytes=kv_bytes, phase="serve")


def min_tp_for_serving(profile: JobProfile, layer_lo: int, layer_hi: int,
                       batch: int, gpu_type: str, tp_options,
                       kv_bytes: float,
                       mem_cfg: Optional[MemoryModelConfig] = None):
    """Frenzy-style memory-aware selection: smallest TP of ``gpu_type``
    where params + KV residency fit usable HBM.  None if even max TP
    does not fit."""
    usable = get_accelerator(gpu_type).usable_mem_bytes
    for tp in sorted(tp_options):
        peak = serving_stage_peak_bytes(profile, layer_lo, layer_hi,
                                        batch, tp, kv_bytes, mem_cfg)
        if peak <= usable:
            return tp
    return None
