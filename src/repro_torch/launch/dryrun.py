"""Dry run: trace every (arch x shape x mesh) cell on fake tensors
(counterpart of ``repro/launch/dryrun.py``).

For each cell this shows, without a card:
  * the port's own step runs on the mesh (the sharded train step,
    ``train_step.jit_train_step``; the sharded prefill and decode step,
    ``serve_step.make_prefill(cfg, mesh)`` and ``make_decode(cfg, mesh)``),
  * the per-device peak live bytes against the chip's memory (``--chip``,
    default ``"H100"``, the port's card, where the reference's default is
    its ``tpu-v5e``),
  * and the roofline terms: per-device FLOPs and bytes
    (``launch/program_cost.py``) and the collective traffic of the
    collective record (``placement.record_collectives``,
    ``launch/comm.py``), where the reference reads the compiled HLO.

The step runs under ``FakeTensorMode`` on ``meta`` stand-ins of the mesh's
devices (``launch/shapes.py``), priced as the cards
(``device.meta_stands_for_cuda``): it allocates nothing, computes
nothing, and each kernel wrapper takes its fake route (``kernels.ops``:
``FAKE_CALLS``, priced by the planner's kernel formulas).  The default
meshes are the production shapes over fake devices ``cuda:0`` ..
``cuda:n-1`` (``launch/mesh.make_production_mesh(devices=...)``).  The
eager program runs all its positions in lockstep in one process, and
every loop of the step (the layers, a hybrid's groups, the encoder's
layers, the microbatches, the chunked loss's chunks) is replayed: its
first iteration runs once as a trip of the loop's count
(``program_cost.replay``, the reference's ``known_trip_count``), so the
host's work does not grow with depth or microbatches; ``trace_cell(...,
replay=False)`` runs every iteration (the full trace a replay equals).
The artifact records the host seconds of the trace (``trace_s``), the
trips it took and the collective record's entry count.

A long_500k cell of a full-attention arch comes back as a skip
(``shapes.applicable``, as in the reference); every other cell runs, and
an exception is a FAIL, on which the CLI exits non-zero.

Artifacts land in artifacts/dryrun/<arch>__<shape>__<mesh>.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_360m \
      --shape train_4k --mesh single [--audit] [--out artifacts/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.profiler.hw_specs import AcceleratorSpec, get_accelerator
from repro_torch.device import meta_stands_for_cuda
from repro_torch.dist import placement as pm
from repro_torch.kernels import ops
from repro_torch.launch import comm, program_cost
from repro_torch.launch import shapes as shapes_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.program_cost import CostSummary, ProgramCost
from repro_torch.models.config import SHAPES
from repro_torch.serve import serve_step
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib

DEFAULT_CHIP = "H100"


def fake_devices(n: int):
    """``cuda:0`` .. ``cuda:n-1``: the devices a dry run's mesh names (the
    stand-ins it runs on are made by ``shapes.stand_in_mesh``)."""
    return [torch.device("cuda", i) for i in range(n)]


def step_fn_for(cell: shapes_mod.Cell, mesh):
    cfg = cell.cfg
    if cell.kind == "train":
        opt_cfg = opt_lib.OptimizerConfig()
        shape = cell.args[2]["tokens"].shape
        # a trace on fakes, never a graph (the mesh names cards it does
        # not run on)
        return ts_lib.jit_train_step(cfg, opt_cfg, mesh, shape[0], shape[1],
                                     graphed=False)

    if cell.kind == "prefill":
        return serve_step.make_prefill(cfg, mesh)
    return serve_step.make_decode(cfg, mesh)


@dataclasses.dataclass
class Trace:
    """One fake run of a cell's step: its output, its costs, its
    collective record, its kernel calls and the trips it took (loop name
    -> count; empty for a full trace)."""
    out: object
    cost: ProgramCost
    record: pm.CollectiveRecord
    kernel_calls: Dict[str, int]
    host_s: float
    trips: Dict[str, int] = dataclasses.field(default_factory=dict)


def trace_cell(cell: shapes_mod.Cell, step=None, replay: bool = True
               ) -> Trace:
    """Run the cell's step once on its stand-ins under its fake mode:
    each loop of the step replayed as one trip of its count
    (``program_cost.replay``), or with ``replay=False`` every iteration
    (the full trace a replay must equal)."""
    step = step or step_fn_for(cell, cell.mesh)
    base = [b for arg in cell.args for _, x in pm.tree_items(
        arg if isinstance(arg, dict) else {"x": arg}) for b in x.blocks]
    ops.reset_fake_calls()
    trips: Dict[str, int] = {}
    t0 = time.perf_counter()
    with cell.mode, meta_stands_for_cuda(), \
            pm.record_collectives() as record, ProgramCost(base) as cost:
        if replay:
            with program_cost.replay() as trips:
                out = step(*cell.args)
        else:
            out = step(*cell.args)
    host_s = time.perf_counter() - t0
    return Trace(out, cost, record, dict(ops.FAKE_CALLS), host_s,
                 dict(trips))


def trace_differences(full: Trace, replayed: Trace, rel: float = 1e-9
                      ) -> List[str]:
    """Where a replayed trace is not the full one: per device FLOPs and
    bytes beyond ``rel`` relative, peak live bytes not equal, fake kernel
    calls or collective record entries not equal (empty: the same
    program)."""
    out = []
    fs, rs = full.cost.summary(), replayed.cost.summary()
    if sorted(fs) != sorted(rs):
        out.append(f"devices {sorted(fs)} != {sorted(rs)}")
    for dev in sorted(set(fs) & set(rs)):
        f, r = fs[dev], rs[dev]
        for name in ("flops", "bytes_accessed"):
            a, b = getattr(f, name), getattr(r, name)
            if abs(a - b) > rel * abs(a):
                out.append(f"{dev} {name} {a!r} != {b!r}")
        if f.peak_bytes != r.peak_bytes:
            out.append(f"{dev} peak_bytes {f.peak_bytes} != {r.peak_bytes}")
    if full.kernel_calls != replayed.kernel_calls:
        out.append(f"kernel calls {full.kernel_calls} != "
                   f"{replayed.kernel_calls}")
    a, b = full.record.entries, replayed.record.entries
    if a != b:
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        out.append(f"records of {len(a)} and {len(b)} entries differ from "
                   f"entry {first}")
    return out


def device_costs(cell: shapes_mod.Cell, trace: Trace) -> Dict[str, CostSummary]:
    """Per device the mesh names: its FLOPs, bytes and peak from the trace,
    its collective traffic from the record (each of its positions is a
    member of every recorded collective)."""
    per = trace.cost.summary()
    stats = comm.collective_bytes(trace.record)
    n_pos: Dict[str, int] = {}
    for d in cell.mesh.device_list:
        n_pos[str(d)] = n_pos.get(str(d), 0) + 1
    out = {}
    for stand_in, name in cell.devices.items():
        c = per.get(stand_in, CostSummary())
        k = n_pos[stand_in]
        c.collective_traffic = k * stats.total_traffic
        c.collective_bytes = k * float(stats.total_bytes)
        c.collective_by_kind = {kind: k * v[2]
                                for kind, v in stats.by_kind.items()}
        out[name] = c
    return out


def _audit_cell(cfg, cell, mesh, record, tag: str) -> Dict:
    """Collective audit of one traced train cell: the record's volumes
    against the simulator's predicted comm terms
    (``analysis.audit.predicted_comm``).  Advisory: the report rides on
    the artifact; ``repro_torch.analysis.demo`` is the pass/fail gate."""
    from repro_torch.analysis import audit as audit_mod
    from repro_torch.analysis import collectives as coll_mod
    from repro_torch.core.profiler.analytic import JobProfile, TrainJob
    sizes = dict(mesh.shape)
    tp = int(sizes.get("model", 1))
    dp = 1
    for a in ("pod", "data"):
        dp *= int(sizes.get(a, 1))
    n_micro = max(1, int(cell.num_microbatches or 1))
    mbs = max(1, cell.shape.global_batch // (dp * n_micro))
    job = TrainJob(cfg=cfg, seq_len=cell.shape.seq_len,
                   global_batch=cell.shape.global_batch)
    predicted = audit_mod.predicted_comm(JobProfile(job), tp=tp, dp=dp,
                                         mbs=mbs, n_micro=n_micro)
    topo = coll_mod.DeviceTopology.from_mesh(mesh, zone_axes=("pod",))
    return audit_mod.audit_collectives(record, topo, predicted,
                                       tag=tag).to_dict()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str, mesh=None, overrides: Optional[Dict] = None,
             tag: str = "", chip: str = DEFAULT_CHIP,
             audit: bool = False) -> Dict:
    acc: AcceleratorSpec = get_accelerator(chip)
    cfg = get_config(arch)
    nm_override = 0
    if overrides:
        overrides = dict(overrides)
        nm_override = overrides.pop("num_microbatches", 0)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, devices=fake_devices(512 if multi_pod else 256))
    mesh_name = "multi" if multi_pod else "single"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chip": chip,
                 "mesh_shape": dict(mesh.shape), "ok": False, "tag": tag,
                 "overrides": dict(overrides or {},
                                   **({"num_microbatches": nm_override}
                                      if nm_override else {}))}
    t0 = time.perf_counter()
    try:
        cell = shapes_mod.build_cell(cfg, shape_name, mesh,
                                     nm_override=nm_override)
        if cell.skip_reason:
            rec.update(ok=True, skipped=True, skip_reason=cell.skip_reason)
            return _save(rec, out_dir)
        rec["num_microbatches"] = cell.num_microbatches
        t_build = time.perf_counter()
        trace = trace_cell(cell)
        per = device_costs(cell, trace)
        # the busiest device: per device == per chip
        flops_dev = max(c.flops for c in per.values())
        bytes_dev = max(c.bytes_accessed for c in per.values())
        peak_dev = max(c.peak_bytes for c in per.values())
        coll_dev = max(c.collective_traffic for c in per.values())
        by_kind = max(per.values(),
                      key=lambda c: c.collective_traffic).collective_by_kind
        raw = comm.collective_bytes(trace.record)
        n_chips = len(per)
        t_comp = flops_dev / acc.peak_flops
        t_mem = bytes_dev / acc.mem_bw
        t_coll = coll_dev / acc.collective_link_bw
        tokens = cell.shape.global_batch * (
            cell.shape.seq_len if cell.kind != "decode" else 1)
        model_flops = 6 * cfg.active_params() * tokens \
            if cell.kind == "train" else 2 * cfg.active_params() * tokens
        total_flops = sum(c.flops for c in per.values())
        rec.update(
            ok=True, skipped=False,
            build_s=t_build - t0, trace_s=trace.host_s, trips=trace.trips,
            record_entries=len(trace.record.entries),
            ops_dispatched=trace.cost.dispatched,
            n_chips=n_chips, n_positions=mesh.size,
            per_device={
                "flops": flops_dev,
                "bytes_accessed": bytes_dev,
                "argument_bytes": max(trace.cost.base.values(), default=0),
                "peak_bytes": peak_dev,
            },
            by_device={name: dataclasses.asdict(c)
                       for name, c in per.items()} if n_chips <= 16 else None,
            fits_hbm=bool(peak_dev <= acc.mem_bytes),
            collectives={k: {"traffic": v} for k, v in by_kind.items()},
            collectives_raw={k: {"count": v[0], "bytes": v[1],
                                 "traffic": v[2]}
                             for k, v in raw.by_kind.items()},
            kernel_calls={k: v for k, v in trace.kernel_calls.items() if v},
            roofline={
                "compute_s": t_comp,
                "memory_s": t_mem,
                "collective_s": t_coll,
                # multi-pod upper bound: all collective traffic priced at
                # the cross-pod bandwidth
                "collective_dcn_s": (coll_dev / acc.cross_pod_bw
                                     if multi_pod else None),
                "dominant": max(
                    [("compute", t_comp), ("memory", t_mem),
                     ("collective", t_coll)], key=lambda kv: kv[1])[0],
            },
            model_flops_total=model_flops,
            program_flops_total=total_flops,
            useful_flops_ratio=(model_flops / total_flops
                                if total_flops else None),
        )
        if audit and cell.kind == "train":
            rec["audit"] = _audit_cell(
                cfg, cell, mesh, trace.record,
                tag=f"{arch}__{shape_name}__{mesh_name}")
    except Exception as e:     # a failing cell is a bug: record it loudly
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return _save(rec, out_dir)


def _save(rec: Dict, out_dir: str) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir,
        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides k=v (int/float/str), e.g. "
                         "moe_dispatch=per_seq logits_chunk=512")
    ap.add_argument("--tag", default="",
                    help="artifact suffix for variant runs")
    ap.add_argument("--chip", default=DEFAULT_CHIP,
                    help="accelerator catalog entry to price the roofline "
                         "against (hw_specs.ACCELERATORS)")
    ap.add_argument("--audit", action="store_true",
                    help="run the collective auditor (repro_torch.analysis) "
                         "on each train cell and record the report in the "
                         "artifact (advisory; the gate is "
                         "repro_torch.analysis.demo)")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    mesh_cache = {mp: make_production_mesh(
        multi_pod=mp, devices=fake_devices(512 if mp else 256))
        for mp in meshes}
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.perf_counter()
                rec = run_cell(arch, shape, mp, args.out,
                               mesh=mesh_cache[mp], overrides=overrides,
                               tag=args.tag, chip=args.chip,
                               audit=args.audit)
                dt = time.perf_counter() - t0
                if rec.get("skipped"):
                    status = "SKIP"
                elif rec["ok"]:
                    status = ("OK  " if rec.get("fits_hbm") else "OK!M")
                else:
                    status = "FAIL"
                    failures += 1
                dom = rec.get("roofline", {}).get("dominant", "-")
                mem_gb = rec.get("per_device", {}).get("peak_bytes", 0) / 1e9
                print(f"[{status}] {arch:15s} {shape:12s} "
                      f"{'multi' if mp else 'single':6s} {dt:7.1f}s "
                      f"mem={mem_gb:6.2f}GB dom={dom}", flush=True)
                if status == "FAIL":
                    print("   ", rec.get("error"), flush=True)
                elif status == "SKIP":
                    print("   ", rec.get("skip_reason"), flush=True)
    if failures:
        print(f"{failures} dry-run cells FAILED")
        return 1
    print("all requested dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
