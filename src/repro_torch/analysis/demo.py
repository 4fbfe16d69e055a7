"""End-to-end collective-audit demo on a 2-zone mesh (counterpart of
``repro/analysis/demo.py``, the audit's pass/fail gate).

Runs a small training step (forward, backward, the gradients summed
over their replicas) of LAYERS shared MLP layers on a (pod=2, data=2,
model=2) mesh (the 'pod' axis crosses zones), records its
collectives (``placement.record_collectives``) and audits them against
the closed-form prediction, in two variants.  The layer takes its
collectives from the specs it is given, as ``dist/spmd.py`` takes them
from its ``Layout``: ``w1`` is stored over 'model' by rows and ``w2`` by
columns, and the activation stream's spec decides the rest.

* **clean**: the stream is split ``P(("pod","data"), "model")``
  (sequence/activation parallel).  Each layer's ``h @ w1`` is a partial
  sum of the hidden activation that one all-reduce over 'model'
  completes (its transpose, another, in the backward); ``@ w2`` keeps
  the stream split.  The audit comes back empty, volumes within
  tolerance.
* **seeded**: the stream's "model" part is dropped from that one spec.
  The layer then gathers ``w1`` whole and the stream after ``@ w2`` (two
  all-gathers a layer, two reduce-scatters in the backward) and the TP
  all-reduces vanish: the audit reports a ``VolumeMismatch`` on the
  all-reduce volume and the reduce-scatters as ``UnpricedCollective``.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.demo [--variant both]
        [--out artifacts/analysis] [--device cpu]

It runs on the card (every position on ``cuda:0``) unless ``--device``
names another device.  Exit status is 0 iff the clean variant audits
clean AND the seeded variant produces at least one error finding.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch

from repro_torch.analysis import audit as audit_mod
from repro_torch.analysis import collectives as coll_mod
from repro_torch.analysis.findings import Report
from repro_torch.device import resolve_device
from repro_torch.dist import mesh as mesh_lib
from repro_torch.dist import placement as pm
from repro_torch.dist.sharding import P
from repro_torch.launch.comm import ring_traffic

BATCH, D_MODEL, D_FF, LAYERS = 16, 32, 64, 4
PODS, DP, TP = 2, 2, 2
MIN_BYTES = 64          # below the 1 KiB TP all-reduces, above scalars
MODEL = "model"
W1_SPEC, W2_SPEC = P(MODEL, None), P(None, MODEL)


def stream_spec(constrained: bool) -> P:
    """The activation stream's spec: split over 'model' (clean) or with
    that part dropped (seeded)."""
    return P(("pod", "data"), MODEL if constrained else None)


def _layer(h: List[torch.Tensor], w1: List[torch.Tensor],
           w2: List[torch.Tensor], mesh, stream: P) -> List[torch.Tensor]:
    """One MLP layer over every position, its collectives read off the
    specs: a stream split over 'model' contracts with ``w1``'s local rows
    (a partial hidden, summed over 'model') and leaves ``@ w2`` split; a
    whole stream needs ``w1`` gathered and the split ``@ w2`` gathered
    back."""
    if stream[1] == MODEL:
        hid = pm.all_reduce_sum([x @ w for x, w in zip(h, w1)], mesh, MODEL)
        return [torch.relu(x) @ w for x, w in zip(hid, w2)]
    w1f = pm.all_gather(w1, mesh, MODEL, 0)
    out = [torch.relu(x @ w) @ v for x, w, v in zip(h, w1f, w2)]
    return pm.all_gather(out, mesh, MODEL, 1)


def run_variant(constrained: bool, device) -> tuple:
    """One step of the demo on the (pod, data, model) mesh of ``device``
    repeated: (its collective record, the mesh, the loss)."""
    mesh = mesh_lib.pod_data_model_mesh(PODS, DP, TP,
                                        [torch.device(device)] * 8)
    gen = torch.Generator().manual_seed(0)
    w1 = pm.shard(torch.randn(D_MODEL, D_FF, generator=gen) * 0.1,
                  W1_SPEC, mesh)
    w2 = pm.shard(torch.randn(D_FF, D_MODEL, generator=gen) * 0.1,
                  W2_SPEC, mesh)
    stream = stream_spec(constrained)
    x = pm.shard(torch.randn(BATCH, D_MODEL, generator=gen), stream, mesh)
    leaves = [w.with_blocks([b.requires_grad_() for b in w.blocks])
              for w in (w1, w2)]
    with pm.record_collectives() as record:
        h = x.blocks
        for _ in range(LAYERS):
            h = _layer(h, leaves[0].blocks, leaves[1].blocks, mesh, stream)
        dev0 = mesh.device_list[0]
        # the mean over the global stream, each block counted once
        loss = sum((h[p].float() ** 2).sum().to(dev0)
                   for p in pm.owners(stream, mesh)) / (BATCH * D_MODEL)
        grads = torch.autograd.grad(
            loss, [b for w in leaves for b in w.blocks])
        with torch.no_grad():       # each weight's true gradient
            n = mesh.size
            for i, w in enumerate(leaves):
                pm.replica_group_sum(w.with_blocks(
                    list(grads[i * n:(i + 1) * n])))
    return record, mesh, loss.item()


def predicted() -> Dict[str, float]:
    """Closed-form per-device comm of the *clean* program — the Megatron
    accounting ``analytic.py``/``timing.py`` charge, for the port's
    program.

    With the stream split over 'model' and ``w1`` stored by rows over
    'model', each layer's ``h @ w1`` produces partial sums of the hidden
    activation (local_batch x D_FF, fp32) that one all-reduce over
    'model' combines, forward and again (its transpose) in the backward:
    2 x LAYERS all-reduces of the local hidden.  The weights' gradients
    are summed over their replicas (pod x data) once a step
    (``placement.replica_group_sum``, after the backward), one all-reduce
    of each weight's 'model' block: 2 all-reduces of D_MODEL x D_FF / TP
    fp32.  (XLA syncs the scan-carried gradients inside the loop body,
    once a layer, which is why the reference's prediction has 2 x LAYERS
    of them.)"""
    local_hidden = (BATCH // (PODS * DP)) * D_FF * 4
    tp_traffic = 2 * LAYERS * ring_traffic("all-reduce", local_hidden, TP)
    grad_local = (D_MODEL * D_FF // TP) * 4
    dp_traffic = 2 * ring_traffic("all-reduce", grad_local, PODS * DP)
    return {"all-reduce": tp_traffic + dp_traffic}


def audit_variant(constrained: bool, out_dir: str, device) -> Report:
    record, mesh, loss = run_variant(constrained, device)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"demo step: loss {loss}")
    topo = coll_mod.DeviceTopology.from_mesh(mesh, zone_axes=("pod",),
                                             chips_per_node=4)
    tag = "demo_clean" if constrained else "demo_seeded"
    report = audit_mod.audit_collectives(record, topo, predicted(),
                                         min_bytes=MIN_BYTES, tag=tag)
    path = report.save(out_dir)
    print(report.render())
    print(f"  -> {path}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.demo",
        description="collective-audit demo: clean vs seeded-mismatch cell")
    ap.add_argument("--variant", default="both",
                    choices=["clean", "seeded", "both"])
    ap.add_argument("--out", default="artifacts/analysis")
    ap.add_argument("--device", default=None,
                    help="device of every position (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ok = True
    if args.variant in ("clean", "both"):
        clean = audit_variant(True, args.out, device)
        if not clean.ok or clean.findings:
            print("FAIL: clean variant should audit with zero findings")
            ok = False
        else:
            rel = clean.summary.get("rel_diff", {}).get("all-reduce")
            print(f"clean variant: 0 findings "
                  f"(all-reduce volume within {rel:.1%} of prediction)")
    if args.variant in ("seeded", "both"):
        seeded = audit_variant(False, args.out, device)
        kinds = seeded.by_kind()
        if not seeded.errors():
            print("FAIL: seeded variant should produce error findings")
            ok = False
        else:
            print(f"seeded variant: {json.dumps(kinds)} — the dropped "
                  f"'model' part of the stream's spec was caught")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
