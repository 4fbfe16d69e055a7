"""Precision of the attention backward on a trained model's own inputs.

    python3 -m repro_torch.bench.attention_bwd_precision    # from src/, on a GPU

Trains smollm-360M (32 layers, bf16, full remat) for the train phase's 12
steps (``chip_smoke.py``: seq 1024, global batch 8, 2 microbatches, AdamW
lr 1e-3, 2 warmup steps), then takes the gradient of one sequence and
captures the attention backward's inputs (q, k, v, dO, LSE) of the layers
at the top, the middle and the bottom of the stack.  For each it prints
one JSON line: the relative error (||x - ref|| / ||ref||) and the cosine
of dQ, dK and dV against float64 attention on the same bf16 inputs, for
- ``kernel``: ``flash_attention_bwd_cuda``, the tensor-core kernels (delta
  = rowsum(P * dP); P and dS in bf16 as ``WGMMA_BWD_SPLIT`` says);
- ``kernel_cuda_core``: the CUDA-core kernels (``impl="cuda_core"``, P and
  dS in fp32);
- ``one_<part>``: the plain version with every A operand as hi + lo
  except ``<part>`` (``p_dv``, ``ds_dk``, ``ds_dq``), which takes one bf16
  rounding, so each product's own rounding shows alone; ``split_all`` and
  ``one_all`` with every operand as hi + lo, or as one rounding;
- ``delta_from_o``: the same algorithm with FlashAttention-2's delta,
  rowsum(dO * O) from the forward kernel's bf16 O (the plain backward's
  formula with that one change, in fp32);
- ``naive``: autograd through ``layers.attn_naive`` in bf16, the plain
  path's attention;
and each kernel against its plain version.  The same at the untrained
weights first.  One H100 call of about two minutes with the build.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as train_lib

LAYERS_FROM_TOP = (0, 15, 31)       # in backward order: 0 is the last layer


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return F.cosine_similarity(a.double().flatten(), b.double().flatten(),
                               dim=0).item()


def _float64_grads(q, k, v, do):
    """dq, dk, dv of causal GQA attention in float64."""
    b, s, h, d = q.shape
    idx = torch.arange(h, device=q.device) // (h // k.shape[2])
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd[:, :, idx]) / math.sqrt(d)
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                   device=q.device).triu(1), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vd[:, :, idx])
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


def _delta_from_o_grads(q, k, v, o, do, lse):
    """The plain backward with delta = rowsum(dO * O) from the bf16 O."""
    b, s, h, d = q.shape
    idx = torch.arange(h, device=q.device) // (h // k.shape[2])
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = (t.float()[:, :, idx].transpose(1, 2) for t in (k, v))
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale - lse[..., None])
    p = p.masked_fill(torch.ones(s, s, dtype=torch.bool,
                                 device=q.device).triu(1), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ dof
    kh = k.shape[2]
    dk, dv = (t.reshape(b, kh, h // kh, s, d).sum(2) for t in (dk, dv))
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _capture(cfg, params, mb):
    """The attention backward's inputs of every layer, in backward order."""
    seen = []
    real = ops.flash_attention_bwd

    def spy(q, k, v, do, lse, *, causal=True):
        seen.append(tuple(t.detach().clone() for t in (q, k, v, do, lse)))
        return real(q, k, v, do, lse, causal=causal)
    ops.flash_attention_bwd = spy
    try:
        train_lib.loss_and_grads(cfg, params, {k: v[None] for k, v in
                                               mb.items()})
    finally:
        ops.flash_attention_bwd = real
    return seen


def _report(label, captured):
    for li in LAYERS_FROM_TOP:
        q, k, v, do, lse = captured[li]
        o, _ = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        ref = _float64_grads(q, k, v, do)
        runs = {"kernel": fa.flash_attention_bwd_cuda(q, k, v, do, lse),
                "kernel_cuda_core": fa.flash_attention_bwd_cuda(
                    q, k, v, do, lse, impl="cuda_core")}
        parts = tuple(fa.WGMMA_BWD_SPLIT)
        for name, one in ([(f"one_{p}", (p,)) for p in parts]
                          + [("split_all", ()), ("one_all", parts)]):
            runs[name] = fa.flash_attention_bwd_plain(
                q, k, v, do, lse, split={p: p not in one for p in parts})
        runs["delta_from_o"] = _delta_from_o_grads(q, k, v, o, do, lse)
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        pos = torch.arange(q.shape[1], device=q.device)
        runs["naive"] = torch.autograd.grad(
            L.attn_naive(qq, kk, vv, q_pos=pos, k_pos=pos, causal=True),
            (qq, kk, vv), do)
        row = dict(weights=label, layer_from_top=li, shape=list(q.shape),
                   split=fa.WGMMA_BWD_SPLIT)
        for name, grads in runs.items():
            row[name] = {g: dict(rel=_rel(x, r), cos=_cos(x, r))
                         for g, x, r in zip(("dq", "dk", "dv"), grads, ref)}
        for name, impl in (("kernel", None), ("kernel_cuda_core",
                                              "cuda_core")):
            plain = fa.flash_attention_bwd_plain(q, k, v, do, lse, impl=impl)
            row[f"{name}_vs_plain_rel"] = {
                g: _rel(x, y)
                for g, x, y in zip(("dq", "dk", "dv"), runs[name], plain)}
        print(json.dumps(row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_bwd_precision: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("smollm_360m"), remat="full")
    ds = data_lib.SyntheticDataset(cfg, data_lib.DataConfig(
        seq_len=1024, global_batch=8, num_microbatches=2))
    params = model_lib.init(cfg, 0, device="cuda")
    mb = {k: v[0][:1] for k, v in ds.batch(0).items()}
    _report("init", _capture(cfg, params, mb))
    state = opt_lib.init_state(params)
    step = train_lib.make_train_step(cfg, opt_lib.OptimizerConfig(
        lr=1e-3, warmup_steps=2))
    for i in range(12):
        params, state, _ = step(params, state, ds.batch(0 if i < 8 else i - 7))
    _report("trained_12_steps", _capture(cfg, params, mb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
