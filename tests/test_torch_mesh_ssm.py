"""The state-space families on a mesh (``dist/spmd_ssm.py``): the sharded
train step of the reduced mamba2-130m and zamba2-2.7b against the port's
single-device step on the same seeded weights, on meshes of CPU
positions, fp32.

The reference's own mesh step cannot run here (fault R1), so, as for the
dense and MoE families, the sharded step is held against
``make_train_step``, which ``tests/test_torch_mamba2.py`` and
``tests/test_torch_hybrid.py`` hold against the reference.  Tolerances are
``test_torch_mesh.py``'s: loss rtol 1e-5, every gradient leaf 1e-5 of its
max |g|, params after one step rtol 2e-3 / atol 2e-4, every replica equal
bit for bit after 3 steps; but a param whose one-device gradient is near
zero (at most 1e-4 of its leaf's max) is held to 2 lr after the first
AdamW step, which moves it by lr g / (|g| + eps): the reduced zamba2's
embedding holds an element whose gradient is 4.6e-7 on one device and
4.6e-8 on (2, 2) ``tp`` (of a max 2.42), which the two steps move by
different fractions of lr.

The reduced configs (d_model 64, d_inner 128, state 16, 8 SSD heads of
16; ``w_in`` 296 columns, the conv 160 channels) shard every Mamba-2 leaf
over a 'model' axis of 2 or 4; on 3 every one of them is replicated, and
at d_model 48 with heads of 32 (3 heads, ``w_in`` 227 columns) the conv,
``gate_ln`` and ``w_out`` shard over 2 while ``w_in`` and the heads do
not: those layouts run the mixer whole on every position.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.sharding import P
from repro_torch.models import mamba2
from repro_torch.models import model as tm
from repro_torch.train import train_step as tts
from test_torch_mesh import (GRAD_TOL, LOSS_RTOL, _assert_replicas_equal,
                             _batch, _both, _check_grads, _mesh,
                             step_matches_single_device)

SSM, HYBRID = "mamba2_130m", "zamba2_2_7b"


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, policy, **kw):
    return dataclasses.replace(get_config(arch).reduced(), sharding=policy,
                               **kw)


# (arch, mesh, policy, micro_weights, micro_batch): micro_batch 3 divides
# no dp axis (the batch replicated, its loss counted once)
STEP_CASES = [(SSM, (2, 2), "tp", None, 4),
              (SSM, (1, 4), "tp", (2 / 3, 1 / 3), 4),
              (SSM, (2, 1), "fsdp_tp", None, 3),
              (SSM, (2, 2), "fsdp_tp", None, 4),
              (HYBRID, (2, 2), "tp", None, 4),
              (HYBRID, (1, 4), "tp", None, 3),
              (HYBRID, (2, 1), "fsdp_tp", (2 / 3, 1 / 3), 4),
              (HYBRID, (2, 2, 1), "fsdp_tp", None, 4)]


@pytest.mark.parametrize("arch,shape,policy,weights,micro_batch",
                         STEP_CASES)
def test_sharded_step_matches_single_device(arch, shape, policy, weights,
                                            micro_batch):
    step_matches_single_device(_cfg(arch, policy), shape, weights,
                               micro_batch, adam_bound=2e-3)


def _loss_and_grads(cfg, shape, seed=7):
    mesh = _mesh(shape)
    single, sharded = _both(cfg, mesh, seed=seed)
    batch = _batch(cfg, seed + 1, 2, 2)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_RTOL)
    _check_grads(gg, wg)
    _assert_replicas_equal(gg, "grad")
    return sharded


def _specs(sharded):
    return {k: x.spec[1:] for k, x in sharded["layers"].items()}


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_tp3_replicates_every_mamba_leaf(arch):
    """tp 3 divides none of the reduced Mamba-2 widths (296, 160, 128, 8
    heads): every leaf is replicated and the mixer runs whole."""
    cfg = _cfg(arch, "tp")
    sharded = _loss_and_grads(cfg, (1, 3))
    assert all(spec == P(*[None] * len(spec))
               for spec in _specs(sharded).values()), _specs(sharded)
    lay = spmd.layout(cfg, sharded, _mesh((1, 3)), 2, 12)
    assert not lay.ssm_heads


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_conv_and_gate_shard_where_w_in_and_heads_do_not(arch):
    """d_model 48, heads of 32: di 96 and the conv's 128 channels shard over
    2, ``w_in``'s 227 columns and the 3 heads do not; the mixer runs whole
    from the gathered conv, ``gate_ln`` and ``w_out``."""
    cfg = _cfg(arch, "tp", d_model=48, ssm_headdim=32)
    assert (cfg.d_inner, cfg.ssm_nheads) == (96, 3)
    sharded = _loss_and_grads(cfg, (1, 2))
    specs = _specs(sharded)
    assert specs["w_in"] == P(None, None)
    assert specs["conv_w"] == P(None, "model")
    assert specs["gate_ln"] == P("model")
    assert specs["w_out"] == P("model", None)
    assert not spmd.layout(cfg, sharded, _mesh((1, 2)), 2, 12).ssm_heads


def test_layout_of_the_state_space_families():
    """``ssm_heads`` where 'model' divides the heads and ``gate_ln`` is
    split; the attention and FFN fields from the hybrid's unstacked shared
    block, all False for mamba2."""
    mesh = _mesh((2, 2))
    for arch in (SSM, HYBRID):
        cfg = _cfg(arch, "tp")
        _, sharded = _both(cfg, mesh, seed=0)
        lay = spmd.layout(cfg, sharded, mesh, 4, 12)
        assert lay.ssm_heads and lay.tp == 2 and lay.batch == ("data",)
        hybrid = arch == HYBRID
        # the reduced hybrid: 4 query heads, 2 K/V heads, d_ff 128
        assert (lay.heads, lay.kv, lay.ff, lay.experts) == \
            (hybrid, hybrid, hybrid, False)
        assert lay.vocab_embed and lay.vocab_logits
    one = _mesh((1, 1))
    cfg = _cfg(SSM, "tp")
    lay = spmd.layout(cfg, _both(cfg, one, seed=0)[1], one, 4, 12)
    # a 'model' axis of one position: the one-device lookup and loss
    assert lay.ssm_heads and not (lay.vocab_embed or lay.vocab_logits)


def _global_logits(mesh, lay, blocks, shape):
    spec = P(lay.batch or None, None, "model" if lay.vocab_logits else None)
    return pm.unshard(pm.Sharded(shape, spec, mesh, blocks), "cpu")


@pytest.mark.parametrize("route", ["chunked", "kernel"])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_forward_without_a_gradient(arch, route, monkeypatch):
    """The sharded forward under ``torch.no_grad`` on (2, 2) ``tp``: logits
    within 1e-5 of the one-device forward.  On the CPU the route is the
    chunked SSD; with ``pick_ssd_impl`` made to pick the kernel, each
    position calls ``ops.ssd_scan`` (its plain version here) on its 4
    heads, within the SSD's fp32 1e-4 of the chunked route."""
    cfg = _cfg(arch, "tp")
    mesh = _mesh((2, 2))
    single, sharded = _both(cfg, mesh, seed=3)
    toks = torch.from_numpy(_batch(cfg, 4, 1, 4)["tokens"][0]).long()
    with torch.no_grad():
        want = tm.forward(cfg, single, {"tokens": toks})
    picked = []
    pick = mamba2.pick_ssd_impl

    def spy(*a, **kw):
        picked.append(pick(*a, **kw) if route == "chunked" else route)
        return picked[-1]

    monkeypatch.setattr(mamba2, "pick_ssd_impl", spy)
    with torch.no_grad():
        blocks, lay = spmd.forward(cfg, sharded, {"tokens": toks}, mesh)
    assert picked == [route]
    got = _global_logits(mesh, lay, blocks, tuple(want.shape))
    tol = 1e-5 if route == "chunked" else 1e-4
    assert (got - want).abs().max().item() <= tol


def test_shared_block_gradient_sums_applications_and_replicas():
    """The reduced hybrid at 4 layers (two applications of its one shared
    block) on (2, 2) ``tp``, whose 'data' positions hold other sequences:
    each replica of a shared block's block gets its own sequences' part of
    the gradient (summed by autograd over both applications), far from the
    whole; summed over the replicas (``replica_group_sum``, as the step
    does) they equal the one-device gradient."""
    cfg = _cfg(HYBRID, "tp", n_layers=4)
    mesh = _mesh((2, 2))
    single, sharded = _both(cfg, mesh, seed=9)
    mb = {k: torch.from_numpy(v[0]) for k, v in _batch(cfg, 10, 1, 4).items()}
    _, wg = tts.loss_and_grads(cfg, single, {k: v[None] for k, v in
                                             mb.items()})
    shared = {k: x.with_blocks([b.detach().requires_grad_()
                                for b in x.blocks])
              for k, x in sharded["shared_attn"].items()}
    loss, _ = tm.loss_fn(cfg, {**sharded, "shared_attn": shared}, mb,
                         mesh=mesh)
    names = sorted(shared)
    grads = torch.autograd.grad(
        loss, [b for k in names for b in shared[k].blocks])
    for i, k in enumerate(names):
        x = shared[k]
        own = x.with_blocks(grads[i * mesh.size:(i + 1) * mesh.size])
        want = wg["shared_attn"][k]
        part = pm.unshard(own, "cpu")       # the replicas at data 0
        assert (part - want).abs().max() > 1e-2 * want.abs().max(), k
        total = pm.unshard(pm.replica_group_sum(own), "cpu")
        err = (total - want).abs().max().item()
        assert err <= GRAD_TOL * want.abs().max().item(), (k, err)
