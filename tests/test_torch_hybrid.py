"""The port's Zamba2 hybrid (``repro_torch/models/hybrid.py``: mamba2
layers and one shared attention + FFN block) against the reference, on the
same seeded numpy weights (``test_torch_model``), and the refusals both
state-space families share (their mesh step: ``test_torch_mesh_ssm.py``).

The reduced config has ``attn_every`` 2: at its own 2 layers the shared
block runs once, at ``n_layers=4`` twice (two groups), so its gradient is
a sum over two applications.  Forward and decode values agree to fp32
1e-4 (the attention's and the FFN's fp32 sums in other orders: up to 7e-5
on logits of magnitude 2 here), gradients as in ``test_torch_mamba2``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.simulator import memory as jmem
from repro.models import hybrid as jhybrid
from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.serve import paged_cache as jpaged
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core.simulator import memory as tmem
from repro_torch.dist import pipeline as tpl
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.dist.sharding import iter_decls
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import hybrid as thybrid
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve import serve_step as tss
from repro_torch.serve.scheduler import ContinuousBatchingServer
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_mamba2 import (_close, _np, decl_table, grads_alike,
                               serve_alike, train_step_alike)
from test_torch_model import both_params, configs
from test_torch_train import _HostSyncGuard

ARCH = "zamba2_2_7b"
FAMILIES = ["mamba2_130m", ARCH]
CPU = torch.device("cpu")
FWD_TOL = 1e-4


@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(reduced):
    jcfg, tcfg = jget(ARCH), tget(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert thybrid.n_groups(tcfg) == jhybrid.n_groups(jcfg)
    assert decl_table(tm.decls(tcfg), False) == \
        decl_table(jm.decls(jcfg), True)
    for batch, max_len in ((1, 8), (3, 17)):
        assert decl_table(tm.cache_decls(tcfg, batch, max_len), False) == \
            decl_table(jm.cache_decls(jcfg, batch, max_len), True)


def test_param_count_matches_reference():
    """2.42 B parameters at full width, counted from the declarations."""
    n = sum(int(np.prod(d.shape))
            for _, d in iter_decls(tm.decls(tget(ARCH))))
    assert n == jm.param_count(jget(ARCH))
    assert 2.4e9 < n < 2.45e9


def test_n_groups_refuses_a_ragged_stack():
    with pytest.raises(ValueError, match="multiple of attn_every"):
        thybrid.n_groups(dataclasses.replace(tget(ARCH), n_layers=53))


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_shared_block_matches_reference(impl):
    """The shared attention + FFN over a full sequence (the reference's
    naive attention; the port's plain path or the kernel's plain
    version): x and the application's K/V."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 19, tcfg.d_model)).astype(np.float32)
    wx, (wk, wv) = jhybrid._shared_block(jcfg, jp, jnp.asarray(x),
                                         jnp.arange(19), "naive", None)
    gx, (gk, gv) = thybrid._shared_block(tcfg, tp, torch.from_numpy(x),
                                         torch.arange(19), impl)
    for got, want, what in ((gx, wx, "x"), (gk, wk, "k"), (gv, wv, "v")):
        _close(got, want, FWD_TOL, what)


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("attn,ssd", [("naive", "chunked"),
                                      ("kernel", "kernel")])
@pytest.mark.parametrize("s", [24, 13])
def test_forward_matches_reference(n_layers, attn, ssd, s):
    """Logits and the prefill cache (each application's K/V, the layers'
    SSM and conv states)."""
    jcfg, tcfg = configs(ARCH, n_layers=n_layers)
    jp, tp = both_params(jcfg, tcfg, seed=2)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, s))
    wl, wc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True, attn_impl="naive")
    gl, gc = thybrid.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             return_cache=True, attn_impl=attn, ssd_impl=ssd)
    _close(gl, wl, FWD_TOL, "logits")
    assert gc["k"].shape[0] == n_layers // 2 and gc["len"] == s
    for name in ("k", "v", "ssm", "conv"):
        _close(gc[name], wc[name], FWD_TOL, name)


@pytest.mark.parametrize("n_layers", [2, 4])
@pytest.mark.parametrize("device_len", [False, True])
def test_decode_matches_reference(n_layers, device_len):
    """An 11-token prefill, ``grow_cache`` into ``init_cache`` and 4 decode
    steps (``len`` a Python int, or a 0-d tensor read on the device)."""
    jcfg, tcfg = configs(ARCH, n_layers=n_layers)
    jp, tp = both_params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 11))
    _, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       return_cache=True)
    _, tc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, 24))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, 2, 24, device="cpu"))
    if device_len:
        tc["len"] = torch.tensor(tc["len"])
    for _ in range(4):
        nxt = rng.integers(0, tcfg.vocab_size, (2, 1))
        wl, jc = jm.decode(jcfg, jp, jc, jnp.asarray(nxt))
        gl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        _close(gl, wl, FWD_TOL, "logits")
    assert int(tc["len"]) == int(jc["len"]) == 15
    for name in ("k", "v", "ssm", "conv"):
        _close(tc[name], jc[name], FWD_TOL, name)


def test_decode_past_the_cache_raises():
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    cache = tm.init_cache(tcfg, 1, 4, start_len=4, device="cpu")
    with pytest.raises(IndexError, match="past the cache's 4 slots"):
        tm.decode(tcfg, tp, cache, torch.zeros(1, 1, dtype=torch.int64))


@pytest.mark.parametrize("n_layers", [2, 4])
def test_batched_server_matches_reference(n_layers):
    srv = serve_alike(ARCH, n_layers=n_layers)
    assert set(srv.state) == {"k", "v", "ssm", "conv", "len", "cur"}
    assert srv.state["ssm"].dtype == torch.float32
    assert srv.state["k"].shape[0] == n_layers // 2


def test_batched_server_refuses_past_max_len():
    """The hybrid's cache has KV slots, so the server's ``max_len`` check
    holds (mamba2's state has none, as in the reference)."""
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    srv = tss.BatchedServer(tcfg, tp, max_len=8, batch_size=2)
    req = tss.Request(rid=0, prompt=np.zeros(6, np.int32), max_new_tokens=5)
    with pytest.raises(ValueError, match="past the cache's 8 slots"):
        srv.run([req])
    _, mcfg = configs("mamba2_130m")
    srv = tss.BatchedServer(mcfg, tm.init(mcfg, 0, device="cpu"),
                            max_len=8, batch_size=2)
    req = tss.Request(rid=0, prompt=np.zeros(6, np.int32), max_new_tokens=5)
    srv.run([req])
    assert len(req.output) == 5


@pytest.mark.parametrize("arch", FAMILIES)
def test_served_bodies_make_no_host_sync(arch):
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    state = tss.decode_state(tcfg, 2, 16, per_row=False, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 9))
    with _HostSyncGuard():
        tss.prefill_on_device(tcfg, tp, state, toks, 2)
        tss.decode_on_device(tcfg, tp, tss.rows_of(state, 2))
    assert int(state["len"]) == 10


@pytest.mark.parametrize("batch,ctx,page", [(1, 16, 16), (8, 549, 16),
                                            (2, 8192, 64)])
def test_kv_cache_bytes_equal(batch, ctx, page):
    """The reference's price, but the SSM state in fp32 where it prices it
    in ``cfg.dtype`` (bf16): the port's served decode state holds it in
    fp32 (P6, repaired)."""
    cfg = tget(ARCH)
    h = cfg.n_layers * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 2
    assert tmem.kv_cache_bytes(cfg, batch, ctx, page) == \
        jmem.kv_cache_bytes(jget(ARCH), batch, ctx, page) + batch * h
    assert tpaged.page_bytes(cfg, page) == \
        jpaged.page_bytes(jget(ARCH), page) + h


# --- training ----------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,remat,attn", [(2, "none", "naive"),
                                                 (4, "full", "naive"),
                                                 (4, "dots", "kernel")])
def test_loss_and_grads_match_reference(n_layers, remat, attn):
    """At 4 layers the shared block's gradient is the sum over its two
    applications, as ``jax.grad`` gives it."""
    grads = grads_alike(ARCH, remat, seed=4, n_layers=n_layers,
                        attn_impl=attn)
    assert any(k.startswith("shared_attn/") for k in grads)


def test_shared_gradient_sums_its_applications():
    """Two applications of the shared block: its gradient is the sum of
    what each application contributes (each taken with the other's
    weights held fixed by a detached copy)."""
    _, tcfg = configs(ARCH, n_layers=4)
    tp = tm.init(tcfg, 0, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(5))
    shared = tp["shared_attn"]

    def loss_with(first, second):
        calls = []
        real = thybrid._shared_block

        def block(cfg, params, x, positions, impl):
            p = first if not calls else second
            calls.append(1)
            return real(cfg, {"shared_attn": p}, x, positions, impl)
        thybrid._shared_block = block
        try:
            return thybrid.forward(tcfg, tp, {"tokens": toks}).sum()
        finally:
            thybrid._shared_block = real

    leaf = {k: v.clone().requires_grad_() for k, v in shared.items()}
    fixed = {k: v.detach() for k, v in shared.items()}
    both = torch.autograd.grad(loss_with(leaf, leaf), list(leaf.values()))
    one = torch.autograd.grad(loss_with(leaf, fixed), list(leaf.values()))
    two = torch.autograd.grad(loss_with(fixed, leaf), list(leaf.values()))
    for g, a, b in zip(both, one, two):
        torch.testing.assert_close(g, a + b, rtol=1e-5, atol=1e-6)
        assert a.abs().max() > 0 and b.abs().max() > 0


def test_train_step_matches_reference():
    train_step_alike(ARCH, seed=6, n_layers=4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_device_body_makes_no_host_sync(arch):
    _, tcfg = configs(arch, remat="full", attn_impl="kernel")
    tp = tm.init(tcfg, 0, device="cpu")
    state = topt.init_state(tp)
    batch = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
        seq_len=16, global_batch=4, num_microbatches=2)).batch(0)
    db, w = tts.device_inputs(tcfg, tp, batch, None)
    with _HostSyncGuard():
        _, _, metrics = tts.train_step_on_device(
            tcfg, topt.OptimizerConfig(), tp, state, db, w)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1


def test_bridge_carries_params_and_opt_state():
    from repro.train import optimizer as jopt
    from repro.train.checkpoint import _flatten
    jcfg, tcfg = configs(ARCH, n_layers=4)
    jp, tp = both_params(jcfg, tcfg, seed=7)
    flat = _flatten(jp)
    back = bridge.params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    js = jopt.init_state(jp)
    ts = bridge.opt_state_from_numpy(tcfg, _flatten(js), device="cpu")
    assert sorted(bridge.opt_state_to_numpy(ts)) == sorted(_flatten(js))


# --- the launchers and the refusals (both families) --------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_runs_on_cpu(arch, capsys):
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--requests", "3", "--prompt-len", "8", "--max-new", "4",
                  "--batch-size", "2"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_runs_on_cpu(arch, capsys, tmp_path):
    """``launch.train`` trains on a one-position mesh (the sharded step,
    bit for bit the one-device step there)."""
    tlaunch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", "2", "--workdir", str(tmp_path)])
    assert "[train] 2 steps" in capsys.readouterr().out


def _mesh_batch(cfg, seed, n_micro=2, mbs=4, seq=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n_micro, mbs, seq))
    return {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_position_mesh_matches_the_single_device_step(arch):
    """The mesh step on a (1, 1) mesh: loss and gradients as the
    single-device step's, bit for bit (the same model on the same
    tensors)."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    batch = _mesh_batch(tcfg, 8)
    mesh = data_model_mesh(1, 1, [CPU])
    sp = pm.shard_tree(tp, param_specs(tm.decls(tcfg), tcfg.sharding, mesh),
                       mesh)
    loss, grads = tts.loss_and_grads(tcfg, sp, batch, mesh=mesh)
    wl, wg = tts.loss_and_grads(tcfg, tp, batch)
    assert torch.equal(loss, wl)
    flat = dict(topt.tree_leaves(wg))
    for path, g in pm.tree_items(grads):
        assert torch.equal(g.blocks[0], flat[path]), path


@pytest.mark.parametrize("arch", FAMILIES)
def test_unported_paths_refuse_both_families(arch):
    """The continuous server and the MPMD pipeline (the reference asserts
    dense or moe in both) raise.  A mesh of more than one position runs
    both families (``tests/test_torch_mesh_ssm.py``), and the
    encoder-decoder and vision-language families too, which raised there
    until their sharded layers were ported
    (``tests/test_torch_mesh_families.py``): the sharded step is built for
    each."""
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousBatchingServer(tcfg, tp)
    with pytest.raises(NotImplementedError, match="dense and moe"):
        tpl.MPMDPipeline(tcfg, [], topt.OptimizerConfig())
    mesh = data_model_mesh(2, 1, [CPU] * 2)
    for cfg in (tcfg, tget("whisper_tiny").reduced(),
                tget("internvl2_26b").reduced()):
        assert callable(tts.make_train_step(cfg, topt.OptimizerConfig(),
                                            mesh=mesh))
