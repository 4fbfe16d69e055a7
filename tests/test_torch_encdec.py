"""The port's encoder-decoder (``repro_torch/models/encdec.py``,
whisper-tiny) against the reference, on the same seeded numpy weights
(``test_torch_model``) and the same seeded frames.

The helpers here take an arch, and ``test_torch_vlm`` runs them on
internvl2's vision-language branch: the two families share the stubbed
frontend (``frames`` or ``patches`` in the batch, zeros in the servers and
the block profiler).

Tolerances are the dense tests': fp32 forward and caches atol 2e-5,
gradients 1e-4 of each leaf's max |g|, the loss rtol 1e-5.  Whisper runs
no kernel (its attention picks naive or chunked by length, in both
packages), so the port's plain path is held to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.simulator import memory as jmem
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.serve import paged_cache as jpaged
from repro.train.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core.profiler import measured as tmeasured
from repro_torch.core.simulator import memory as tmem
from repro_torch.dist import pipeline as tpl
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.dist.sharding import param_specs
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as TL
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve import serve_step as tss
from repro_torch.serve.scheduler import ContinuousBatchingServer
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_mamba2 import (_close, decl_table, serve_alike,
                               train_step_alike)
from test_torch_model import F32_ATOL, both_params, configs
from test_torch_train import _HostSyncGuard

ARCH = "whisper_tiny"
CPU = torch.device("cpu")
GRAD_TOL = 1e-4


# --- shared by both stubbed-frontend families --------------------------------------

def stub_batch(cfg, seed, b=2, s=11, labels=False):
    """Seeded numpy tokens (B, S) and the family's stub input, ``frames``
    or ``patches`` (fp32, std 1); ``labels`` (the first 3 text positions
    and, for vlm, every patch position ``IGNORE_LABEL``)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    name, n = (("frames", cfg.n_frames) if cfg.family == "encdec"
               else ("patches", cfg.n_patches))
    out[name] = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        lab[:, :3] = jm.IGNORE_LABEL
        if cfg.family == "vlm":
            lab = np.concatenate([np.full((b, n), jm.IGNORE_LABEL, np.int32),
                                  lab], axis=1)
        out["labels"] = lab
    return out


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tx(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def cache_names(cfg):
    return ("k", "v", "ck", "cv") if cfg.family == "encdec" else ("k", "v")


def decls_alike(arch, reduced):
    """Declarations and cache declarations equal the reference's (paths,
    shapes, init, ``scale_dim``, axes), and count the reference's
    ``param_count``.  ``total_params()`` leaves out one tensor of each
    family (whisper's ``ln_enc``, D; internvl2's ``vision_proj``, D x D):
    within the reference's own 2% (``tests/test_models.py``)."""
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    got = decl_table(tm.decls(tcfg), False)
    assert got == decl_table(jm.decls(jcfg), True)
    for batch, max_len in ((1, 8), (3, 17)):
        assert decl_table(tm.cache_decls(tcfg, batch, max_len), False) == \
            decl_table(jm.cache_decls(jcfg, batch, max_len), True)
    n = sum(int(np.prod(shape)) for shape, *_ in got.values())
    assert n == jm.param_count(jcfg)
    left_out = tcfg.d_model if tcfg.family == "encdec" else tcfg.d_model ** 2
    assert n == tcfg.total_params() + left_out
    assert abs(n - tcfg.total_params()) < 0.02 * n or reduced
    return n


def forward_alike(arch, s, seed, attn_impl=None):
    """Logits and the prefill cache (every leaf and ``len``)."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    b = stub_batch(tcfg, seed, s=s)
    wl, wc = jm.forward(jcfg, jp, jx(b), return_cache=True)
    gl, gc = tm.forward(tcfg, tp, tx(b), return_cache=True,
                        attn_impl=attn_impl)
    assert gl.dtype == torch.float32
    _close(gl, wl, F32_ATOL, "logits")
    assert set(gc) == set(wc) and gc["len"] == int(wc["len"])
    for name in cache_names(tcfg):
        _close(gc[name], wc[name], F32_ATOL, name)
    return gc


def decode_alike(arch, device_len, seed):
    """An 11-token prefill, ``grow_cache`` into ``init_cache`` and 3
    decode steps (``len`` a Python int, or a 0-d tensor)."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    b = stub_batch(tcfg, seed)
    _, jc = jm.forward(jcfg, jp, jx(b), return_cache=True)
    _, tc = tm.forward(tcfg, tp, tx(b), return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, 32))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, 2, 32, device="cpu"))
    start = tc["len"]
    if device_len:
        tc["len"] = torch.tensor(tc["len"])
    rng = np.random.default_rng(seed)
    jdecode = jax.jit(lambda p, c, t: jm.decode(jcfg, p, c, t))
    for _ in range(3):
        nxt = rng.integers(0, tcfg.vocab_size, (2, 1))
        wl, jc = jdecode(jp, jc, jnp.asarray(nxt))
        gl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        _close(gl, wl, F32_ATOL, "logits")
    assert int(tc["len"]) == int(jc["len"]) == start + 3
    assert isinstance(tc["len"], torch.Tensor) == device_len
    for name in cache_names(tcfg):
        _close(tc[name], jc[name], F32_ATOL, name)


def grads_alike(arch, remat, seed, **over):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's (fp32)."""
    jcfg, tcfg = configs(arch, remat=remat, **over)
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    b = stub_batch(tcfg, seed, s=13, labels=True)
    (wl, _), wg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jx(b)), has_aux=True))(jp)
    leaves = topt.tree_leaves(tp)
    for _, p in leaves:
        p.requires_grad_()
    loss, _ = tm.loss_fn(tcfg, tp, tx(b))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    want = _flatten(wg)
    assert set(want) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads):
        w = np.asarray(want[k], np.float32)
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)


def block_batch_alike(arch):
    """``measure_block``'s batch on the one-layer model: zero tokens and
    labels and the family's zero stub input, as the reference's, and the
    port's ``measure_block`` runs on it.  On all-zero tokens the attention
    weights' gradients are rounding noise, so the two programs are held
    against the reference's forward and ``jax.grad`` on seeded tokens and
    labels beside the zero stub input (fp32, logits 1e-5, gradients 1e-4
    of max |g|), as ``test_torch_calibration`` holds the dense ones."""
    jcfg, tcfg = configs(arch, n_layers=1, remat="none")
    jp, tp = both_params(jcfg, tcfg, seed=15)
    tb = tmeasured.block_batch(tcfg, 2, 12, "cpu")
    name, n = (("frames", tcfg.n_frames) if tcfg.family == "encdec"
               else ("patches", tcfg.n_patches))
    assert tb[name].shape == (2, n, tcfg.d_model)
    assert tb[name].dtype == torch.float32 and not tb[name].any()
    assert not tb["tokens"].any() and tb["tokens"].shape == (2, 12)
    rows = tmeasured.measure_block(tcfg, 12, (1,), device="cpu")
    assert rows[0][0] == 1 and rows[0][1] > 0 and rows[0][2] > 0
    seeded = stub_batch(tcfg, 15, s=12, labels=True)
    tb.update({k: torch.from_numpy(seeded[k]) for k in ("tokens", "labels")})
    fwd, grad = tmeasured.block_programs(tcfg, tp, tb)
    batch = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    _close(fwd(), jm.forward(jcfg, jp, batch), 1e-5, "block forward")
    wg = _flatten(jax.jit(jax.grad(
        lambda p: jm.loss_fn(jcfg, p, batch)[0]))(jp))
    for (k, _), g in zip(topt.tree_leaves(tp), grad()):
        w = np.asarray(wg[k], np.float32)
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), k
    return tb


def kv_bytes_alike(arch):
    """``kv_cache_bytes`` and the paged cache's page bytes ``==`` the
    reference's at three contexts."""
    for batch, ctx, page in ((1, 16, 16), (8, 549, 16), (2, 8192, 64)):
        assert tmem.kv_cache_bytes(tget(arch), batch, ctx, page) == \
            jmem.kv_cache_bytes(jget(arch), batch, ctx, page)
    assert tpaged.page_bytes(tget(arch), 16) == \
        jpaged.page_bytes(jget(arch), 16)


def served_bodies_alike(arch):
    """The served prefill and decode bodies make no host sync, and the
    prefill's stub input is zeros: its logits are the forward's on zero
    frames or patches."""
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    state = tss.decode_state(tcfg, 2, 40, per_row=False, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(16))
    with _HostSyncGuard():
        first = tss.prefill_on_device(tcfg, tp, state, toks, 2)
        tss.decode_on_device(tcfg, tp, tss.rows_of(state, 2))
    want = tm.forward(tcfg, tp, {"tokens": toks,
                                 **tm.stub_inputs(tcfg, 2, "cpu")})[:, -1]
    assert torch.equal(first, want)
    extra = tcfg.n_patches if tcfg.family == "vlm" else 0
    assert int(state["len"]) == extra + 10
    return state


def launch_serve_alike(arch, capsys):
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                  "--requests", "3", "--prompt-len", "8", "--max-new", "4",
                  "--batch-size", "2"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def launch_train_alike(arch, capsys, tmp_path):
    """``launch.train`` trains on a one-position mesh, where the family
    runs the one-device model on the batch's frames or patches."""
    tlaunch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", "2", "--seq-len", "24",
                        "--workdir", str(tmp_path)])
    assert "[train] 2 steps" in capsys.readouterr().out


def one_position_alike(arch):
    """The mesh step on a (1, 1) mesh: loss and gradients as the
    single-device step's, bit for bit."""
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    batch = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
        seq_len=20, global_batch=4, num_microbatches=2)).batch(0)
    mesh = data_model_mesh(1, 1, [CPU])
    sp = pm.shard_tree(tp, param_specs(tm.decls(tcfg), tcfg.sharding, mesh),
                       mesh)
    loss, grads = tts.loss_and_grads(tcfg, sp, batch, mesh=mesh)
    wl, wg = tts.loss_and_grads(tcfg, tp, batch)
    assert torch.equal(loss, wl)
    flat = dict(topt.tree_leaves(wg))
    for path, g in pm.tree_items(grads):
        assert torch.equal(g.blocks[0], flat[path]), path


def refusals_alike(arch):
    """The continuous server (the reference asserts dense or moe) and the
    MPMD pipeline (likewise) raise; a mesh of 2 positions, which raised
    until the family's sharded layers were ported, trains (its loss the
    one-device step's; ``tests/test_torch_mesh_families.py`` holds the
    rest)."""
    _, tcfg = configs(arch)
    tp = tm.init(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="continuous batching"):
        ContinuousBatchingServer(tcfg, tp)
    with pytest.raises(NotImplementedError, match="dense and moe"):
        tpl.MPMDPipeline(tcfg, [], topt.OptimizerConfig())
    mesh = data_model_mesh(2, 1, [CPU] * 2)
    sp = pm.shard_tree(tp, param_specs(tm.decls(tcfg), tcfg.sharding, mesh),
                       mesh)
    batch = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
        seq_len=20, global_batch=4, num_microbatches=1)).batch(0)
    loss, _ = tts.loss_and_grads(tcfg, sp, batch, mesh=mesh)
    want, _ = tts.loss_and_grads(tcfg, tp, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


def bridge_alike(arch):
    """The family's nested trees cross ``bridge`` unchanged, both ways."""
    from repro.train import optimizer as jopt
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=17)
    flat = _flatten(jp)
    back = bridge.params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    js = jopt.init_state(jp)
    ts = bridge.opt_state_from_numpy(tcfg, _flatten(js), device="cpu")
    assert sorted(bridge.opt_state_to_numpy(ts)) == sorted(_flatten(js))
    return back


# --- whisper-tiny --------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(reduced):
    n = decls_alike(ARCH, reduced)
    if not reduced:
        assert 37.1e6 < n < 37.3e6


@pytest.mark.parametrize("s", [11, 24])
def test_forward_matches_reference(s):
    gc = forward_alike(ARCH, s, seed=1)
    _, tcfg = configs(ARCH)
    assert gc["ck"].shape == (tcfg.n_layers, 2, tcfg.n_frames,
                              tcfg.n_kv_heads, tcfg.hd)


def test_forward_ignores_attn_impl():
    """``attn_impl`` is accepted and ignored, as in the reference: the
    kernel route gives the plain path's logits, bit for bit."""
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    b = tx(stub_batch(tcfg, 2))
    assert torch.equal(tm.forward(tcfg, tp, b, attn_impl="kernel"),
                       tm.forward(tcfg, tp, b))


@pytest.mark.parametrize("device_len", [False, True])
def test_decode_matches_reference(device_len):
    decode_alike(ARCH, device_len, seed=3)


def test_decode_refuses_per_row_lengths_and_overruns():
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    cache = tm.init_cache(tcfg, 2, 4, device="cpu")
    tok = torch.zeros(2, 1, dtype=torch.int64)
    cache["len"] = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="scalar len"):
        tm.decode(tcfg, tp, cache, tok)
    cache["len"] = 4
    with pytest.raises(IndexError, match="past the cache's 4 slots"):
        tm.decode(tcfg, tp, cache, tok)


def test_r4_cross_attention_past_2048_masks_its_pad():
    """Fault R4 reaches whisper's cross-attention: 2049 decoder queries
    take ``attn_chunked`` over 1500 frames, not a multiple of its 1024
    block.  The reference's result differs from its naive attention by
    about 0.038; the port masks its pad and equals naive attention."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=4)
    jl = {k: v[0] for k, v in jp["decoder"].items()}
    tl = {k: v[0] for k, v in tp["decoder"].items()}
    rng = np.random.default_rng(4)
    xq = rng.standard_normal((1, 2049, tcfg.d_model)).astype(np.float32)
    xkv = rng.standard_normal((1, 1500, tcfg.d_model)).astype(np.float32)
    qp, kp = np.arange(2049), np.arange(1500)
    got, (ck, cv) = tencdec._mha(
        tcfg, tl, torch.from_numpy(xq), torch.from_numpy(xkv), causal=False,
        positions_q=torch.from_numpy(qp), positions_k=torch.from_numpy(kp),
        prefix="c_", rope_on=False)
    cq = tencdec.T._proj_in(torch.from_numpy(xq), tl["c_wq"])
    o = TL.attn_naive(cq, ck, cv, q_pos=torch.from_numpy(qp),
                      k_pos=torch.from_numpy(kp), causal=False)
    naive = tencdec.T._proj_out(o, tl["c_wo"])
    assert (got - naive).abs().max().item() <= 1e-5
    want, (jk, jv) = jencdec._mha(
        jcfg, jl, jnp.asarray(xq), jnp.asarray(xkv), causal=False,
        positions_q=jnp.asarray(qp), positions_k=jnp.asarray(kp),
        prefix="c_", rope_on=False)
    jq = jnp.einsum("bsd,dhk->bshk", jnp.asarray(xq), jl["c_wq"])
    jo = JL.attn_naive(jq, jk, jv, q_pos=jnp.asarray(qp),
                       k_pos=jnp.asarray(kp), causal=False)
    jnaive = jnp.einsum("bshk,hkd->bsd", jo, jl["c_wo"])
    _close(naive, jnaive, F32_ATOL, "naive")
    off = float(jnp.abs(want - jnaive).max())
    assert off > 1e-2, off


def test_batched_server_matches_reference():
    srv = serve_alike(ARCH)
    assert set(srv.state) == {"k", "v", "ck", "cv", "len", "cur"}


def test_served_bodies_make_no_host_sync():
    state = served_bodies_alike(ARCH)
    assert state["ck"].abs().max() > 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(remat):
    grads_alike(ARCH, remat, seed=5)


def test_remat_checkpoints_whole_bodies():
    """Any ``remat`` but ``none`` checkpoints each encoder and decoder
    layer's whole body (``dots`` too, as the reference's plain
    ``jax.checkpoint``): every mode gives the same loss and gradients."""
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    b = tx(stub_batch(tcfg, 6, s=13, labels=True))
    out = []
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = [p.detach().requires_grad_()
                  for _, p in topt.tree_leaves(tp)]
        tree = topt.tree_unflatten(zip([k for k, _ in topt.tree_leaves(tp)],
                                       leaves))
        loss, _ = tm.loss_fn(cfg, tree, b)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, w in zip(grads, out[0][1]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_train_step_matches_reference():
    train_step_alike(ARCH, seed=7)


def test_measure_block_batch_carries_frames():
    block_batch_alike(ARCH)


def test_kv_cache_bytes_equal():
    kv_bytes_alike(ARCH)


def test_bridge_carries_params_and_opt_state():
    back = bridge_alike(ARCH)
    assert "encoder/wq" in back and "decoder/c_wo" in back


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve_alike(ARCH, capsys)


def test_launch_train_runs_on_cpu(capsys, tmp_path):
    launch_train_alike(ARCH, capsys, tmp_path)


def test_one_position_mesh_matches_the_single_device_step():
    one_position_alike(ARCH)


def test_unported_paths_refuse():
    refusals_alike(ARCH)
