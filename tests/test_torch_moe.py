"""The port's MoE family (``repro_torch/models/moe.py`` and its uses) and
sliding-window prefill (``layers.attn_window_linear``) against the
reference, on the same seeded numpy weights (``test_torch_model``).

Reduced configs are fp32, so the routing must select the same experts on
both sides (checked exactly); values then agree to the forward tolerance
of ``test_torch_model`` (fp32 2e-5 absolute) and gradients to
``test_torch_train``'s (1e-4 of max |g|).  The combine sums a token's k
expert outputs over the k dim in one fixed order where the reference
scatter-adds them, so the two differ by fp32 rounding only.

Mesh layouts and the pipeline are held against the port's one-device
step (itself held against the reference here), because the reference's
sharded step and pipeline do not run on this jax (ROADMAP §3, R1/R2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.simulator import memory as jmem
from repro.models import layers as JL
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.serve import kv_cache as jkv
from repro.serve import paged_cache as jpaged
from repro.serve.serve_step import BatchedServer as JServer
from repro.serve.serve_step import Request as JRequest
from repro.configs import get_config as jget
from repro.train.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core.simulator import memory as tmem
from repro_torch.dist import pipeline as tpl
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as tlaunch_train
from repro_torch.models import layers as TL
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve.serve_step import BatchedServer as TServer
from repro_torch.serve.serve_step import Request as TRequest
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_model import F32_ATOL, both_params, configs, numpy_params
from test_torch_train import _HostSyncGuard

ARCHS = ["mixtral_8x22b", "dbrx_132b"]
GRAD_TOL = 1e-4
CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layer(params, i=0):
    """Layer ``i``'s MoE weights of a full params tree (either package)."""
    return {k: params["layers"][k][i]
            for k in ("router", "we_gate", "we_up", "we_down")}


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


# --- the FFN ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 7, 24, 96, 1000])
@pytest.mark.parametrize("cf", [0.5, 1.25, 16.0])
def test_capacity_matches_reference(arch, n, cf):
    jcfg, tcfg = configs(arch, capacity_factor=cf)
    assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg)
    full = dataclasses.replace(tget(arch), capacity_factor=cf)
    assert tmoe.capacity(n, full) == jmoe.capacity(
        n, dataclasses.replace(jget(arch), capacity_factor=cf))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["global", "per_seq"])
@pytest.mark.parametrize("cf", [0.5, 16.0])
def test_moe_ffn_matches_reference(arch, dispatch, cf):
    """cf 0.5 drops tokens (capacity below the mean load), 16 drops none."""
    jcfg, tcfg = configs(arch, capacity_factor=cf, moe_dispatch=dispatch)
    jp, tp = both_params(jcfg, tcfg, seed=2)
    x = _x(tcfg, (3, 20), seed=2)
    want = jmoe.moe_ffn(jcfg, _layer(jp), jnp.asarray(x))
    got = tmoe.moe_ffn(tcfg, _layer(tp), torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    if cf == 0.5:     # some tokens were dropped: rows with a zero output
        assert (np.abs(_np(got)).sum(-1) == 0).any() or \
            not np.allclose(_np(got), _np(tmoe.moe_ffn(
                dataclasses.replace(tcfg, capacity_factor=16.0),
                _layer(tp), torch.from_numpy(x))))


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_selects_the_reference_experts(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=3)
    x = _x(tcfg, (64,), seed=3)
    jl = jnp.asarray(x) @ jp["layers"]["router"][0]
    jg, je = jax.lax.top_k(jl, jcfg.top_k)
    logits, te, tg = tmoe.route(tcfg, tp["layers"]["router"][0],
                                torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jax.nn.softmax(jg)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_ATOL)


def test_routing_ties_order():
    """Forced ties (a zero router: every logit equal).  ``lax.top_k``
    takes the lower index first, and so does the port's stable sort
    (``torch.topk`` took experts 2, 3 here), so the same experts run and
    the outputs agree."""
    jcfg, tcfg = configs("dbrx_132b")
    _, tp = both_params(jcfg, tcfg, seed=4)
    p = dict(_layer(tp), router=torch.zeros_like(_layer(tp)["router"]))
    x = torch.from_numpy(_x(tcfg, (1, 8), seed=4))
    _, te, tg = tmoe.route(tcfg, p["router"], x)
    _, je = jax.lax.top_k(jnp.zeros((8, tcfg.n_experts)), tcfg.top_k)
    assert torch.equal(tg, torch.full_like(tg, 1 / tcfg.top_k))
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je))
    assert te[0, 0].tolist() == list(range(tcfg.top_k))
    jp = {k: jnp.asarray(_np(v)) for k, v in p.items()}
    jcfg16 = dataclasses.replace(jcfg, capacity_factor=16.0)
    tcfg16 = dataclasses.replace(tcfg, capacity_factor=16.0)
    np.testing.assert_allclose(
        _np(tmoe.moe_ffn(tcfg16, p, x)),
        _np(jmoe.moe_ffn(jcfg16, jp, jnp.asarray(_np(x)))),
        rtol=0, atol=F32_ATOL)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 4)).astype(np.float32)
    top_e = np.argsort(-logits, -1)[:, :2].astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                      jnp.asarray(top_e), 4)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(top_e).long(), 4)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch,cf", [("global", 0.5), ("per_seq", 1.25)])
def test_moe_ffn_gradients_match_reference(arch, dispatch, cf):
    """Gradients through the gates (router), the experts and the input,
    against ``jax.grad`` of the reference's FFN, dropped tokens included."""
    jcfg, tcfg = configs(arch, capacity_factor=cf, moe_dispatch=dispatch)
    jp, tp = both_params(jcfg, tcfg, seed=6)
    x = _x(tcfg, (2, 24), seed=6)
    go = _x(tcfg, (2, 24), seed=7)
    jw = _layer(jp)
    want = jax.grad(lambda w, xx: jnp.sum(
        jmoe.moe_ffn(jcfg, w, xx) * go), argnums=(0, 1))(jw, jnp.asarray(x))
    tw = {k: v.clone().requires_grad_() for k, v in _layer(tp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tmoe.moe_ffn(tcfg, tw, tx)
    names = sorted(tw)
    grads = torch.autograd.grad(out, [tw[k] for k in names] + [tx],
                                torch.from_numpy(go))
    for k, g in zip(names + ["x"], grads):
        w = np.asarray(want[0][k] if k != "x" else want[1])
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)


@pytest.mark.parametrize("dispatch", ["global", "per_seq"])
def test_expert_ranges_sum_to_the_whole(dispatch):
    """``experts=(lo, hi)`` with only those experts' weights: the parts of
    two halves add up to the whole FFN (the expert-parallel mesh's sum)."""
    _, tcfg = configs("dbrx_132b", capacity_factor=0.5,
                      moe_dispatch=dispatch)
    tp = bridge.params_from_numpy(tcfg, numpy_params(
        configs("dbrx_132b")[0], 8), device="cpu")
    w = _layer(tp)
    x = torch.from_numpy(_x(tcfg, (2, 16), seed=8))
    whole = tmoe.moe_ffn(tcfg, w, x)
    half = tcfg.n_experts // 2
    parts = []
    for lo, hi in ((0, half), (half, tcfg.n_experts)):
        local = dict(w, **{k: w[k][lo:hi] for k in ("we_gate", "we_up",
                                                     "we_down")})
        parts.append(tmoe.moe_ffn(tcfg, local, x, experts=(lo, hi)))
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=0,
                               atol=1e-6)


def test_moe_dispatch_makes_no_host_sync():
    """The forward and backward of the FFN under ``_HostSyncGuard`` (no
    ``.item()``, ``nonzero``, boolean-mask indexing or copy to the CPU):
    what a CUDA graph capture needs."""
    _, tcfg = configs("dbrx_132b", capacity_factor=0.5)
    tp = bridge.params_from_numpy(tcfg, numpy_params(
        configs("dbrx_132b")[0], 9), device="cpu")
    w = {k: v.requires_grad_() for k, v in _layer(tp).items()}
    x = torch.from_numpy(_x(tcfg, (2, 16), seed=9)).requires_grad_()
    with _HostSyncGuard():
        out = tmoe.moe_ffn(tcfg, w, x)
        torch.autograd.grad(out.sum(), list(w.values()) + [x])


# --- sliding-window prefill ------------------------------------------------------

@pytest.mark.parametrize("s,window,q_block", [(64, 24, 16), (48, 16, 48),
                                              (40, 8, 8)])
def test_attn_window_linear_matches_reference(s, window, q_block):
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    want = JL.attn_window_linear(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window,
                                 q_block=q_block)
    got = TL.attn_window_linear(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window,
                                q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    # and the naive path with the window mask
    pos = torch.arange(s)
    naive = TL.attn_naive(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), q_pos=pos, k_pos=pos,
                          causal=True, window=window)
    torch.testing.assert_close(got, naive, rtol=0, atol=F32_ATOL)


def test_attn_window_linear_refuses_a_ragged_block():
    z = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="multiple of q_block"):
        TL.attn_window_linear(z, z, z, window=8, q_block=16)
    # the dispatch reaches it for a causal window shorter than the sequence
    out = TL.attention(z, z, z, impl="chunked", window=8)
    assert out.shape == z.shape


def test_swa_matches_full_attention_within_window():
    """The reference's ``tests/test_models.py:94`` case on the port: a
    window of 64 over 32 tokens is full attention; and both against the
    reference."""
    jcfg, tcfg = configs("mixtral_8x22b", window=64, capacity_factor=16.0)
    jp, tp = both_params(jcfg, tcfg, seed=10)
    toks = np.random.default_rng(10).integers(0, tcfg.vocab_size, (2, 32))
    lw = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    lf = tm.forward(dataclasses.replace(tcfg, window=0), tp,
                    {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lw.numpy(), lf.numpy(), rtol=2e-4, atol=2e-4)
    want = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(lw.numpy(), _np(want), rtol=0, atol=F32_ATOL)


# --- the model -------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("mixtral_8x22b", 64),
                                    ("mixtral_8x22b", 24),
                                    ("dbrx_132b", 37)])
@pytest.mark.parametrize("impl_j,impl_t", [("naive", "naive"),
                                           ("pallas", "kernel")])
def test_forward_matches_reference(arch, s, impl_j, impl_t):
    """Prefill logits and cache; mixtral's window 32 under 64 tokens runs
    ``attn_window_linear`` (the kernel path routes a window there too) and
    keeps the last 32 positions."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=11)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, s))
    wl, wc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True, attn_impl=impl_j)
    gl, gc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        return_cache=True, attn_impl=impl_t)
    np.testing.assert_allclose(_np(gl), _np(wl), rtol=0, atol=F32_ATOL)
    for name in ("k", "v"):
        assert gc[name].shape == wc[name].shape
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("arch,prefill,steps", [("mixtral_8x22b", 40, 30),
                                                ("dbrx_132b", 9, 6)])
def test_decode_matches_reference(arch, prefill, steps):
    """Mixtral decodes 30 tokens past a 40-token prefill in its 32-slot
    ring, so every slot is overwritten (the wrap)."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=12)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, tcfg.vocab_size, (2, prefill))
    _, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       return_cache=True)
    _, tc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    size = prefill + steps
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, size))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, 2, size, device="cpu"))
    for _ in range(steps):
        nxt = rng.integers(0, tcfg.vocab_size, (2, 1))
        wl, jc = jm.decode(jcfg, jp, jc, jnp.asarray(nxt))
        gl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(gl), _np(wl), rtol=0, atol=F32_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_reference(arch):
    """Greedy tokens of ``BatchedServer`` on left-padded prompts of mixed
    lengths; mixtral's prompts pass its window."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=13)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (6, 35, 20)]
    out = []
    for cls, srv in ((JRequest, JServer(jcfg, jp, max_len=64,
                                         batch_size=2)),
                     (TRequest, TServer(tcfg, tp, max_len=64,
                                        batch_size=2))):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        srv.run(reqs)
        out.append([r.output for r in reqs])
    assert out[0] == out[1] and all(len(o) == 5 for o in out[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_requests_serve_alike(arch):
    """The reference launcher's requests (``repro.launch.serve.
    make_requests``; mixtral's 40-token prompts pass its window) through
    the reference's ``BatchedServer`` and the port's ``launch.serve``
    path (its own ``make_requests``, equal prompts): the same tokens."""
    from repro.launch.serve import make_requests as jmake
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=20)
    jreqs = jmake(jcfg, 3, 40, 6, seed=20)
    treqs = tlaunch.make_requests(tcfg, 3, 40, 6, seed=20)
    JServer(jcfg, jp, max_len=48, batch_size=2).run(jreqs)
    TServer(tcfg, tp, max_len=48, batch_size=2).run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_moe_on_cpu(arch, capsys):
    for extra in ([], ["--continuous"]):
        tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--prompt-len", "8", "--max-new",
                      "4", "--batch-size", "2"] + extra)
        assert "3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_bytes_equal(arch):
    """Mixtral's cache is capped at the window (4096 slots at full size)."""
    for batch, ctx, page in ((1, 16, 16), (8, 549, 16), (2, 8192, 64)):
        assert tmem.kv_cache_bytes(tget(arch), batch, ctx, page) == \
            jmem.kv_cache_bytes(jget(arch), batch, ctx, page)
        assert tpaged.page_bytes(tget(arch), page) == \
            jpaged.page_bytes(jget(arch), page)
    if arch == "mixtral_8x22b":
        assert tmem.kv_cache_bytes(tget(arch), 1, 8192) == \
            tmem.kv_cache_bytes(tget(arch), 1, 4096)


# --- training ----------------------------------------------------------------------

def _batch(vocab, seed, shape=(2, 48)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., :5] = jm.IGNORE_LABEL
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_loss_and_grads_match_reference(arch, impl):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's loss (its jnp path), fp32; mixtral's 48 tokens pass
    its 32-token window."""
    jcfg, tcfg = configs(arch, attn_impl="naive", remat="full")
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    jp, tp = both_params(jcfg, tcfg, seed=14)
    batch = _batch(tcfg.vocab_size, 14)
    (wl, _), wg = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = topt.tree_leaves(tp)
    for _, p in leaves:
        p.requires_grad_()
    loss, _ = tm.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    want = _flatten(wg)
    assert set(want) == {k for k, _ in leaves}
    for (k, _), g in zip(leaves, grads):
        w = np.asarray(want[k], np.float32)
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)


def test_train_step_device_body_makes_no_host_sync():
    """One ``train_step_on_device`` of reduced dbrx (kernel path) under
    ``_HostSyncGuard``: the graphed train step can capture the MoE."""
    jcfg, tcfg = configs("dbrx_132b", attn_impl="kernel", remat="full")
    _, tp = both_params(jcfg, tcfg, seed=15)
    state = topt.init_state(tp)
    batch = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
        seq_len=32, global_batch=4, num_microbatches=2)).batch(0)
    db, w = tts.device_inputs(tcfg, tp, batch, None)
    with _HostSyncGuard():
        _, _, metrics = tts.train_step_on_device(
            tcfg, topt.OptimizerConfig(), tp, state, db, w)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1


@pytest.mark.parametrize("grad_layout", ["contiguous", "transposed"])
def test_adamw_updates_a_large_leaf_a_slice_at_a_time(monkeypatch,
                                                       grad_layout):
    """A leaf past ``ADAMW_SLICE`` elements is updated a slice at a time
    (its fp32 temporaries a slice's): the same bits as one pass, whatever
    the gradient's layout (autograd may give a transposed one)."""
    gen = torch.Generator().manual_seed(18)
    leaves = [torch.randn(300, 70, generator=gen).to(dt)
              for dt in (torch.bfloat16, torch.bfloat16)] + [
        torch.randn(300, 70, generator=gen), torch.rand(300, 70,
                                                          generator=gen)]
    if grad_layout == "transposed":
        leaves[1] = leaves[1].t().contiguous().t()
        assert not leaves[1].is_contiguous()
    args = (torch.tensor(0.7), torch.tensor(1e-3),
            (torch.tensor(0.1), torch.tensor(0.01)))
    whole = [t.clone() for t in leaves]
    topt._adamw_elems(topt.OptimizerConfig(), *whole, *args)
    monkeypatch.setattr(topt, "ADAMW_SLICE", 1000)
    sliced = [t.clone() for t in leaves]
    topt._adamw(topt.OptimizerConfig(), *sliced, *args)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))


def test_one_microbatch_gives_grads_in_the_params_dtype():
    """One microbatch, no weights: ``loss_and_grads`` returns autograd's
    gradients (bf16 here) with no fp32 copy, and the AdamW step from them
    equals the step from their fp32 sum bit for bit."""
    _, tcfg = configs("dbrx_132b", dtype="bfloat16")
    tp = bridge.params_from_numpy(tcfg, numpy_params(
        configs("dbrx_132b")[0], 19), device="cpu")
    batch = {k: v[None] for k, v in _batch(tcfg.vocab_size, 19).items()}
    loss, grads = tts.loss_and_grads(tcfg, tp, batch)
    flat = dict(topt.tree_leaves(grads))
    assert all(g.dtype == torch.bfloat16 for g in flat.values())
    wl, wg = tts.loss_and_grads(tcfg, tp, batch, micro_weights=[1.0])
    assert torch.equal(loss, wl)
    # a sum (weights, or two microbatches) is fp32
    assert all(g.dtype == torch.float32 for _, g in topt.tree_leaves(wg))
    two = {k: np.concatenate([v, v]) for k, v in batch.items()}
    _, g2 = tts.loss_and_grads(tcfg, tp, two)
    assert all(g.dtype == torch.float32 for _, g in topt.tree_leaves(g2))
    assert all(torch.equal(flat[k].float(), g)
               for k, g in topt.tree_leaves(wg))
    outs = []
    for g in (grads, wg):
        p = {k: v.clone() for k, v in topt.tree_leaves(tp)}
        p = topt.tree_unflatten(p.items())
        st = topt.init_state(p)
        topt.apply_updates(p, g, st, topt.OptimizerConfig())
        outs.append(p)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        topt.tree_leaves(outs[0]), topt.tree_leaves(outs[1])))


def test_launch_train_runs_moe_on_cpu(capsys):
    tlaunch_train.main(["--arch", "dbrx_132b", "--reduced", "--device", "cpu",
                        "--steps", "2"])
    assert "[train] 2 steps" in capsys.readouterr().out


# --- the mesh and the pipeline (held against the port's one-device step) ---------

def _mesh(dp, tp):
    return data_model_mesh(dp, tp, [CPU] * (dp * tp))


def _mesh_batch(cfg, seed, n_micro=2, mbs=4, seq=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n_micro, mbs, seq + 1))
    labels = toks[..., 1:].copy()
    labels[:, 0, :seq // 2] = tm.IGNORE_LABEL
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


@pytest.mark.parametrize("n_experts,shape,policy,dispatch", [
    (4, (1, 2), "tp", "global"),        # expert parallel: 2 experts a position
    (3, (1, 2), "tp", "global"),        # e_ff sharded inside each expert
    (4, (2, 2), "fsdp_tp", "global"),   # + dp 2: the batch gathered to route
    (4, (2, 2), "fsdp_tp", "per_seq"),  # + dp 2: each sequence alone
])
def test_sharded_moe_step_matches_single_device(n_experts, shape, policy,
                                                dispatch):
    """Loss (1e-5) and every gradient (1e-5 of max |g|) of the sharded
    MoE step against ``loss_and_grads`` on one device, capacity binding
    (cf 0.5, so drops happen) and the layouts the rules give."""
    from test_torch_mesh import _check_grads, _numpy_params
    cfg = dataclasses.replace(tget("dbrx_132b").reduced(), head_dim=64,
                              sharding=policy, n_experts=n_experts,
                              capacity_factor=0.5, moe_dispatch=dispatch)
    mesh = _mesh(*shape)
    flat = _numpy_params(cfg, 16)
    single = bridge.params_from_numpy(cfg, flat, "cpu")
    sharded = bridge.sharded_params_from_numpy(cfg, flat, mesh)
    spec = sharded["layers"]["we_up"].spec
    if n_experts % shape[1] == 0:
        assert spec[1] == "model" and spec[3] is None
    else:
        assert spec[1] is None and spec[3] == "model"
    batch = _mesh_batch(cfg, 16)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    _check_grads(gg, wg)


def _pipe_full(tcfg, jcfg, seed=17):
    return bridge.params_from_numpy(tcfg, numpy_params(jcfg, seed),
                                    device="cpu")


@pytest.mark.parametrize("tps", [[1, 1], [2, 1]])
def test_moe_pipeline_matches_the_single_device_step(tps):
    """``MPMDPipeline(family="moe")`` on ``[cpu] * n`` (``[2, 1]``: stage
    0 a (1, 2) mesh, 4 experts on 2 positions, expert parallel): the
    first step's loss and gradients against ``loss_and_grads``, then two
    steps' losses against ``make_train_step`` (clip off)."""
    jcfg, tcfg = configs("dbrx_132b", n_layers=4, tie_embeddings=False,
                         capacity_factor=0.5)
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    full = _pipe_full(tcfg, jcfg)
    stages = tpl.even_stages(tcfg, tps)
    pipe = tpl.MPMDPipeline(tcfg, stages, ocfg, policy="tp",
                            devices=["cpu"] * sum(s.n_devices
                                                  for s in stages))
    pipe.full_params_like(full)
    if tps[0] == 2:
        assert pipe.params[0]["layers"]["we_up"].spec[1] == "model"
    rng = np.random.default_rng(17)
    toks = rng.integers(0, tcfg.vocab_size, (2, 2, 17)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    loss, grads = pipe.grad_step(batch)
    wl, wg = tts.loss_and_grads(tcfg, full, batch)
    assert abs(loss - wl.item()) <= 1e-5 * abs(loss)
    flat = dict(topt.tree_leaves(wg))
    for st, g in zip(pipe.stages, grads):
        for k, x in pm.tree_items(g):
            t = tpl._full(x) if isinstance(x, pm.Sharded) else x
            w = flat[k][st.start:st.stop] if k.startswith("layers/") \
                else flat[k]
            err = (t - w).abs().max().item()
            assert err <= 1e-5 * max(1.0, w.abs().max().item()), (k, err)
    pipe.apply_grads(grads)
    ref = _pipe_full(tcfg, jcfg)
    state = topt.init_state(ref)
    step = tts.make_train_step(tcfg, ocfg)
    step(ref, state, batch)
    b2 = {"tokens": toks[..., :-1][::-1].copy(),
          "labels": toks[..., 1:][::-1].copy()}
    l2 = pipe.train_step(b2)
    _, _, m = step(ref, state, b2)
    assert abs(l2 - m["loss"].item()) <= 1e-5 * abs(l2)
