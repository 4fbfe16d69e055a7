"""The port's Mamba-2 family (``repro_torch/models/mamba2.py`` and its uses)
against the reference, on the same seeded numpy weights (``test_torch_model``).

Tolerances: fp32 1e-4 for the SSD core (the reference's
``tests/test_models.py``), ``test_torch_model``'s 2e-5 for logits and
caches, ``test_torch_train``'s 1e-4 of max |g| for gradients; bf16 4e-2
where stated.  Both SSD routes run here: ``"chunked"`` (``ssd_chunked``,
the CPU's and autograd's) and ``"kernel"`` (``kops.ssd_scan``, whose CPU
path is the kernel's plain version, ``ssd_scan_passes_plain``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.simulator import memory as jmem
from repro.dist.sharding import Decl as JDecl
from repro.models import mamba2 as jmamba
from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.serve import paged_cache as jpaged
from repro.serve.serve_step import BatchedServer as JServer
from repro.serve.serve_step import Request as JRequest
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core.simulator import memory as tmem
from repro_torch.dist.sharding import iter_decls
from repro_torch.kernels import ops as kops
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import paged_cache as tpaged
from repro_torch.serve import serve_step as tss
from repro_torch.serve.serve_step import BatchedServer as TServer
from repro_torch.serve.serve_step import Request as TRequest
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_model import F32_ATOL, both_params, configs
from test_torch_train import _close_params

SSD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-4
ARCH = "mamba2_130m"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=what)


def decl_table(decls, is_jax):
    """{path: (shape, init, scale_dim)} of a decls tree (either package)."""
    if is_jax:
        leaves = jax.tree_util.tree_flatten_with_path(
            decls, is_leaf=lambda x: isinstance(x, JDecl))[0]
        return {"/".join(str(p.key) for p in path): (d.shape, d.init,
                                                     d.scale_dim, d.axes)
                for path, d in leaves}
    return {path: (d.shape, d.init, d.scale_dim, d.axes)
            for path, d in iter_decls(decls)}


def ssd_inputs(seed, b=2, s=24, h=3, p=8, n=4, dt_range=(0.01, 0.1),
               a_range=(0.5, 2.0), state=False):
    """The reference test's SSD inputs (``tests/test_models.py``), numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = dict(x=rng.standard_normal((b, s, h, p)).astype(f),
               dt=rng.uniform(*dt_range, (b, s, h)).astype(f),
               a=-rng.uniform(*a_range, (h,)).astype(f),
               b=rng.standard_normal((b, s, n)).astype(f),
               c=rng.standard_normal((b, s, n)).astype(f))
    if state:
        out["init_state"] = rng.standard_normal((b, h, p, n)).astype(f)
    return out


def _both(inputs, dtype):
    """(jax kwargs, torch kwargs): x, b, c in ``dtype``, dt, a and the
    state fp32."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    low = ("x", "b", "c")
    j = {k: jnp.asarray(v, jd if k in low else jnp.float32)
         for k, v in inputs.items()}
    t = {k: torch.from_numpy(v).to(td if k in low else torch.float32)
         for k, v in inputs.items()}
    return j, t


# --- declarations ------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(reduced):
    jcfg, tcfg = jget(ARCH), tget(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert decl_table(tm.decls(tcfg), False) == \
        decl_table(jm.decls(jcfg), True)
    for batch, max_len in ((1, 0), (3, 17)):
        assert decl_table(tm.cache_decls(tcfg, batch, max_len), False) == \
            decl_table(jm.cache_decls(jcfg, batch, max_len), True)


# --- the SSD core ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [24, 21, 5])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_chunked_matches_reference(dtype, s, state):
    """``ssd_chunked`` against the reference's ``ssd_chunked`` and its
    ``ssd_ref_sequential`` (chunk 8: whole chunks, a ragged tail, one
    short chunk; from zero and from a given state)."""
    j, t = _both(ssd_inputs(0, s=s, state=state), dtype)
    tol = SSD_TOL[dtype]
    jargs = (j["x"], j["dt"], j["a"], j["b"], j["c"])
    targs = (t["x"], t["dt"], t["a"], t["b"], t["c"])
    y, st = tmamba.ssd_chunked(*targs, 8, t.get("init_state"))
    assert y.dtype == t["x"].dtype and st.dtype == torch.float32
    for wy, wst in (jmamba.ssd_chunked(*jargs, 8, j.get("init_state")),
                    jmamba.ssd_ref_sequential(*jargs, j.get("init_state"))):
        _close(y, wy, tol, "y")
        _close(st, wst, tol, "state")
    sy, sst = tmamba.ssd_ref_sequential(*targs, t.get("init_state"))
    wy, wst = jmamba.ssd_ref_sequential(*jargs, j.get("init_state"))
    _close(sy, wy, tol, "sequential y")
    _close(sst, wst, tol, "sequential state")


@pytest.mark.parametrize("s", [24, 21])
def test_ssd_routes_agree(s):
    """The kernel route's plain version and ``ssd_chunked`` on the same
    inputs, fp32 1e-4."""
    _, t = _both(ssd_inputs(1, s=s), "float32")
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"])
    ky, kst = kops.ssd_scan(*args, chunk=8)
    cy, cst = tmamba.ssd_chunked(*args, 8)
    _close(ky, cy, 1e-4, "y")
    _close(kst, cst, 1e-4, "state")


def test_r5_masked_exponential_keeps_the_gradient_finite():
    """Chunks whose |sum dt*a| passes 88 (dt up to 2, a down to -8, chunk
    16): the reference's ``jax.grad`` w.r.t. dt through its
    ``ssd_chunked`` is non-finite (exp over the whole chunk square), the
    port's autograd gradient is finite and equals ``jax.grad`` of the
    sequential oracle."""
    inputs = ssd_inputs(2, b=1, s=32, dt_range=(1.0, 2.0),
                        a_range=(6.0, 8.0))
    j, t = _both(inputs, "float32")
    assert float(-(inputs["dt"][0, :16] * inputs["a"]).sum(0).min()) > 88

    def jloss(fn, chunk_arg):
        def f(dt):
            args = (j["x"], dt, j["a"], j["b"], j["c"]) + chunk_arg
            y, st = fn(*args)
            return (y * j["x"]).sum() + st.sum()
        return jax.grad(f)(j["dt"])

    bad = np.asarray(jloss(jmamba.ssd_chunked, (16,)))
    assert not np.isfinite(bad).all()
    want = np.asarray(jloss(jmamba.ssd_ref_sequential, ()))
    assert np.isfinite(want).all()
    dt = t["dt"].clone().requires_grad_()
    y, st = tmamba.ssd_chunked(t["x"], dt, t["a"], t["b"], t["c"], 16)
    (g,) = torch.autograd.grad((y * t["x"]).sum() + st.sum(), dt)
    assert torch.isfinite(g).all()
    err = np.abs(g.numpy() - want).max()
    assert err <= GRAD_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("s", [7, 1])
def test_conv1d_causal_matches_reference(state, s):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, 10)).astype(np.float32)
    w = rng.standard_normal((tmamba.CONV_K, 10)).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    st = rng.standard_normal((2, 3, 10)).astype(np.float32) if state \
        else None
    wy, wst = jmamba._conv1d_causal(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if st is None else jnp.asarray(st))
    gy, gst = tmamba._conv1d_causal(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        None if st is None else torch.from_numpy(st))
    _close(gy, wy, 1e-6, "y")
    _close(gst, wst, 0.0, "state")


# --- the layer ---------------------------------------------------------------------

def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("s", [24, 13])
def test_mamba_block_matches_reference(impl, s):
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=4)
    x = np.random.default_rng(4).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    wo, wst = jmamba.mamba_block(jcfg, _layer(jp), jnp.asarray(x),
                                 return_state=True)
    go, gst = tmamba.mamba_block(tcfg, _layer(tp), torch.from_numpy(x),
                                 return_state=True, impl=impl)
    _close(go, wo, F32_ATOL, "out")
    _close(gst["ssm"], wst["ssm"], F32_ATOL, "ssm")
    _close(gst["conv"], wst["conv"], F32_ATOL, "conv")
    # one decode step from that state (the chunked route takes a state)
    t = np.random.default_rng(5).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32)
    wo, wst2 = jmamba.mamba_decode_block(jcfg, _layer(jp), jnp.asarray(t),
                                         wst)
    go, gst2 = tmamba.mamba_decode_block(tcfg, _layer(tp),
                                         torch.from_numpy(t), gst)
    _close(go, wo, F32_ATOL, "decode out")
    _close(gst2["ssm"], wst2["ssm"], F32_ATOL, "decode ssm")


def test_mamba_block_refuses_a_state_on_the_kernel_route():
    jcfg, tcfg = configs(ARCH)
    _, tp = both_params(jcfg, tcfg, seed=4)
    x = torch.zeros(1, 1, tcfg.d_model)
    st = {"ssm": torch.zeros(1, tcfg.ssm_nheads, tcfg.ssm_headdim,
                             tcfg.ssm_state),
          "conv": torch.zeros(1, 3, tcfg.d_inner + 2 * tcfg.ssm_state)}
    with pytest.raises(ValueError, match="zero state"):
        tmamba.mamba_block(tcfg, _layer(tp), x, state=st, impl="kernel")
    with pytest.raises(ValueError, match="unknown SSD impl"):
        tmamba.mamba_block(tcfg, _layer(tp), x, impl="pallas")


@pytest.mark.parametrize("device,prefill,grad,want", [
    ("cuda", True, False, "kernel"), ("cuda", False, False, "chunked"),
    ("cuda", True, True, "chunked"), ("cpu", True, False, "chunked")])
def test_pick_ssd_impl(device, prefill, grad, want):
    assert tmamba.pick_ssd_impl(device, prefill=prefill, grad=grad) == want


@pytest.mark.parametrize("fn", ["ssd_scan", "rmsnorm", "add"])
def test_forward_only_wrappers_refuse_a_gradient(fn):
    """The kernels without a backward raise where a gradient would be
    taken (the card would drop it silently), and run under no_grad and
    on inputs that need none."""
    _, t = _both(ssd_inputs(6), "float32")
    x2 = torch.randn(4, 16)
    sc = torch.randn(16)
    calls = {"ssd_scan": lambda x: kops.ssd_scan(
                 x, t["dt"], t["a"], t["b"], t["c"], chunk=8),
             "rmsnorm": lambda x: kops.rmsnorm(x, sc),
             "add": lambda x: kops.add(x, x2)}
    base = t["x"] if fn == "ssd_scan" else x2
    calls[fn](base)
    leaf = base.clone().requires_grad_()
    with pytest.raises(RuntimeError, match=f"ops.{fn}: the kernel has no "
                                           f"backward"):
        calls[fn](leaf)
    with torch.no_grad():
        calls[fn](leaf)
    with torch.inference_mode():
        calls[fn](base)


# --- the model -------------------------------------------------------------------

@pytest.mark.parametrize("s", [24, 21, 5])
@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_forward_matches_reference(s, impl):
    """Logits and the prefill state (``ssm`` fp32, ``conv``)."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=7)
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, s))
    wl, wc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True)
    gl, gc = tmamba.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            return_cache=True, ssd_impl=impl)
    _close(gl, wl, F32_ATOL, "logits")
    assert gc["ssm"].dtype == torch.float32 and gc["len"] == s
    for name in ("ssm", "conv"):
        _close(gc[name], wc[name], F32_ATOL, name)
    assert torch.equal(tm.forward(tcfg, tp,
                                  {"tokens": torch.from_numpy(toks)}),
                       tmamba.forward(tcfg, tp,
                                      {"tokens": torch.from_numpy(toks)},
                                      ssd_impl="chunked"))


def test_decode_matches_reference():
    """A 13-token prefill, ``grow_cache`` into ``init_cache`` (fp32 here)
    and 4 decode steps: logits each step and the final state."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=8)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13))
    _, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       return_cache=True)
    _, tc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, 32))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, 2, 32, device="cpu"))
    for _ in range(4):
        nxt = rng.integers(0, tcfg.vocab_size, (2, 1))
        wl, jc = jm.decode(jcfg, jp, jc, jnp.asarray(nxt))
        gl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        _close(gl, wl, F32_ATOL, "logits")
    assert tc["len"] == int(jc["len"]) == 17
    for name in ("ssm", "conv"):
        _close(tc[name], jc[name], F32_ATOL, name)


def _served(cls_req, server, prompts, news):
    reqs = [cls_req(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, news))]
    server.run(reqs)
    return [r.output for r in reqs], server


def serve_alike(arch, **over):
    """``BatchedServer`` tokens of both packages on left-padded prompts of
    mixed lengths and mixed ``max_new_tokens`` (the batch of four falls to
    one live row: compaction), batches of 4 then 2."""
    jcfg, tcfg = configs(arch, **over)
    jp, tp = both_params(jcfg, tcfg, seed=9)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (6, 13, 9, 4, 11, 3)]
    news = (8, 2, 2, 3, 5, 4)
    want, _ = _served(JRequest, JServer(jcfg, jp, max_len=32, batch_size=4),
                      prompts, news)
    got, srv = _served(TRequest, TServer(tcfg, tp, max_len=32, batch_size=4),
                       prompts, news)
    assert got == want and [len(o) for o in got] == list(news)
    # 7 steps of the first batch (3 rows, then 1 after compaction at step 2)
    # and 4 of the second
    assert srv.decode_steps == 7 + 4
    return srv


def test_batched_server_matches_reference():
    srv = serve_alike(ARCH)
    assert srv.state["ssm"].dtype == torch.float32
    assert set(srv.state) == {"ssm", "conv", "len", "cur"}


def test_served_state_hand_off_rounds_once_bf16():
    """The precision trap, bf16: the reference's ``grow_cache`` casts the
    prefill's fp32 SSM state into its bf16 cache, and its decode carries
    the state in fp32 from the first step on.  The port's served state
    keeps an fp32 ``ssm`` buffer (a divergence in the layout) and writes
    the prefill's state into it rounded through bf16, so the values
    follow the reference's: bf16-representable after the prefill, fp32
    after a decode step, logits within bf16 4e-2 of the reference's at
    each step.  A plain ``copy_`` of the fp32 state (no rounding) would
    leave values that bf16 does not hold."""
    jcfg, tcfg = configs(ARCH, "bfloat16")
    jp, tp = both_params(jcfg, tcfg, seed=10)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13))
    wl, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True)
    assert jc["ssm"].dtype == jnp.float32
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, 32))
    assert jc["ssm"].dtype == jnp.bfloat16        # the reference's layout
    state = tss.decode_state(tcfg, 2, 32, per_row=False, device="cpu")
    assert state["ssm"].dtype == torch.float32    # the port's
    assert state["conv"].dtype == torch.bfloat16
    _, raw = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        return_cache=True)
    assert not torch.equal(raw["ssm"], raw["ssm"].bfloat16().float())
    first = tss.prefill_on_device(tcfg, tp, state, torch.from_numpy(toks), 2)
    ssm = state["ssm"]
    assert torch.equal(ssm, ssm.bfloat16().float())
    assert torch.equal(ssm, raw["ssm"].bfloat16().float())
    _close(ssm, jc["ssm"], 4e-2 * float(np.abs(_np(jc["ssm"])).max()),
           "state after the hand-off")
    _close(first, wl[:, -1], 4e-2 * float(np.abs(_np(wl)).max()),
           "prefill logits")
    cur = jnp.asarray(state["cur"].numpy())
    for step in range(4):
        wl, jc = jm.decode(jcfg, jp, jc, cur)
        gl = tss.decode_on_device(tcfg, tp, tss.rows_of(state, 2))
        assert jc["ssm"].dtype == jnp.float32 and \
            state["ssm"].dtype == torch.float32
        top = float(np.abs(_np(wl)).max())
        _close(gl, wl[:, -1], 4e-2 * top, f"logits at step {step}")
        cur = jnp.asarray(state["cur"].numpy())
    assert not torch.equal(state["ssm"], state["ssm"].bfloat16().float())
    _close(state["ssm"], jc["ssm"], 4e-2 * float(np.abs(_np(jc["ssm"])).max()),
           "state after 4 steps")


@pytest.mark.parametrize("served", [False, True])
def test_state_size_constant_in_context(served):
    """SSM decode memory does not grow with context (the reference's
    ``test_ssm_decode_long_context_state_size_constant``)."""
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    if served:
        state = tss.decode_state(tcfg, 1, 8, per_row=False, device="cpu")
        sizes = []
        for _ in range(4):
            tss.decode_on_device(tcfg, tp, tss.rows_of(state, 1))
            sizes.append(tkv.cache_bytes(state))
    else:
        cache = tm.init_cache(tcfg, 1, 8, device="cpu")
        sizes = []
        for _ in range(4):
            _, cache = tm.decode(tcfg, tp, cache, torch.zeros(
                1, 1, dtype=torch.int64))
            sizes.append(tkv.cache_bytes(cache))
    assert len(set(sizes)) == 1
    assert tm.init_cache(tcfg, 1, 8, device="cpu")["ssm"].shape == \
        tm.init_cache(tcfg, 1, 4096, device="cpu")["ssm"].shape


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

def _batch(vocab, seed, shape=(2, 21)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., :5] = jm.IGNORE_LABEL
    return {"tokens": toks, "labels": labels}


def grads_alike(arch, remat, seed, **over):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's, fp32 (21 tokens: a ragged chunk)."""
    jcfg, tcfg = configs(arch, remat=remat, **over)
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    batch = _batch(tcfg.vocab_size, seed)
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
    return dict(zip([k for k, _ in leaves], grads))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_reference(remat):
    grads_alike(ARCH, remat, seed=11)


def test_kernel_route_under_autograd_raises():
    """The train path takes the chunked route; forcing the kernel route
    under autograd raises instead of dropping the SSD's gradient."""
    jcfg, tcfg = configs(ARCH)
    _, tp = both_params(jcfg, tcfg, seed=12)
    for _, p in topt.tree_leaves(tp):
        p.requires_grad_()
    toks = torch.from_numpy(_batch(tcfg.vocab_size, 12)["tokens"])
    with pytest.raises(RuntimeError, match="ops.ssd_scan"):
        tmamba.forward(tcfg, tp, {"tokens": toks}, ssd_impl="kernel")


def train_step_alike(arch, seed, **over):
    """One ``make_train_step`` AdamW step of both packages on the same
    ``SyntheticDataset`` batch (two microbatches) from the same weights:
    loss, grad norm and lr rtol 1e-5, params as ``test_torch_train``
    holds them."""
    jcfg, tcfg = configs(arch, remat="full", **over)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    dc = dict(seq_len=20, global_batch=4, num_microbatches=2, seed=1)
    jb = jdata.SyntheticDataset(jcfg, jdata.DataConfig(**dc)).batch(0)
    tb = tdata.SyntheticDataset(tcfg, tdata.DataConfig(**dc)).batch(0)
    jp, tp = both_params(jcfg, tcfg, seed=seed)
    _, grads = tts.loss_and_grads(tcfg, tp, tb)
    near_zero = {k: (g.abs() <= 1e-4 * g.abs().max()).numpy()
                 for k, g in topt.tree_leaves(grads)}
    jp, _, jmet = jax.jit(jts.make_train_step(
        jcfg, jopt.OptimizerConfig(**ocfg)))(
        jp, jopt.init_state(jp), {k: jnp.asarray(v) for k, v in jb.items()})
    ts = topt.init_state(tp)
    _, _, tmet = tts.make_train_step(tcfg, topt.OptimizerConfig(**ocfg))(
        tp, ts, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    _close_params(bridge.params_to_numpy(tp), _flatten(jp), near_zero,
                  ocfg["lr"], "step 1")
    assert int(ts["step"]) == 1


def test_train_step_matches_reference():
    train_step_alike(ARCH, seed=13)


def test_bridge_carries_params_and_opt_state():
    """The family's trees cross ``bridge`` unchanged, both ways."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=14)
    flat = _flatten(jp)
    back = bridge.params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
    js = jopt.init_state(jp)
    ts = bridge.opt_state_from_numpy(tcfg, _flatten(js), device="cpu")
    assert sorted(bridge.opt_state_to_numpy(ts)) == sorted(_flatten(js))
