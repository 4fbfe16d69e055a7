"""``repro_torch`` training path vs ``repro``'s on the same weights and data.

Weights are seeded numpy arrays handed to both packages
(``test_torch_model.numpy_params`` -> ``bridge.params_from_numpy``); the
optimizer state crosses through ``bridge.opt_state_from_numpy``; batches
come from each package's ``SyntheticDataset`` (which must agree exactly).
The reference runs its jnp paths (``attn_impl="naive"``): it has no
backward for its Pallas kernels.  The port runs both its plain path and
its kernel path, whose ``torch.autograd.Function``s take the kernels'
plain forward and backward on the CPU.

Tolerances (reduced configs, head_dim 64, 2 layers, seq 48):
- loss: rtol 1e-5 in fp32 (both sides sum the same fp32 terms in another
  order; measured below 2e-7);
- every gradient leaf: max |port - reference| <= 1e-4 * max |reference|
  in fp32 (measured below 2e-6), 4e-2 in bf16 (both sides round every
  op's output to bf16, at different places in the kernel path);
- ``apply_updates``: params, m, v, grad_norm and lr at rtol 1e-5, the
  tolerance of ``tests/test_train.py``'s AdamW check;
- ``make_train_step``: metrics at rtol 1e-5.  Params at atol 2e-5: Adam's
  step is lr * m / (sqrt(v) + eps), so a gradient agreeing to 2e-6 of its
  size moves each param by the same amount on both sides, and what is left
  is the fp32 rounding of p - lr * delta (|p| <= ~0.5, one ulp 6e-8) over 3
  steps, well inside 2e-5.  That argument fails for an element whose
  gradient is itself near zero (|g| <= 1e-4 max|g| of its leaf, inside the
  gradients' own agreement): m / sqrt(v) normalises away its size, so the
  two sides' last-digit differences become different steps of up to lr
  each.  Such elements are held to Adam's own bound instead, lr a step,
  and those past 2e-5 are counted and must stay under 0.1% of the params
  (measured: 6 of 164,160 after steps 1 and 3, uniform and weighted);
  every other element stays at 2e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import model as jm
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.checkpoint import _flatten, _unflatten
from repro_torch import bridge
from repro_torch.models import model as tm
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_model import configs, numpy_params

GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
SEQ = 48


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(jcfg, tcfg, seed):
    flat = numpy_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype),
                      _unflatten(jm.decls(jcfg), flat))
    return jp, bridge.params_from_numpy(tcfg, flat, device="cpu")


def _batch(vocab, seed, shape=(2, SEQ)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., :5] = jm.IGNORE_LABEL          # masked positions count too
    return {"tokens": toks, "labels": labels}


def _close_grads(got, want, dtype, what=""):
    """Every leaf of ``got`` (flat port grads) against ``want`` (flat
    reference grads) at GRAD_TOL * max |want|."""
    assert set(got) == set(want)
    for k in sorted(want):
        w = np.asarray(want[k], np.float32)
        err = np.abs(_np(got[k]) - w).max()
        bound = GRAD_TOL[dtype] * np.abs(w).max()
        assert err <= bound, f"{what} grad {k}: {err:.3e} > {bound:.3e}"


def _port_grads(tcfg, tp, batch):
    leaves = topt.tree_leaves(tp)
    for _, p in leaves:
        p.requires_grad_()
    loss, metrics = tm.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return (loss.detach(), metrics,
            {k: g for (k, _), g in zip(leaves, grads)})


@functools.lru_cache(maxsize=None)
def _reference(arch, remat, chunk, dtype, seed):
    """(loss, metrics, flat grads) of the reference's jnp path."""
    jcfg, _ = configs(arch, dtype, remat=remat, logits_chunk=chunk,
                      attn_impl="naive")
    flat = numpy_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype),
                      _unflatten(jm.decls(jcfg), flat))
    batch = {k: jnp.asarray(v) for k, v in
             _batch(jcfg.vocab_size, seed).items()}
    (loss, metrics), g = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, batch), has_aux=True)(jp)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            _flatten(jax.tree.map(lambda a: a.astype(jnp.float32), g)))


# --- data --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m", "internvl2_26b",
                                  "whisper_tiny"])
def test_synthetic_dataset_gives_the_reference_batches(arch):
    jcfg, tcfg = configs(arch)
    for dc in (jdata.DataConfig(seq_len=32, global_batch=4,
                                num_microbatches=2, seed=3),
               jdata.DataConfig(seq_len=17, global_batch=3, seed=0)):
        want = jdata.SyntheticDataset(jcfg, dc)
        got = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
            **dataclasses.asdict(dc)))
        for step in (0, 5):
            wb, gb = want.batch(step), got.batch(step)
            assert sorted(wb) == sorted(gb)
            for k in wb:
                assert gb[k].dtype == wb[k].dtype
                np.testing.assert_array_equal(gb[k], wb[k])


# --- loss ---------------------------------------------------------------------------

def test_masked_ce_sums_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 11, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 11)).astype(np.int32)
    labels[0, :4] = labels[2, 7:] = jm.IGNORE_LABEL
    logits[1, 3, labels[1, 3]] = 9.0          # one sure hit for accuracy
    want = jm.masked_ce_sums(jnp.asarray(logits), jnp.asarray(labels))
    got = tm.masked_ce_sums(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_loss_fn_and_grads_match_reference(remat, chunk, impl):
    """Reduced smollm, fp32: the port's loss and every gradient leaf (plain
    path, and kernel path through the autograd Functions) against
    ``jax.value_and_grad`` of the reference's loss at the same remat."""
    wl, wm, wg = _reference("smollm_360m", remat, chunk, "float32", 1)
    _, tcfg = configs("smollm_360m", remat=remat, logits_chunk=chunk,
                      attn_impl=impl)
    _, tp = _params(*configs("smollm_360m"), seed=1)
    loss, metrics, grads = _port_grads(tcfg, tp, _batch(tcfg.vocab_size, 1))
    np.testing.assert_allclose(float(loss), wl, rtol=1e-5)
    assert int(metrics["tokens"]) == wm["tokens"]
    np.testing.assert_allclose(float(metrics["accuracy"]), wm["accuracy"],
                               rtol=1e-6)
    _close_grads(grads, wg, "float32", f"{remat}/{chunk}/{impl}")


@pytest.mark.parametrize("chunk,remat", [(0, "full"), (16, "dots")])
def test_loss_grads_with_the_qkv_bias_match_reference(chunk, remat):
    """Reduced qwen1.5 (qkv bias, MHA) on the kernel path."""
    wl, _, wg = _reference("qwen1_5_0_5b", remat, chunk, "float32", 2)
    _, tcfg = configs("qwen1_5_0_5b", remat=remat, logits_chunk=chunk,
                      attn_impl="kernel")
    _, tp = _params(*configs("qwen1_5_0_5b"), seed=2)
    loss, _, grads = _port_grads(tcfg, tp, _batch(tcfg.vocab_size, 2))
    np.testing.assert_allclose(float(loss), wl, rtol=1e-5)
    assert "layers/bq" in grads
    _close_grads(grads, wg, "float32", f"qwen {remat}/{chunk}")


def test_loss_grads_bf16_match_reference():
    """bf16 weights and activations, kernel path, full remat: loss and
    gradients at 4e-2 (loss: rtol 1e-2, a few bf16 ulps of the logits)."""
    wl, _, wg = _reference("smollm_360m", "full", 0, "bfloat16", 3)
    jcfg, tcfg = configs("smollm_360m", "bfloat16", remat="full",
                         attn_impl="kernel")
    _, tp = _params(jcfg, tcfg, seed=3)
    loss, _, grads = _port_grads(tcfg, tp, _batch(tcfg.vocab_size, 3))
    assert grads["layers/wq"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss), wl, rtol=1e-2)
    _close_grads(grads, wg, "bfloat16", "bf16")


def test_block_remat_checkpoints_the_chunked_attention():
    """``attn_block_remat`` with the chunked path: same loss and gradients
    as without (checkpointing recomputes, it does not change values)."""
    _, tcfg = configs("smollm_360m", attn_impl="chunked")
    _, tp = _params(*configs("smollm_360m"), seed=4)
    batch = _batch(tcfg.vocab_size, 4)
    l0, _, g0 = _port_grads(tcfg, tp, batch)
    l1, _, g1 = _port_grads(dataclasses.replace(tcfg, attn_block_remat=True),
                            tp, batch)
    assert float(l0) == float(l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)


def _checkpoint_spies(monkeypatch, force_preserve):
    """Route the model's three checkpoint sites (layer remat, the chunked
    loss, ``block_remat``) through a spy that records each call's
    ``preserve_rng_state``; ``force_preserve`` sets it to True, the
    default of ``torch.utils.checkpoint``, before the call."""
    from repro_torch.models import layers, model, transformer
    real = torch.utils.checkpoint.checkpoint
    seen = []

    def spy(fn, *args, **kwargs):
        seen.append(kwargs.get("preserve_rng_state", True))
        if force_preserve:
            kwargs["preserve_rng_state"] = True
        return real(fn, *args, **kwargs)
    for mod in (layers, model, transformer):
        monkeypatch.setattr(mod, "checkpoint", spy)
    return seen


@pytest.mark.parametrize("remat,chunk,block_remat", [
    ("none", 0, False), ("full", 0, False), ("dots", 0, False),
    ("none", 16, False), ("full", 16, False), ("dots", 16, False),
    ("full", 0, True)])
def test_checkpoints_keep_no_rng_state(monkeypatch, remat, chunk,
                                       block_remat):
    """Every checkpoint passes ``preserve_rng_state=False`` (no op of the
    model draws random numbers, and a CUDA graph capture may refuse the
    generator's state being read), and loss and every gradient leaf are
    bit for bit what the default (True) gives."""
    _, tcfg = configs("smollm_360m", remat=remat, logits_chunk=chunk,
                      attn_impl="chunked" if block_remat else "kernel",
                      attn_block_remat=block_remat)
    _, tp = _params(*configs("smollm_360m"), seed=11)
    batch = _batch(tcfg.vocab_size, 11)
    seen = _checkpoint_spies(monkeypatch, force_preserve=False)
    loss, _, grads = _port_grads(tcfg, tp, batch)
    assert not any(seen)
    assert bool(seen) == (remat != "none" or chunk > 0 or block_remat)
    _checkpoint_spies(monkeypatch, force_preserve=True)
    want_loss, _, want = _port_grads(tcfg, tp, batch)
    assert torch.equal(loss, want_loss)
    for k in want:
        assert torch.equal(grads[k], want[k]), k


# --- loss_and_grads --------------------------------------------------------------

@pytest.mark.parametrize("weights", [None, (0.7, 0.3)])
def test_loss_and_grads_match_reference(weights):
    jcfg, tcfg = configs("smollm_360m", remat="full", attn_impl="naive")
    tcfg = dataclasses.replace(tcfg, attn_impl="kernel")
    jp, tp = _params(jcfg, tcfg, seed=5)
    batch = _batch(jcfg.vocab_size, 5, shape=(2, 2, 32))
    wl, wg = jts.loss_and_grads(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, None,
                                micro_weights=weights)
    gl, gg = tts.loss_and_grads(tcfg, tp, batch, micro_weights=weights)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    got = dict(topt.tree_leaves(gg))
    assert all(g.dtype == torch.float32 for g in got.values())
    _close_grads(got, _flatten(wg), "float32", f"weights={weights}")


def test_loss_and_grads_refuse_bad_weights_and_a_mesh():
    jcfg, tcfg = configs("smollm_360m")
    jp, tp = _params(jcfg, tcfg, seed=6)
    batch = _batch(jcfg.vocab_size, 6, shape=(2, 1, 8))
    with pytest.raises(ValueError, match="micro_weights"):
        jts.loss_and_grads(jcfg, jp, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, None,
                           micro_weights=(1.0,))
    with pytest.raises(ValueError, match="micro_weights"):
        tts.loss_and_grads(tcfg, tp, batch, micro_weights=(1.0,))
    # a mesh must be a dist.mesh.Mesh (the sharded step: test_torch_mesh.py)
    with pytest.raises(TypeError, match="Mesh"):
        tts.loss_and_grads(tcfg, tp, batch, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tts.make_train_step(tcfg, topt.OptimizerConfig(), mesh=object())


# --- optimizer ----------------------------------------------------------------------

def _opt_inputs(seed, scale):
    """Flat params, grads and a one-step-old AdamW state of a reduced
    model, as numpy."""
    jcfg, _ = configs("smollm_360m")
    rng = np.random.default_rng(seed)
    params = numpy_params(jcfg, seed)
    grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    state = {"step": np.asarray(1, np.int32)}
    for k, v in params.items():
        state[f"m/{k}"] = (0.01 * rng.standard_normal(v.shape)).astype(
            np.float32)
        state[f"v/{k}"] = (1e-4 * rng.random(v.shape)).astype(np.float32)
    return jcfg, params, grads, state


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_matches_reference(schedule, clip):
    """Same numpy params, grads and state: params, m, v, grad_norm and lr
    at rtol 1e-5.  Gradients of norm ~40 are clipped at 1.0."""
    jcfg, params, grads, state = _opt_inputs(7, 0.5)
    _, tcfg = configs("smollm_360m")
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip,
               schedule=schedule)
    jp = _unflatten(jm.decls(jcfg), {k: jnp.asarray(v) for k, v in
                                     params.items()})
    jg = _unflatten(jm.decls(jcfg), {k: jnp.asarray(v) for k, v in
                                     grads.items()})
    js = {"m": _unflatten(jm.decls(jcfg), {k[2:]: jnp.asarray(v) for k, v in
                                           state.items() if k[:2] == "m/"}),
          "v": _unflatten(jm.decls(jcfg), {k[2:]: jnp.asarray(v) for k, v in
                                           state.items() if k[:2] == "v/"}),
          "step": jnp.asarray(state["step"])}
    wp, ws, wm = jopt.apply_updates(jp, jg, js, jopt.OptimizerConfig(**cfg))
    tp = bridge.params_from_numpy(tcfg, params, device="cpu")
    tg = bridge.params_from_numpy(tcfg, grads, device="cpu")
    ts = bridge.opt_state_from_numpy(tcfg, state, device="cpu")
    gp, gs, gm = topt.apply_updates(tp, tg, ts, topt.OptimizerConfig(**cfg))
    if clip:
        assert float(wm["grad_norm"]) > 10 * clip   # clipping is active
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-5)
    want = _flatten({"p": wp, "m": ws["m"], "v": ws["v"]})
    got = {**{f"p/{k}": v for k, v in bridge.params_to_numpy(gp).items()},
           **bridge.opt_state_to_numpy(gs, prefix="")}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(gs["step"]) == int(ws["step"]) == 2


def test_apply_updates_is_in_place():
    """The port writes the update into the tensors it was given and returns
    the same objects (a deliberate divergence from the reference's new
    arrays)."""
    _, params, grads, state = _opt_inputs(8, 0.1)
    _, tcfg = configs("smollm_360m")
    tp = bridge.params_from_numpy(tcfg, params, device="cpu")
    tg = bridge.params_from_numpy(tcfg, grads, device="cpu")
    ts = bridge.opt_state_from_numpy(tcfg, state, device="cpu")
    ptrs = {k: p.data_ptr() for k, p in topt.tree_leaves(tp)}
    m_ptr = ts["m"]["embed"].data_ptr()
    before = tp["embed"].clone()
    gp, gs, _ = topt.apply_updates(tp, tg, ts, topt.OptimizerConfig())
    assert gp is tp and gs is ts
    assert {k: p.data_ptr() for k, p in topt.tree_leaves(gp)} == ptrs
    assert gs["m"]["embed"].data_ptr() == m_ptr
    assert not torch.equal(tp["embed"], before)      # moved in place
    assert gs["step"].dtype == torch.int32 and int(gs["step"]) == 2


def test_lr_schedule_matches_reference():
    for schedule in ("cosine", "constant"):
        cfg = dict(lr=1.0, warmup_steps=10, total_steps=110,
                   schedule=schedule)
        for step in (0, 1, 5, 10, 11, 60, 110, 200):
            want = float(jopt.lr_at(jopt.OptimizerConfig(**cfg),
                                    jnp.asarray(step)))
            got = float(topt.lr_at(topt.OptimizerConfig(**cfg),
                                   torch.tensor(step)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --- bridge: optimizer state ---------------------------------------------------

def test_opt_state_crosses_both_ways():
    """The reference's ``init_state`` and its state after one step load into
    the port and come back with the same keys and values."""
    jcfg, tcfg = configs("smollm_360m")
    jp, _ = _params(jcfg, tcfg, seed=9)
    js = jopt.init_state(jp)
    g = jax.tree.map(lambda p: 0.1 * jnp.ones_like(p), jp)
    _, js1, _ = jopt.apply_updates(jp, g, js, jopt.OptimizerConfig())
    for state in (js, js1):
        flat = _flatten(state)
        ts = bridge.opt_state_from_numpy(tcfg, flat, device="cpu")
        assert ts["m"]["layers"]["wq"].dtype == torch.float32
        assert ts["step"].shape == () and ts["step"].dtype == torch.int32
        back = bridge.opt_state_to_numpy(ts)
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], np.asarray(flat[k]))
            assert back[k].dtype == np.asarray(flat[k]).dtype
    ts0 = topt.init_state(bridge.params_from_numpy(
        tcfg, numpy_params(jcfg, 9), device="cpu"))
    assert sorted(bridge.opt_state_to_numpy(ts0)) == sorted(_flatten(js))
    bad = dict(_flatten(js))
    del bad["v/embed"]
    with pytest.raises(KeyError, match="v/embed"):
        bridge.opt_state_from_numpy(tcfg, bad, device="cpu")


# --- make_train_step -----------------------------------------------------------

def _close_params(got, want, near_zero, adam_bound, what):
    """Params at atol 2e-5, but for the elements of ``near_zero`` (see the
    module docstring), which are held to ``adam_bound``; returns how many
    of those were past 2e-5."""
    past = 0
    for k, w in want.items():
        diff = np.abs(_np(got[k]) - np.asarray(w, np.float32))
        tight = diff[~near_zero[k]]
        assert tight.size == 0 or tight.max() <= 2e-5, (
            f"{what} {k}: {int((tight > 2e-5).sum())} params with a "
            f"gradient off near zero differ by up to {tight.max():.3e}")
        loose = diff[near_zero[k]]
        assert loose.size == 0 or loose.max() <= adam_bound, (
            f"{what} {k}: near-zero-gradient params differ by "
            f"{loose.max():.3e} > {adam_bound}")
        past += int((loose > 2e-5).sum())
    return past


def _three_steps_against_reference(weights, device_body):
    """1 and 3 steps on identical ``SyntheticDataset`` batches, from the
    same weights and a fresh state; the kernel path (autograd Functions)
    against the reference's jnp path.  ``device_body``: the port's step is
    ``train_step_on_device`` fed batches already on the device (the CPU),
    and a second copy of the weights takes ``make_train_step``'s steps
    beside it, which must agree bit for bit."""
    jcfg, tcfg = configs("smollm_360m", remat="full", attn_impl="naive")
    tcfg = dataclasses.replace(tcfg, attn_impl="kernel")
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    dc = dict(seq_len=32, global_batch=4, num_microbatches=2, seed=1)
    jds = jdata.SyntheticDataset(jcfg, jdata.DataConfig(**dc))
    tds = tdata.SyntheticDataset(tcfg, tdata.DataConfig(**dc))
    jp, tp = _params(jcfg, tcfg, seed=10)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptimizerConfig(**ocfg),
                                        micro_weights=weights))
    tstep = tts.make_train_step(tcfg, topt.OptimizerConfig(**ocfg),
                                micro_weights=weights)
    if device_body:
        ep = _params(jcfg, tcfg, seed=10)[1]
        es = topt.init_state(ep)
        w = None if weights is None else torch.tensor(weights)
    near_zero = {k: np.zeros(p.shape, bool)
                 for k, p in topt.tree_leaves(tp)}
    past = []
    for step in range(3):
        jb, tb = jds.batch(step), tds.batch(step)
        _, grads = tts.loss_and_grads(tcfg, tp, tb, micro_weights=weights)
        for k, g in topt.tree_leaves(grads):
            near_zero[k] |= (g.abs() <= 1e-4 * g.abs().max()).numpy()
        jp, js, jm_ = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                     jb.items()})
        if device_body:
            db = {k: torch.from_numpy(v) for k, v in tb.items()}
            tp2, ts2, tm_ = tts.train_step_on_device(
                tcfg, topt.OptimizerConfig(**ocfg), tp, ts, db, w)
            _, _, em = tstep(ep, es, tb)
            for key in ("loss", "grad_norm", "lr"):
                assert torch.equal(tm_[key], em[key]), f"{key} @ {step}"
            for (k, p), (_, e) in zip(topt.tree_leaves(tp),
                                      topt.tree_leaves(ep)):
                assert torch.equal(p, e), f"{k} @ {step}"
            assert torch.equal(ts["step"], es["step"])
        else:
            tp2, ts2, tm_ = tstep(tp, ts, tb)
        assert tp2 is tp and ts2 is ts
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, err_msg=f"{key} @ {step}")
        if step in (0, 2):
            past.append(_close_params(
                bridge.params_to_numpy(tp), _flatten(jp), near_zero,
                ocfg["lr"] * (step + 1), f"step {step + 1}"))
    assert int(ts["step"]) == int(js["step"]) == 3
    total = sum(m.size for m in near_zero.values())
    assert sum(past) <= 1e-3 * total, (
        f"{sum(past)} of {total} params past 2e-5 (near-zero gradients)")


@pytest.mark.parametrize("weights", [None, (0.25, 0.75)])
def test_make_train_step_matches_reference(weights):
    _three_steps_against_reference(weights, device_body=False)


@pytest.mark.parametrize("weights", [None, (0.25, 0.75)])
def test_device_body_matches_make_train_step_and_reference(weights):
    """The step's device body (what ``make_graphed_train_step`` captures),
    fed tensors already on the device, gives ``make_train_step``'s results
    bit for bit over 3 steps, and the reference's at its tolerances."""
    _three_steps_against_reference(weights, device_body=True)


# --- the device body under a host-sync guard; the graphed step ------------------

_aten = torch.ops.aten


class _HostSyncGuard(TorchDispatchMode):
    """Raises on what a CUDA graph capture cannot hold: a tensor's value
    read on the host (``aten._local_scalar_dense``: ``.item()``,
    ``int(t)``, ``bool(t)``), an op whose output size depends on values
    (``nonzero``, ``masked_select``, indexing by a boolean mask) and a
    copy to the CPU from another device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket
        masks = op in (_aten.index, _aten.index_put, _aten.index_put_) and \
            any(i is not None and i.dtype in (torch.bool, torch.uint8)
                for i in args[1])
        if masks or op in (_aten._local_scalar_dense, _aten.nonzero,
                           _aten.masked_select):
            raise AssertionError(f"host sync in the device body: {func}")
        if op is _aten._to_copy:
            src = args[0].device
            dst = torch.device(kwargs.get("device") or src)
        elif op is _aten.copy_:
            dst, src = args[0].device, args[1].device
        else:
            src = dst = None
        if dst is not None and dst.type == "cpu" and src.type != "cpu":
            raise AssertionError(f"copy to the CPU in the device body: "
                                 f"{func} from {src}")
        return func(*args, **kwargs)


def test_host_sync_guard_refuses_what_a_capture_cannot_hold():
    t = torch.arange(4.0)
    for bad in (lambda: t.sum().item(), lambda: bool(t[0]),
                lambda: torch.nonzero(t), lambda: t[t > 1],
                lambda: torch.empty(2, device="meta").cpu()):
        with _HostSyncGuard(), pytest.raises(AssertionError):
            bad()


@pytest.mark.parametrize("remat,chunk,weights", [
    ("full", 0, None), ("dots", 16, (0.25, 0.75))])
def test_device_body_makes_no_host_sync(remat, chunk, weights):
    """One step of ``train_step_on_device`` (kernel path, the plain
    kernels' autograd Functions on the CPU) under ``_HostSyncGuard``: what
    the graph capture needs on the card, checked here."""
    _, tcfg = configs("smollm_360m", remat=remat, logits_chunk=chunk,
                      attn_impl="kernel")
    _, tp = _params(*configs("smollm_360m"), seed=12)
    state = topt.init_state(tp)
    batch = tdata.SyntheticDataset(tcfg, tdata.DataConfig(
        seq_len=32, global_batch=4, num_microbatches=2)).batch(0)
    db, w = tts.device_inputs(tcfg, tp, batch, weights)
    before = {k: p.clone() for k, p in topt.tree_leaves(tp)}
    with _HostSyncGuard():
        _, _, metrics = tts.train_step_on_device(
            tcfg, topt.OptimizerConfig(), tp, state, db, w)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
    assert not torch.equal(tp["embed"], before["embed"])


def test_graphed_train_step_refuses_cpu_params():
    _, tcfg = configs("smollm_360m")
    _, tp = _params(*configs("smollm_360m"), seed=13)
    batch = _batch(tcfg.vocab_size, 13, shape=(2, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tts.make_graphed_train_step(tcfg, topt.OptimizerConfig(), tp,
                                    topt.init_state(tp), batch)
