"""``repro_torch`` model vs ``repro`` model on the same weights and tokens.

Weights are drawn once from a seeded numpy generator (norm scales and
biases too, so a dropped scale or bias shows) and handed to both packages:
to JAX as a params pytree, to the port through ``bridge.params_from_numpy``.
The comparisons set head_dim 64 (the reduced configs' own 16 is covered
by ``test_forward_kernel_at_small_head_dims``); ``attn_impl="pallas"`` in
the reference and ``"kernel"`` in the port run the kernel algorithm on
both sides.

Tolerances: fp32 logits and caches agree to 2e-5 absolute (both sides
compute fp32 expressions that differ only in summation order; measured
5e-7 on logits of std 0.16).  bf16 is stated where it is used.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist.sharding import Decl as JDecl
from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.train.checkpoint import _unflatten
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, PAPER_IDS
from repro_torch.configs import get_config as tget
from repro_torch.dist.sharding import iter_decls
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 2e-5


def configs(arch, dtype="float32", **kw):
    """Reduced config of ``arch`` in both packages (head_dim 64)."""
    over = dict(head_dim=64, dtype=dtype, param_dtype=dtype, **kw)
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def numpy_params(jcfg, seed):
    """Seeded numpy weights for every declared tensor, keyed by the
    "/"-joined paths the reference's checkpoints use."""
    rng = np.random.default_rng(seed)
    flat = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        jm.decls(jcfg), is_leaf=lambda x: isinstance(x, JDecl))[0]
    for path, d in leaves:
        key = "/".join(str(p.key) for p in path)
        if d.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.standard_normal(d.shape)
        else:
            std = 0.02 if d.scale_dim is None else d.shape[d.scale_dim] ** -0.5
            a = std * rng.standard_normal(d.shape)
        flat[key] = a.astype(np.float32)
    return flat


def both_params(jcfg, tcfg, seed):
    flat = numpy_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype),
                      _unflatten(jm.decls(jcfg), flat))
    return jp, bridge.params_from_numpy(tcfg, flat, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# --- configs, declarations, init ------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS + PAPER_IDS)
def test_configs_are_the_reference_configs(arch):
    j, t = jget(arch), tget(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.total_params() == t.total_params() and j.hd == t.hd


def test_unported_archs_raise():
    """Every config of the catalog builds: its family's module resolves and
    its declarations count ``total_params()``; an unknown family still
    raises where the model is built, and so does an unknown arch."""
    for arch in ARCH_IDS + PAPER_IDS:
        cfg = tget(arch)
        assert tm.get_module(cfg) is not None, arch
        assert sum(int(np.prod(d.shape))
                   for _, d in iter_decls(tm.decls(cfg))) == \
            jm.param_count(jget(arch)), arch
    with pytest.raises(KeyError):
        tget("no_such_arch")
    with pytest.raises(NotImplementedError, match="unknown model family"):
        tm.get_module(dataclasses.replace(tget("smollm_360m"),
                                          family="audio"))
    with pytest.raises(NotImplementedError, match="unknown model family"):
        tm.init(dataclasses.replace(tget("smollm_360m").reduced(),
                                    family="audio"), 0, device="cpu")


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_0_5b",
                                  "granite_20b", "minitron_8b"])
def test_decls_match_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    want = {"/".join(str(p.key) for p in path): (d.shape, d.init, d.scale_dim)
            for path, d in jax.tree_util.tree_flatten_with_path(
                jm.decls(jcfg), is_leaf=lambda x: isinstance(x, JDecl))[0]}
    got = {p: (d.shape, d.init, d.scale_dim)
           for p, d in iter_decls(tm.decls(tcfg))}
    assert got == want
    assert sum(int(np.prod(s)) for s, _, _ in got.values()) \
        == tcfg.total_params()


def test_init_is_seeded_with_the_reference_recipes():
    cfg = dataclasses.replace(tget("qwen1_5_0_5b").reduced(), d_model=256)
    a = tm.init(cfg, 3, device="cpu")
    b = tm.init(cfg, 3, device="cpu")
    c = tm.init(cfg, 4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert torch.all(a["layers"]["ln1"] == 1) and torch.all(a["ln_f"] == 1)
    assert torch.all(a["layers"]["bq"] == 0)
    # "scaled": std = fan_in ** -0.5 (scale_dim), "embed": 0.02
    assert abs(a["layers"]["wq"].std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(a["layers"]["w_down"].std().item() - 128 ** -0.5) \
        < 0.1 * 128 ** -0.5
    assert abs(a["embed"].std().item() - 0.02) < 0.002
    assert a["embed"].dtype == torch.float32


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    """Without a card and without device=..., entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("smollm_360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(cfg, 0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_numpy(cfg, {})
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm_360m", "--reduced"])


def test_bridge_round_trip_and_errors():
    jcfg, tcfg = configs("qwen1_5_0_5b")
    flat = numpy_params(jcfg, 0)
    params = bridge.params_from_numpy(tcfg, flat, device="cpu")
    back = bridge.params_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    bf = dataclasses.replace(tcfg, dtype="bfloat16", param_dtype="bfloat16")
    pb = bridge.params_from_numpy(bf, flat, device="cpu")
    again = bridge.params_from_numpy(bf, bridge.params_to_numpy(pb),
                                     device="cpu")
    assert torch.equal(pb["layers"]["wq"], again["layers"]["wq"])
    jbf = jnp.asarray(flat["embed"], jnp.bfloat16)      # ml_dtypes bfloat16
    got = bridge.params_from_numpy(
        bf, {**flat, "embed": np.asarray(jbf)}, device="cpu")["embed"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jbf.astype(jnp.float32)))
    with pytest.raises(KeyError):
        bridge.params_from_numpy(tcfg, {k: v for k, v in flat.items()
                                        if k != "layers/bq"}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(tcfg, {**flat, "ln_f": flat["ln_f"][:3]},
                                 device="cpu")


def test_reference_checkpoint_loads_and_scores_alike():
    """The reference's own state.npz (reduced smollm, trained by
    examples/elastic_reconfig.py) loads through the bridge and the port
    scores tokens as the reference does with the restored params."""
    z = np.load(os.path.join(ROOT, "artifacts/elastic_demo/step-32/state.npz"))
    flat = {k: z[k] for k in z.files}
    jcfg, tcfg = jget("smollm_360m").reduced(), tget("smollm_360m").reduced()
    tp = bridge.params_from_numpy(tcfg, flat, device="cpu", prefix="params/")
    jp = jax.tree.map(jnp.asarray, _unflatten(
        jm.decls(jcfg), {k[len("params/"):]: v for k, v in flat.items()
                         if k.startswith("params/")}))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 24))
    want = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


# --- forward / prefill -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_0_5b"])
@pytest.mark.parametrize("impl_j,impl_t", [("naive", "naive"),
                                           ("pallas", "kernel")])
def test_forward_matches_reference(arch, impl_j, impl_t):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=1)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 37))
    wl, wc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True, attn_impl=impl_j)
    gl, gc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        return_cache=True, attn_impl=impl_t)
    assert gl.shape == wl.shape and gl.dtype == torch.float32
    np.testing.assert_allclose(_np(gl), _np(wl), rtol=0, atol=F32_ATOL)
    for name in ("k", "v"):
        assert gc[name].shape == wc[name].shape
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), rtol=0,
                                   atol=F32_ATOL)
    assert gc["len"] == int(wc["len"])


@pytest.mark.parametrize("head_dim", [16, 32])
def test_forward_kernel_at_small_head_dims(head_dim):
    """The reduced configs' own head_dim 16, and 32: ``attn_impl="kernel"``
    matches the reference's ``"pallas"`` (interpret mode) at fp32 2e-5."""
    jcfg, tcfg = configs("smollm_360m")
    jcfg, tcfg = (dataclasses.replace(c, head_dim=head_dim)
                  for c in (jcfg, tcfg))
    jp, tp = both_params(jcfg, tcfg, seed=7)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 29))
    want = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                      attn_impl="pallas")
    got = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                     attn_impl="kernel")
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


def test_forward_gelu_family_matches_reference():
    """Non-gated FFN (gelu, tanh form as jax.nn.gelu) on the naive path."""
    jcfg, tcfg = configs("opt_350m")
    jp, tp = both_params(jcfg, tcfg, seed=4)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 20))
    want = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)


def test_forward_bf16_matches_reference():
    """bf16 weights and activations, kernel path.  Both sides round to bf16
    after every op, but XLA fuses some elementwise chains that PyTorch
    rounds step by step, so logits (std ~0.16 here) may differ by a bf16
    ulp or two: measured 3.9e-3 (one ulp at |x| in [0.5, 1)), held to 1e-2."""
    jcfg, tcfg = configs("smollm_360m", dtype="bfloat16")
    jp, tp = both_params(jcfg, tcfg, seed=5)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 33))
    wl, wc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        return_cache=True, attn_impl="pallas")
    gl, gc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        return_cache=True, attn_impl="kernel")
    assert gc["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(gl), _np(wl), rtol=0, atol=1e-2)
    np.testing.assert_allclose(_np(gc["k"]), _np(wc["k"]), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("tokens", ["zeros", "skewed"])
def test_embed_gradient_sums_repeated_tokens(tokens):
    """The lookup (``F.embedding``): the reference's gather forward, and a
    gradient that sums every repeat of a token into its row, as the
    reference's ``jax.grad`` of ``embed[tokens]`` does (fp32, 1e-5 of max
    |g|; all zeros, and a few tokens repeated many times)."""
    from repro_torch.models import transformer as tt
    jcfg, tcfg = configs("smollm_360m")
    jp, tp = both_params(jcfg, tcfg, seed=7)
    rng = np.random.default_rng(7)
    toks = (np.zeros((2, 48), np.int32) if tokens == "zeros"
            else rng.integers(0, 4, (2, 48)).astype(np.int32))
    go = rng.standard_normal((2, 48, jcfg.d_model)).astype(np.float32)
    e = tp["embed"].detach().requires_grad_()
    x = tt.embed(tcfg, {"embed": e}, torch.from_numpy(toks))
    assert torch.equal(x, tp["embed"][torch.from_numpy(toks)])
    (got,) = torch.autograd.grad(x, e, torch.from_numpy(go))
    want = np.asarray(jax.grad(lambda w: jnp.sum(
        w[jnp.asarray(toks)] * jnp.asarray(go)))(jp["embed"]))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# --- decode ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_0_5b"])
def test_decode_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9))
    _, jc = jm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       return_cache=True)
    _, tc = tm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                       return_cache=True)
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, 2, 16))
    tc = tkv.grow_cache(tc, tm.init_cache(tcfg, 2, 16, device="cpu"))
    for _ in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        wl, jc = jm.decode(jcfg, jp, jc, jnp.asarray(nxt))
        gl, tc = tm.decode(tcfg, tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(gl), _np(wl), rtol=0, atol=F32_ATOL)
    assert tc["len"] == int(jc["len"]) == 13
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=F32_ATOL)


def test_decode_past_the_cache_raises():
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 0, device="cpu")
    cache = tm.init_cache(cfg, 1, 4, start_len=4, device="cpu")
    with pytest.raises(IndexError):
        tm.decode(cfg, params, cache, torch.zeros(1, 1, dtype=torch.long))
    # a tensor length reads nothing on the host: the callers keep their
    # positions inside the cache (the servers check before they decode)
    cache["len"] = torch.tensor([1])          # per row
    _, out = tm.decode(cfg, params, cache,
                       torch.zeros(1, 1, dtype=torch.long))
    assert out["len"].tolist() == [2]
    cache["len"] = torch.tensor(2)            # a 0-d length is a scalar
    _, out = tm.decode(cfg, params, cache,
                       torch.zeros(1, 1, dtype=torch.long))
    assert out["len"] == 3


# --- the port stands alone ---------------------------------------------------------

_GUARD = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
assert not bad, bad
missing = [n for n in {planner!r} if n not in sys.modules]
assert not missing, missing
print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""


# the planner and simulator copies, which the walk must reach too (the
# reference's planner directory has no __init__.py; the port's has one)
_PLANNER = ["repro_torch.core.cluster"] + [
    f"repro_torch.core.planner.{m}" for m in
    ("plan", "objectives", "heuristics", "dp_solver", "search", "serving")
] + [f"repro_torch.core.simulator.{m}" for m in
     ("engine", "memory", "timing", "cost", "simulate", "serving")] + [
    "repro_torch.serve.paged_cache", "repro_torch.core.profiler.measured",
    # the mesh (its rules in dist.sharding, reached anyway)
    "repro_torch.dist.mesh", "repro_torch.dist.placement",
    "repro_torch.dist.spmd", "repro_torch.launch.mesh",
    # the runtime that trains the plans
    "repro_torch.train.checkpoint", "repro_torch.train.elastic",
    "repro_torch.launch.train"] + [
    # the control plane that drives it
    f"repro_torch.manager.{m}" for m in
    ("events", "monitor", "transition", "replan", "controller", "autoscale")
] + [f"repro_torch.telemetry.{m}" for m in
     ("bus", "detectors", "rca", "faults")] + [
    "repro_torch.manager", "repro_torch.telemetry",
    # the MoE family and the autotuner's bench
    "repro_torch.models.moe", "repro_torch.bench.kernels_bench"] + [
    # the dry run and the collective record's analysis
    f"repro_torch.launch.{m}" for m in
    ("shapes", "comm", "program_cost", "dryrun")] + [
    f"repro_torch.analysis.{m}" for m in
    ("findings", "collectives", "audit", "sharding_lint", "lint", "demo")
] + [
    # serving on a mesh
    "repro_torch.dist.spmd_serve", "repro_torch.dist.spmd_ssm"] + [
    # the user entry points
    f"repro_torch.examples.{m}" for m in
    ("common", "geo_cost_planning", "quickstart", "train_e2e",
     "elastic_reconfig", "serve_batched")]


def test_port_imports_neither_jax_nor_the_reference():
    code = _GUARD.format(src=os.path.join(ROOT, "src"), root=ROOT,
                         planner=_PLANNER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) >= 15
