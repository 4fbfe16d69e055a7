"""Serving on a mesh (``serve_step.make_prefill(cfg, mesh)``,
``make_decode(cfg, mesh)``, ``kv_cache.grow_cache`` on ``Sharded``
leaves; ``dist/spmd_serve.py``, ``dist/spmd_ssm.decode_layer``) on
meshes of CPU positions, reduced configs in fp32.

The reference's ``make_prefill(cfg, mesh)`` fails on jax 0.9.0 (fault R1,
inside ``constrain``), so each mesh run is held against the port's
one-device ``make_prefill`` and ``make_decode`` and the reference's
one-device ones, on the same numpy weights (``bridge``) and prompts: a
prefill, ``grow_cache`` into a larger buffer, then ``STEPS`` greedy decode
steps, each side fed its own greedy tokens, which must be equal.
Tolerance: every logit within 1e-5 of the step's max |logit| (GSPMD does
not change results; the port's mesh sums its parts in another order),
and the caches (K/V, the SSD and conv states) within 1e-5 of their max
|value| of the one-device caches after the prefill and after the last
step.  The reference's one-device steps are run once per config and
kept for every mesh of it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro.serve import kv_cache as jkv
from repro.serve import serve_step as jss
from repro_torch import bridge
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import serve_step as tss
from test_torch_mesh import _mesh
from test_torch_model import both_params, configs, numpy_params

TOL = 1e-5
STEPS = 3
B, S = 4, 12
GROW = 8                # the decode buffer's slots past the prompt


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, over):
    jcfg, tcfg = configs(arch, **dict(over))
    # the reduced configs' own head_dim (16): the mesh splits them finer
    return (dataclasses.replace(jcfg, head_dim=16),
            dataclasses.replace(tcfg, head_dim=16))


def _prompts(cfg, seq):
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size, (B, seq))


def _f(x):
    if isinstance(x, pm.Sharded):
        x = pm.unshard(x, "cpu")
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what):
    got, want = _f(got), _f(want)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _one_device(arch, over, seq):
    """The reference's and the port's one-device runs: per side, the
    logits of the prefill and of each step, the greedy tokens, and the
    port's caches after the prefill and after the last step."""
    jcfg, tcfg = _configs(arch, over)
    jp, tp = both_params(jcfg, tcfg, seed=5)
    toks = _prompts(tcfg, seq)
    jdecode = jax.jit(jss.make_decode(jcfg))
    jl, jc = jax.jit(jss.make_prefill(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, B, seq + GROW))
    with torch.no_grad():
        tl, tc = tss.make_prefill(tcfg)(tp, {"tokens": torch.as_tensor(toks)})
        first = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in tc.items()}
        tc = tkv.grow_cache(tc, tm.init_cache(tcfg, B, seq + GROW,
                                              device="cpu"))
        ref, port, tokens = [np.asarray(jl)], [tl], []
        for _ in range(STEPS):
            nxt = tl.argmax(-1)[:, None]
            assert np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                  nxt[:, 0].numpy())
            tokens.append(nxt)
            jl, jc = jdecode(jp, jc, jnp.asarray(nxt.numpy()))
            tl, tc = tss.make_decode(tcfg)(tp, tc, nxt)
            ref.append(np.asarray(jl))
            port.append(tl)
    return dict(ref=ref, port=port, tokens=tokens, prefill_cache=first,
                cache=tc, toks=toks)


def _run_mesh(arch, shape, policy, over=(), seq=S, length="int"):
    """The mesh's prefill, ``grow_cache`` and ``STEPS`` greedy steps,
    held against ``_one_device``; ``length`` the form of the cache's
    ``len`` during decode (an int, a 0-d or a (B,) tensor)."""
    one = _one_device(arch, over, seq)
    jcfg, tcfg = _configs(arch, over)
    cfg = dataclasses.replace(tcfg, sharding=policy)
    mesh = _mesh(shape)
    params = bridge.sharded_params_from_numpy(cfg, numpy_params(jcfg, 5),
                                              mesh)
    with torch.no_grad():
        logits, cache = tss.make_prefill(cfg, mesh)(
            params, {"tokens": torch.as_tensor(one["toks"])})
        assert cache["len"] == seq
        assert logits.spec[0] == tss.shd.batch_spec(mesh, B)[0]
        specs = tss.cache_specs(cfg, B, seq, mesh)
        for k, x in cache.items():
            if k != "len":
                assert x.spec == specs[k], k
                _close(x, one["prefill_cache"][k], f"prefill cache {k}")
        cache = tkv.grow_cache(cache, tm.init_cache(cfg, B, seq + GROW,
                                                    mesh=mesh))
        if length == "0-d":
            cache["len"] = torch.tensor(seq)
        elif length == "rows":
            cache["len"] = torch.full((B,), seq)
        step = tss.make_decode(cfg, mesh)
        for i in range(STEPS + 1):
            _close(logits, one["port"][i], f"step {i} vs one device")
            _close(logits, one["ref"][i], f"step {i} vs the reference")
            if i == STEPS:
                break
            nxt = pm.unshard(logits, "cpu").argmax(-1)[:, None]
            assert torch.equal(nxt, one["tokens"][i]), i
            logits, cache = step(params, cache, nxt)
    assert int(torch.as_tensor(cache["len"]).reshape(-1)[0]) == seq + STEPS
    for k, x in cache.items():
        if k != "len":
            _close(x, one["cache"][k], f"decode cache {k}")
    return cache


# (arch, mesh, policy, config overrides, prompt length, len form): the
# K/V layout each case exercises is asserted in ``test_cache_layouts``
CASES = [
    # the K/V sequence split: 1 K/V head, query heads replicated (3 on 2)
    ("smollm_360m", (2, 2), "fsdp_tp", (("n_heads", 3), ("n_kv_heads", 1)),
     S, "int"),
    # 2 K/V heads on 4: the sequence split, the query heads split
    ("smollm_360m", (1, 4), "tp", (), S, "0-d"),
    # the K/V head split
    ("qwen1_5_0_5b", (1, 2), "tp", (), S, "int"),
    ("qwen1_5_0_5b", (2, 2, 1), "fsdp_tp", (), S, "int"),
    # the query heads split, the one K/V head's sequence split; per-row len
    ("granite_20b", (1, 4), "tp", (), S, "rows"),
    # a ring past the window (32): the head split, then the sequence split
    ("mixtral_8x22b", (1, 2), "tp", (), 40, "int"),
    ("mixtral_8x22b", (1, 4), "tp", (), 40, "rows"),
    ("dbrx_132b", (2, 2), "fsdp_tp", (), S, "int"),
    ("dbrx_132b", (1, 2), "tp", (("moe_dispatch", "per_seq"),), S, "int"),
    # the SSD heads split (8 on 4), and on 3, which divides none
    ("mamba2_130m", (1, 4), "tp", (), S, "int"),
    ("mamba2_130m", (2, 2), "fsdp_tp", (), S, "0-d"),
    ("mamba2_130m", (1, 3), "tp", (), S, "int"),
    ("zamba2_2_7b", (1, 2), "tp", (), S, "int"),
    ("zamba2_2_7b", (2, 2, 1), "fsdp_tp", (), S, "int"),
]


@pytest.mark.parametrize("arch,shape,policy,over,seq,length", CASES)
def test_prefill_and_decode_match_one_device(arch, shape, policy, over, seq,
                                             length):
    _run_mesh(arch, shape, policy, over, seq, length)


def test_cache_layouts():
    """Which K/V layout each case's decode buffer takes (cache_specs):
    the cases cover the head split, the sequence split (also with the
    query heads split) and the SSD heads split and whole."""
    def specs(arch, shape, over=()):
        cfg = dataclasses.replace(_configs(arch, over)[1], sharding="tp")
        return tss.cache_specs(cfg, B, S + GROW, _mesh(shape))
    assert specs("smollm_360m", (2, 2), (("n_heads", 3), ("n_kv_heads", 1))
                 )["k"] == (None, "data", "model", None, None)
    assert specs("smollm_360m", (1, 4))["k"] == (None, "data", "model", None,
                                                 None)
    assert specs("qwen1_5_0_5b", (1, 2))["k"] == (None, "data", None,
                                                  "model", None)
    assert specs("mamba2_130m", (1, 4))["ssm"] == (None, "data", "model",
                                                   None, None)
    assert specs("mamba2_130m", (1, 3))["ssm"] == (None, "data", None, None,
                                                   None)
    cfg = _configs("smollm_360m", ())[1]
    lay = spmd.layout(dataclasses.replace(cfg, sharding="tp"),
                      bridge.sharded_params_from_numpy(
                          cfg, numpy_params(_configs("smollm_360m", ())[0],
                                            0), _mesh((1, 4))),
                      _mesh((1, 4)), B, 1)
    assert lay.heads and not lay.kv


def test_grow_cache_moves_block_boundaries():
    """A 12-slot prefill cache split over 4 positions (3 slots each) into a
    20-slot buffer (5 each): the blocks are gathered over 'model' (in the
    record), and the buffer holds the prefill's slots then zeros; a ring
    of the same shape is copied block for block, with no collective."""
    mesh = _mesh((2, 4))
    src_full = torch.arange(2 * 4 * 12 * 2 * 3, dtype=torch.float32
                            ).reshape(2, 4, 12, 2, 3)
    spec = pm.P(None, "data", "model", None, None)
    src = pm.shard(src_full, spec, mesh)
    dst = pm.shard(torch.zeros(2, 4, 20, 2, 3), spec, mesh)
    with pm.record_collectives() as rec:
        out = tkv.grow_cache({"k": src, "len": 12}, {"k": dst, "len": 0})
    assert out["len"] == 12 and out["k"] is dst
    assert [e.kind for e in rec.entries] == ["all-gather"]
    assert rec.entries[0].axes == ("model",)
    got = pm.unshard(dst, "cpu")
    assert torch.equal(got[:, :, :12], src_full)
    assert not got[:, :, 12:].any()
    ring = pm.shard(torch.zeros(2, 4, 12, 2, 3), spec, mesh)
    with pm.record_collectives() as rec:
        tkv.grow_cache({"k": src}, {"k": ring})
    assert not rec.entries
    assert torch.equal(pm.unshard(ring, "cpu"), src_full)


def test_the_served_state_hand_off_on_a_mesh():
    """A decode buffer whose SSD state is in another dtype than fp32 (the
    reference's ``grow_cache`` into ``cfg.dtype``): the step carries the
    new state in fp32, as the one-device ``decode_layer`` does, and the
    next step writes it in place."""
    jcfg, cfg = _configs("mamba2_130m", ())
    cfg = dataclasses.replace(cfg, sharding="tp")
    mesh = _mesh((1, 2))
    flat = numpy_params(jcfg, 5)
    single = bridge.params_from_numpy(cfg, flat, "cpu")
    params = bridge.sharded_params_from_numpy(cfg, flat, mesh)
    toks = torch.as_tensor(_prompts(cfg, S))
    with torch.no_grad():
        _, c1 = tss.make_prefill(cfg)(single, {"tokens": toks})
        _, cm = tss.make_prefill(cfg, mesh)(params, {"tokens": toks})
        full = tm.init_cache(cfg, B, S + GROW, device="cpu")
        full["ssm"] = full["ssm"].bfloat16()
        c1 = tkv.grow_cache(c1, full)
        buf = tm.init_cache(cfg, B, S + GROW, mesh=mesh)
        buf["ssm"] = buf["ssm"].with_blocks([b.bfloat16()
                                             for b in buf["ssm"].blocks])
        cm = tkv.grow_cache(cm, buf)
        nxt = torch.zeros((B, 1), dtype=torch.long)
        for _ in range(2):
            l1, c1 = tss.make_decode(cfg)(single, c1, nxt)
            lm, cm = tss.make_decode(cfg, mesh)(params, cm, nxt)
            assert cm["ssm"].dtype == torch.float32
            _close(lm, l1, "logits")
            _close(cm["ssm"], c1["ssm"], "ssm")


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_26b"])
def test_encdec_and_vlm_serve_on_one_and_two_positions(arch):
    """encdec and vlm (their sharded layers: ``dist/spmd_encdec.py``, the
    patches prepended in ``spmd.forward``) serve on (1, 1), where the
    prefill and a decode step equal the one-device model's bit for bit
    (the same model on whole blocks), and on (1, 2), where they agree
    within ``TOL`` and give the same greedy tokens
    (``tests/test_torch_mesh_families.py`` holds more meshes, and the
    reference)."""
    jcfg, cfg = _configs(arch, ())
    flat = numpy_params(jcfg, 5)
    toks = torch.as_tensor(_prompts(cfg, 8))
    batch = {"tokens": toks, **tm.stub_inputs(cfg, B, "cpu")}
    single = bridge.params_from_numpy(cfg, flat, "cpu")
    with torch.no_grad():
        l1, c1 = tss.make_prefill(cfg)(single, batch)
        size = c1["len"] + GROW
        c1 = tkv.grow_cache(c1, tm.init_cache(cfg, B, size, device="cpu"))
        nxt = l1.argmax(-1)[:, None]
        d1, c1 = tss.make_decode(cfg)(single, c1, nxt)
    for shape in ((1, 1), (1, 2)):
        mesh = _mesh(shape)
        params = bridge.sharded_params_from_numpy(cfg, flat, mesh)
        with torch.no_grad():
            lm, cm = tss.make_prefill(cfg, mesh)(params, batch)
            cm = tkv.grow_cache(cm, tm.init_cache(cfg, B, size, mesh=mesh))
            assert torch.equal(pm.unshard(lm, "cpu").argmax(-1)[:, None],
                               nxt)
            dm, cm = tss.make_decode(cfg, mesh)(params, cm, nxt)
        assert cm["len"] == c1["len"]
        for got, want in ((lm, l1), (dm, d1)):
            if shape == (1, 1):
                assert torch.equal(pm.unshard(got, "cpu"), want)
            else:
                _close(got, want, f"{shape}")
        for k in c1:
            if k != "len":
                _close(cm[k], c1[k], f"{shape} cache {k}")
