"""The encoder-decoder and vision-language families on a mesh
(``dist/spmd_encdec.py``, the vlm's patches in ``dist/spmd.forward``):
the sharded train step, ``serve_step.make_prefill(cfg, mesh)`` /
``make_decode(cfg, mesh)`` and ``kv_cache.grow_cache`` of the reduced
whisper-tiny and internvl2-26b (fp32, 4 heads of 16 over 2 K/V heads,
d_ff 128, vocab 256; whisper's 16 stub frames, internvl2's 8 stub
patches) on meshes of CPU positions.

The reference's mesh step and mesh prefill fail on jax 0.9.0 (fault R1),
so the mesh is held against the port's one-device step, which
``tests/test_torch_encdec.py`` and ``tests/test_torch_vlm.py`` hold
against the reference, and against the reference's one-device
``make_train_step``, ``make_prefill`` and ``make_decode`` on the same
numpy weights.  Tolerances: the train step's ``test_torch_mesh.py`` (loss
rtol 1e-5, every gradient leaf 1e-5 of its max |g|, params after one step
rtol 2e-3 / atol 2e-4, replicas bit for bit after 3 steps); serving's
``test_torch_serve_mesh.py`` (every logit within 1e-5 of the step's max
|logit|, the caches within 1e-5 of their max |value|, greedy tokens
equal).

The meshes cover the layouts where trouble is likely: on (1, 2) and
(2, 2) every head splits (4 query and 2 K/V heads over 2); on (1, 4) the
query heads split and the K/V heads do not, so each position takes the
K/V head its query heads read, in the self- and the cross-attention,
and the decode's self-attention cache splits its slots while ``ck`` /
``cv`` stay whole; under ``replicated`` the weights are whole while the
query heads and the cache's K/V heads split; under ``fsdp_tp``
``frame_proj``, ``enc_pos`` (its leading dim replicated) and
``vision_proj`` are gathered over 'data'.
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
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.sharding import P
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import serve_step as tss
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_encdec import stub_batch
from test_torch_mesh import (LOSS_RTOL, _batch, _both, _flat, _mesh,
                             step_matches_single_device)
from test_torch_model import _unflatten, configs, numpy_params

ENCDEC, VLM = "whisper_tiny", "internvl2_26b"
ARCHS = (ENCDEC, VLM)
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


def _configs(arch, **over):
    """Both packages' reduced configs at their own head_dim (16)."""
    return tuple(dataclasses.replace(c, head_dim=16, **over)
                 for c in configs(arch))


def _cfg(arch, policy, **over):
    return dataclasses.replace(_configs(arch)[1], sharding=policy, **over)


# --- the sharded train step ---------------------------------------------------------

# (arch, mesh, policy, remat, micro_batch): micro_batch 3 divides no dp
# axis (the batch replicated, its loss counted once)
STEP_CASES = [(arch, shape, policy, remat, mb)
              for arch in ARCHS
              for shape, policy, remat, mb in (
                  ((1, 2), "fsdp_tp", "none", 4),
                  ((2, 1), "fsdp_tp", "full", 3),
                  ((2, 2), "fsdp_tp", "full", 4),
                  ((1, 4), "tp", "dots", 4))]


@pytest.mark.parametrize("arch,shape,policy,remat,micro_batch", STEP_CASES)
def test_sharded_step_matches_single_device(arch, shape, policy, remat,
                                            micro_batch):
    step_matches_single_device(_cfg(arch, policy, remat=remat), shape, None,
                               micro_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference(arch):
    """One ``jit_train_step`` on (2, 2) ``fsdp_tp`` against the reference's
    one-device ``make_train_step`` on the same numpy weights and batch:
    loss and gradient norm rtol 1e-5 (the reference's mesh step fails,
    R1)."""
    jcfg, tcfg = _configs(arch, sharding="fsdp_tp", remat="full")
    mesh = _mesh((2, 2))
    flat = numpy_params(jcfg, 3)
    jp = jax.tree.map(jnp.asarray, _unflatten(jm.decls(jcfg), flat))
    batch = _batch(tcfg, 4, 2, 4)
    ocfg = dict(lr=1e-3, warmup_steps=1, grad_clip=1.0)
    _, _, want = jax.jit(jts.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))(jp, jopt.init_state(jp),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    params = bridge.sharded_params_from_numpy(tcfg, flat, mesh)
    _, _, got = tts.jit_train_step(tcfg, topt.OptimizerConfig(**ocfg), mesh,
                                   2, 4)(params,
                                         topt.init_sharded_state(params),
                                         batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_layout_reads_the_decoder_and_counts_the_patches():
    """encdec's ``Layout`` comes from its ``decoder`` tree (``w_in`` for
    'ff'); a vlm's sequence counts its patches (the prefill's ``len``)."""
    mesh = _mesh((1, 4))
    cfg = _cfg(ENCDEC, "tp")
    lay = spmd.layout(cfg, _both(cfg, mesh, seed=0)[1], mesh, B, S)
    assert (lay.heads, lay.kv, lay.ff, lay.experts) == \
        (True, False, True, False)
    assert lay.vocab_embed and lay.vocab_logits and lay.batch == ("data",)
    cfg = _cfg(VLM, "fsdp_tp")
    params = bridge.sharded_params_from_numpy(
        cfg, numpy_params(_configs(VLM)[0], 0), _mesh((2, 2)))
    assert params["vision_proj"].spec == P("data", None)
    toks = torch.zeros((B, S), dtype=torch.long)
    batch = {"tokens": toks, **tm.stub_inputs(cfg, B, "cpu")}
    with torch.no_grad():
        _, cache = tss.make_prefill(cfg, _mesh((2, 2)))(params, batch)
    assert cache["len"] == cfg.n_patches + S
    assert cache["k"].shape[2] == cfg.n_patches + S


def test_replicated_encoder_gradients_sum_over_replicas():
    """On (2, 2) ``tp`` the 'data' positions hold other sequences: each
    replica of a replicated block (``enc_pos``, ``frame_proj``, the
    encoder's norms) gets its own sequences' part of the gradient, far
    from the whole; summed over the replicas (``replica_group_sum``, as
    the step does) they equal the one-device gradient."""
    cfg = _cfg(ENCDEC, "tp")
    mesh = _mesh((2, 2))
    single, sharded = _both(cfg, mesh, seed=9)
    mb = {k: torch.from_numpy(v[0]) for k, v in _batch(cfg, 10, 1, 4).items()}
    _, wg = tts.loss_and_grads(cfg, single, {k: v[None] for k, v in
                                             mb.items()})
    wg = _flat(wg)
    names = ("enc_pos", "frame_proj", "encoder/ln1")
    leaves = {k: x.with_blocks([b.detach().requires_grad_()
                                for b in x.blocks])
              for k, x in pm.tree_items(sharded) if k in names}
    tree = topt.tree_unflatten([(k, leaves.get(k, x))
                                for k, x in pm.tree_items(sharded)])
    loss, _ = tm.loss_fn(cfg, tree, mb, mesh=mesh)
    for k, x in leaves.items():
        assert x.spec == P(*[None] * len(x.shape)), k
        grads = torch.autograd.grad(loss, x.blocks, retain_graph=True)
        scale = wg[k].abs().max().item()
        assert (grads[0] - wg[k]).abs().max().item() > 1e-3 * scale, k
        summed = pm.replica_group_sum(x.with_blocks(list(grads)))
        for g in summed.blocks:
            assert (g - wg[k]).abs().max().item() <= 1e-5 * scale, k


# --- serving -----------------------------------------------------------------------

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
def _one_device(arch):
    """The reference's and the port's one-device prefill, ``grow_cache``
    and ``STEPS`` greedy steps: per side the logits of the prefill and of
    each step; the greedy tokens; the port's caches after the prefill and
    after the last step."""
    jcfg, tcfg = _configs(arch)
    flat = numpy_params(jcfg, 5)
    jp = jax.tree.map(jnp.asarray, _unflatten(jm.decls(jcfg), flat))
    tp = bridge.params_from_numpy(tcfg, flat, "cpu")
    batch = stub_batch(tcfg, 3, b=B, s=S)
    jl, jc = jax.jit(jss.make_prefill(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    size = int(jc["len"]) + GROW
    jc = jkv.grow_cache(jc, jm.init_cache(jcfg, B, size))
    jdecode = jax.jit(jss.make_decode(jcfg))
    with torch.no_grad():
        tl, tc = tss.make_prefill(tcfg)(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        first = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in tc.items()}
        tc = tkv.grow_cache(tc, tm.init_cache(tcfg, B, size, device="cpu"))
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
                cache=tc, batch=batch, size=size, flat=flat)


def _serve_mesh(arch, shape, policy, length="int"):
    """The mesh's prefill (its cache laid out by ``cache_specs``),
    ``grow_cache`` into ``init_cache(..., mesh=)`` and ``STEPS`` greedy
    steps against ``_one_device``; ``length`` the form of ``len`` in
    decode (an int or a 0-d tensor).  Returns the decode buffer's
    specs."""
    one = _one_device(arch)
    cfg = _cfg(arch, policy)
    mesh = _mesh(shape)
    params = bridge.sharded_params_from_numpy(cfg, one["flat"], mesh)
    n = one["prefill_cache"]["len"]
    with torch.no_grad():
        logits, cache = tss.make_prefill(cfg, mesh)(
            params, {k: torch.from_numpy(v) for k, v in one["batch"].items()})
        assert cache["len"] == n
        assert logits.spec[0] == tss.shd.batch_spec(mesh, B)[0]
        specs = tss.cache_specs(cfg, B, n, mesh)
        for k, x in cache.items():
            if k != "len":
                assert x.spec == specs[k], k
                _close(x, one["prefill_cache"][k], f"prefill cache {k}")
        buf = tm.init_cache(cfg, B, one["size"], mesh=mesh)
        grown = tkv.grow_cache(cache, buf)
        assert all(grown[k] is buf[k] for k in buf if k != "len")
        cache = grown
        if length == "0-d":
            cache["len"] = torch.tensor(n)
        step = tss.make_decode(cfg, mesh)
        for i in range(STEPS + 1):
            _close(logits, one["port"][i], f"step {i} vs one device")
            _close(logits, one["ref"][i], f"step {i} vs the reference")
            if i == STEPS:
                break
            nxt = pm.unshard(logits, "cpu").argmax(-1)[:, None]
            assert torch.equal(nxt, one["tokens"][i]), i
            logits, cache = step(params, cache, nxt)
    assert int(torch.as_tensor(cache["len"])) == n + STEPS
    for k, x in cache.items():
        if k != "len":
            _close(x, one["cache"][k], f"decode cache {k}")
    return {k: x.spec for k, x in cache.items() if k != "len"}


# (mesh, policy, len form, the decode buffer's K/V spec, its ck spec)
SERVE_CASES = [
    ((1, 2), "tp", "int", P(None, "data", None, "model", None)),
    ((2, 1), "fsdp_tp", "0-d", P(None, "data", None, "model", None)),
    ((2, 2), "fsdp_tp", "int", P(None, "data", None, "model", None)),
    # the query heads split, the 2 K/V heads whole: the slots split
    ((1, 4), "tp", "int", P(None, "data", "model", None, None)),
    # the weights whole, the query heads and the cache's K/V heads split
    ((1, 2), "replicated", "0-d", P(None, "data", None, "model", None)),
]


@pytest.mark.parametrize("shape,policy,length,kv_spec", SERVE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_one_device(arch, shape, policy, length,
                                             kv_spec):
    specs = _serve_mesh(arch, shape, policy, length)
    assert specs["k"] == specs["v"] == kv_spec
    if arch == ENCDEC:
        # the frame axis never split; the 2 K/V heads over 'model' where
        # they divide it
        want = P(None, "data", None, None if shape[1] == 4 else "model",
                 None)
        assert specs["ck"] == specs["cv"] == want


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (2, 1)])
def test_encdec_cache_specs(shape):
    """The encdec cache on a mesh: ``ck``/``cv`` (L, B, n_frames, KV, hd)
    by ``cache_specs`` in the prefill's cache and in ``init_cache(...,
    mesh=)``, K/V heads over 'model' where they divide, the frame axis
    never split; ``grow_cache`` grows ``k``/``v`` and copies ``ck``/``cv``
    block for block, with no collective."""
    cfg = _cfg(ENCDEC, "tp")
    mesh = _mesh(shape)
    specs = tss.cache_specs(cfg, B, S + GROW, mesh)
    heads = "model" if cfg.n_kv_heads % shape[1] == 0 else None
    for k in ("ck", "cv"):
        assert specs[k] == P(None, "data", None, heads, None)
    buf = tm.init_cache(cfg, B, S + GROW, mesh=mesh)
    assert {k: x.spec for k, x in buf.items() if k != "len"} == \
        {k: v for k, v in specs.items() if k != "len"}
    assert buf["ck"].shape == (cfg.n_layers, B, cfg.n_frames,
                               cfg.n_kv_heads, cfg.hd)
    params = _both(cfg, mesh, seed=2)[1]
    batch = {k: torch.from_numpy(v)
             for k, v in stub_batch(cfg, 2, b=B, s=S).items()}
    with torch.no_grad():
        _, cache = tss.make_prefill(cfg, mesh)(params, batch)
    assert cache["ck"].spec == specs["ck"]
    with pm.record_collectives() as rec:
        tkv.grow_cache({k: v for k, v in cache.items() if k != "k"
                        and k != "v"}, {k: buf[k] for k in ("ck", "cv")})
    assert not rec.entries
    for k in ("ck", "cv"):
        assert all(torch.equal(a, b) for a, b in zip(buf[k].blocks,
                                                     cache[k].blocks))


def test_encdec_decode_refuses_a_per_row_len():
    """As on one device, the family decodes a lockstep batch only."""
    cfg = _cfg(ENCDEC, "tp")
    mesh = _mesh((1, 2))
    params = _both(cfg, mesh, seed=2)[1]
    cache = tm.init_cache(cfg, B, S, mesh=mesh)
    cache["len"] = torch.full((B,), 3)
    with pytest.raises(ValueError, match="lockstep"):
        tss.make_decode(cfg, mesh)(params, cache,
                                   torch.zeros((B, 1), dtype=torch.long))
