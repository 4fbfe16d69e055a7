"""The chunked loss on a mesh (``cfg.logits_chunk > 0``:
``dist/spmd.chunked_ce_loss``, ``model.forward(..., return_hidden=True,
mesh=)``) against the port's one-device ``model._chunked_loss`` and the
reference's one-device ``_chunked_loss`` (``jax.value_and_grad`` of
``repro.models.model.loss_fn``), on the same seeded numpy weights and
batch (one microbatch), on meshes of CPU devices.

The reference's own mesh step fails on this jax (ROADMAP §3, R1), so its
one-device chunked loss is the reference.  Tolerances are the mesh
tests' fp32 ones (``test_torch_mesh``): loss rtol 1e-5, every gradient
leaf 1e-5 of its max |g|, against both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as jm
from repro.train.checkpoint import _flatten, _unflatten
from repro_torch.dist import placement as pm
from repro_torch.models import model as tm
from repro_torch.train import train_step as tts
from test_torch_mesh import (GRAD_TOL, LOSS_RTOL, _assert_replicas_equal,
                             _batch, _both, _cfg, _check_grads, _flat,
                             _mesh, _numpy_params)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(arch, cfg, flat, batch):
    """(loss, flat fp32 grads) of the reference's one-device loss on the
    batch's first microbatch, ``cfg``'s fields on the reference's config."""
    over = {k: getattr(cfg, k) for k in ("sharding", "head_dim",
                                         "tie_embeddings", "logits_chunk")}
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    jp = jax.tree.map(jnp.asarray, _unflatten(jm.decls(jcfg), flat))
    jb = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    (loss, _), g = jax.value_and_grad(
        lambda p: jm.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    return float(loss), _flatten(g)


# (arch, policy, mesh, tied head, chunk); the reduced configs' vocab is
# 256, 12 text positions (a vlm's 8 patches lead them)
CASES = [
    ("smollm_360m", "fsdp_tp", (2, 2), True, 5),   # logits over 'model'
    ("smollm_360m", "tp", (1, 2), False, 4),       # untied, chunks divide
    ("smollm_360m", "tp", (1, 3), True, 5),        # 3 divides no vocab
    ("qwen1_5_0_5b", "fsdp_tp", (2, 1), True, 7),  # no 'model' split
    ("dbrx_132b", "tp", (1, 2), False, 5),         # moe, experts split
    ("dbrx_132b", "fsdp_tp", (2, 2), True, 5),
    ("internvl2_26b", "fsdp_tp", (2, 2), False, 6),  # vlm, 20 positions
    ("internvl2_26b", "tp", (1, 2), True, 5)]


@pytest.mark.parametrize("arch,policy,shape,tied,chunk", CASES)
def test_chunked_loss_on_a_mesh(arch, policy, shape, tied, chunk):
    """The mesh's chunked loss and every gradient leaf against the port's
    one-device chunked loss and the reference's, on the same weights:
    each replica's gradient equal; the chunked loss equals the
    unchunked one on the mesh."""
    cfg = _cfg(arch, policy, tie_embeddings=tied, logits_chunk=chunk)
    mesh = _mesh(shape)
    single, sharded = _both(cfg, mesh, seed=3)
    batch = _batch(cfg, 4, 1, 4)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_RTOL)
    _check_grads(gg, wg)
    _assert_replicas_equal(gg, "grad")
    rl, rg = _reference(arch, cfg, _numpy_params(cfg, 3), batch)
    np.testing.assert_allclose(float(gl), rl, rtol=LOSS_RTOL)
    got = _flat(pm.unshard_tree(gg, "cpu"))
    assert set(got) == set(rg)
    for k, w in rg.items():
        w = np.asarray(w, np.float32)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)
    ul, _ = tts.loss_and_grads(dataclasses.replace(cfg, logits_chunk=0),
                               sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(ul), float(gl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("policy,shape,tied", [("fsdp_tp", (2, 2), True),
                                               ("tp", (1, 2), False)])
def test_hidden_and_head_on_a_mesh(policy, shape, tied):
    """``forward(..., return_hidden=True, mesh=)``: the final-normed hidden
    (B, S, D), its batch over the dp axes, and the head (D, V), its vocab
    over 'model' where the logits split, as ``Sharded``, equal to the
    one-device forward's (1e-5 of max |x|)."""
    cfg = _cfg("smollm_360m", policy, tie_embeddings=tied)
    mesh = _mesh(shape)
    single, sharded = _both(cfg, mesh, seed=5)
    toks = _batch(cfg, 6, 1, 4)["tokens"][0]
    with torch.no_grad():
        want = tm.forward(cfg, single, {"tokens": torch.from_numpy(toks)},
                          return_hidden=True)
        got = tm.forward(cfg, sharded, {"tokens": toks}, mesh=mesh,
                         return_hidden=True)
    assert got[0].spec == ("data", None, None)
    assert got[1].spec == (None, "model")
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        err = (pm.unshard(g, "cpu") - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item()


def test_chunked_loss_families_on_a_mesh():
    """``logits_chunk`` outside the dense, moe and vlm families keeps the
    unchunked loss on a mesh, as the reference's ``loss_fn`` does; a
    forward for the hidden rows of another family, or with a cache, is
    refused."""
    cfg = _cfg("mamba2_130m", "tp")
    mesh = _mesh((1, 2))
    single, sharded = _both(cfg, mesh, seed=0)
    batch = _batch(cfg, 1, 1, 2)
    want, _ = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    got, _ = tts.loss_and_grads(dataclasses.replace(cfg, logits_chunk=4),
                                sharded, batch, mesh=mesh)
    assert float(got) == float(want)
    with pytest.raises(ValueError, match="return_hidden"):
        tm.forward(cfg, sharded, {"tokens": batch["tokens"][0]}, mesh=mesh,
                   return_hidden=True)
    dense = _cfg("smollm_360m", "tp")
    _, params = _both(dense, mesh, seed=0)
    from repro_torch.dist import spmd
    with pytest.raises(ValueError, match="return_hidden"):
        spmd.forward(dense, params, {"tokens": batch["tokens"][0]}, mesh,
                     return_cache=True, return_hidden=True)
