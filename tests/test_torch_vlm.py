"""The port's vision-language branch of ``repro_torch/models/transformer.py``
(internvl2-26b: stub patch embeddings through ``vision_proj``, prepended
to the text) against the reference, on the same seeded numpy weights and
patches, with ``test_torch_encdec``'s helpers.

The branch runs the dense stack, so its prefill and train step take the
attention and fused-norm kernels on the card; here, on the CPU, the
kernel route is their plain versions, held to the reference's naive path
at the dense tests' fp32 2e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro.serve.serve_step import BatchedServer as JServer
from repro.serve.serve_step import Request as JRequest
from repro_torch.configs import get_config as tget
from repro_torch.core.profiler import measured as tmeasured
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.serve import serve_step as tss
from test_torch_encdec import (block_batch_alike, bridge_alike,
                               decls_alike, decode_alike, forward_alike,
                               grads_alike, jx, kv_bytes_alike,
                               launch_serve_alike, launch_train_alike,
                               one_position_alike, refusals_alike,
                               served_bodies_alike, stub_batch, tx)
from test_torch_mamba2 import _close, serve_alike, train_step_alike
from test_torch_model import F32_ATOL, both_params, configs

ARCH = "internvl2_26b"


@pytest.mark.parametrize("reduced", [False, True])
def test_decls_match_reference(reduced):
    n = decls_alike(ARCH, reduced)
    if not reduced:
        assert 19.8e9 < n < 19.9e9
    assert tt.layer_decls(tget(ARCH))["wq"].shape[0] == \
        tget(ARCH).n_layers


@pytest.mark.parametrize("impl", ["naive", "kernel"])
@pytest.mark.parametrize("s", [11, 24])
def test_forward_matches_reference(impl, s):
    """The prefill over ``n_patches + S`` positions: logits for every
    position (patches first) and the cache, ``len`` ``n_patches + S``; the
    port's plain path and its kernel route (the kernels' plain versions)
    against the reference's naive path."""
    gc = forward_alike(ARCH, s, seed=1, attn_impl=impl)
    _, tcfg = configs(ARCH)
    assert gc["len"] == tcfg.n_patches + s
    assert gc["k"].shape[2] == tcfg.n_patches + s


def test_patches_reach_the_logits():
    """Other patches give other text logits (the prefix is attended)."""
    _, tcfg = configs(ARCH)
    tp = tm.init(tcfg, 0, device="cpu")
    b = tx(stub_batch(tcfg, 2))
    a = tm.forward(tcfg, tp, b)
    b["patches"] = b["patches"] + 1.0
    assert (tm.forward(tcfg, tp, b)[:, -1] - a[:, -1]).abs().max() > 1e-3


@pytest.mark.parametrize("device_len", [False, True])
def test_decode_matches_reference(device_len):
    """Decode is the dense decode: positions continue from
    ``n_patches + S``."""
    decode_alike(ARCH, device_len, seed=3)


def test_batched_server_matches_reference():
    srv = serve_alike(ARCH)
    assert set(srv.state) == {"k", "v", "len", "cur"}


def test_served_bodies_make_no_host_sync():
    served_bodies_alike(ARCH)


def test_r9_the_budget_counts_the_patches(monkeypatch, capsys):
    """Fault R9: the reference's ``launch.serve`` sizes the cache as prompt
    + new tokens + 8, without the vlm prefill's patch positions, and its
    ``BatchedServer`` fails in ``grow_cache`` (64 patches, a 32-token
    prompt, 16 new tokens: 96 positions into 56 slots).  The port's server
    raises ``ValueError`` before the prefill, and its launcher sizes
    ``max_len`` past the patches."""
    jcfg, tcfg = configs(ARCH, n_patches=64)
    jp, tp = both_params(jcfg, tcfg, seed=4)
    prompt = np.random.default_rng(4).integers(0, 256, 32).astype(np.int32)
    with pytest.raises(ValueError):
        JServer(jcfg, jp, max_len=56, batch_size=2).run(
            [JRequest(rid=0, prompt=prompt, max_new_tokens=16)])
    srv = tss.BatchedServer(tcfg, tp, max_len=56, batch_size=2)
    with pytest.raises(ValueError, match="64 patches, a 32-token prompt"):
        srv.run([tss.Request(rid=0, prompt=prompt, max_new_tokens=16)])
    assert int(srv.state["len"]) == 1          # no prefill ran
    monkeypatch.setattr(tlaunch, "get_config", lambda arch: tcfg)
    tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                  "--prompt-len", "32", "--max-new", "16",
                  "--batch-size", "2"])
    assert "2 requests, 32 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("remat,chunk", [("none", 0), ("full", 16)])
def test_loss_and_grads_match_reference(remat, chunk):
    """The patch positions' labels are ``IGNORE_LABEL``; ``logits_chunk``
    takes the chunked loss for vlm, as the reference's."""
    grads_alike(ARCH, remat, seed=5, logits_chunk=chunk)


def test_chunked_loss_covers_vlm(monkeypatch):
    """``loss_fn`` routes vlm through the chunked loss at
    ``logits_chunk > 0`` (dense, moe and vlm), never the full logits."""
    _, tcfg = configs(ARCH, logits_chunk=8)
    assert tcfg.family in tm.CHUNKED_LOSS_FAMILIES
    tp = tm.init(tcfg, 0, device="cpu")
    b = tx(stub_batch(tcfg, 6, s=13, labels=True))
    want = tm.loss_fn(dataclasses.replace(tcfg, logits_chunk=0), tp, b)[0]
    monkeypatch.setattr(tm, "forward", _no_full_logits(tm.forward))
    torch.testing.assert_close(tm.loss_fn(tcfg, tp, b)[0], want,
                               rtol=1e-6, atol=1e-6)


def _no_full_logits(forward):
    def fwd(cfg, params, batch, **kw):
        assert kw.get("return_hidden"), "the full logits were asked for"
        return forward(cfg, params, batch, **kw)
    return fwd


def test_train_step_matches_reference():
    """One AdamW step on ``SyntheticDataset``'s vlm batch (its patch
    labels masked) against the reference's."""
    train_step_alike(ARCH, seed=7)


def test_measure_block_batch_carries_patches():
    """Fault R10: the reference's ``measure_block`` labels the text alone,
    so its loss cannot broadcast them against the ``n_patches + S``
    logits and it raises on vlm; the port's batch labels the patch
    positions ``IGNORE_LABEL``, and the reference's ``loss_fn`` and
    ``jax.grad`` run on it."""
    from repro.configs import get_config as jget
    from repro.core.profiler import measured as jmeasured
    with pytest.raises(ValueError):
        jmeasured.measure_block(jget(ARCH).reduced(), 12, mbs_grid=(1,))
    tb = block_batch_alike(ARCH)
    _, tcfg = configs(ARCH)
    assert tb["labels"].shape == (2, tcfg.n_patches + 12)
    zero = tmeasured.block_batch(tcfg, 2, 12, "cpu")["labels"]
    assert (zero[:, :tcfg.n_patches] == jm.IGNORE_LABEL).all()
    assert not zero[:, tcfg.n_patches:].any()


def test_kv_cache_bytes_equal():
    kv_bytes_alike(ARCH)


def test_bridge_carries_params_and_opt_state():
    assert "vision_proj" in bridge_alike(ARCH)


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve_alike(ARCH, capsys)


def test_launch_train_runs_on_cpu(capsys, tmp_path):
    launch_train_alike(ARCH, capsys, tmp_path)


def test_one_position_mesh_matches_the_single_device_step():
    one_position_alike(ARCH)


def test_unported_paths_refuse():
    refusals_alike(ARCH)


def test_reference_forward_on_the_served_zero_patches():
    """The served prefill's zero patches are the reference server's: the
    port's last-token logits on them equal the reference's forward on
    ``jnp.zeros`` patches."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, tcfg, seed=8)
    toks = np.random.default_rng(8).integers(0, 256, (2, 9)).astype(np.int32)
    state = tss.decode_state(tcfg, 2, 24, per_row=False, device="cpu")
    got = tss.prefill_on_device(tcfg, tp, state, torch.from_numpy(toks), 2)
    want = jm.forward(jcfg, jp, jx({"tokens": toks, "patches": np.zeros(
        (2, tcfg.n_patches, tcfg.d_model), np.float32)}))[:, -1]
    _close(got, want, F32_ATOL, "prefill logits")
    assert jnp.asarray(want).shape == (2, tcfg.vocab_size)
