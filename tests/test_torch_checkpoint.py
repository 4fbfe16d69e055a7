"""The port's checkpoint manager (``repro_torch/train/checkpoint.py``)
against the reference's, on the CPU.

Every case of ``tests/test_checkpoint.py`` runs against the port's
manager with the same assertions, on tensors.  The files are the
reference's: each package restores the other's checkpoints bit for bit,
fp32 and bf16 (a bf16 leaf is a 2-byte ``|V2`` record in both, compared
as ``uint16``).  The port's snapshot is a copy (its optimizer writes in
place), and ``Sharded`` leaves save whole and restore onto another mesh.
Also fault P4: ``bridge.params_from_numpy`` on a reference-written bf16
checkpoint.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JManager
from repro.train.checkpoint import _flatten as j_flatten
from repro.train.checkpoint import _unflatten as j_unflatten
from repro_torch import bridge
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.dist.sharding import param_specs
from repro_torch.models import model as tm
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from test_torch_model import configs, numpy_params

CPU = torch.device("cpu")


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.standard_normal((8, 4)).astype(np.float32)),
            "layers": {"ln": torch.ones((3, 4))}},
        "opt": {"m": torch.zeros((8, 4)), "step": torch.tensor(5)},
    }


def _leaves(tree):
    return [t for _, t in pm.tree_items(tree)]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits (bf16 as uint16) for an exact comparison."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _array_bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" and a.dtype != np.float16 else a


# --- every case of tests/test_checkpoint.py ----------------------------------------

def test_roundtrip_blocking(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(10, state, blocking=True)
    restored, step = mgr.restore(state)
    assert step == 10
    for a, b in zip(_leaves(state), _leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert a.dtype == b.dtype


def test_async_save_does_not_block(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    t0 = time.perf_counter()
    mgr.save(1, state, blocking=False)
    t_submit = time.perf_counter() - t0
    mgr.wait()
    assert mgr.latest_step() == 1
    # submission returns quickly even though the write happens later
    assert t_submit < 5.0


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(), blocking=True)
    assert mgr.steps() == [3, 4]


def test_restore_latest_and_specific(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s1, s2 = _state(1), _state(2)
    mgr.save(1, s1, blocking=True)
    mgr.save(2, s2, blocking=True)
    _, step = mgr.restore(s1)
    assert step == 2
    r1, step = mgr.restore(s1, step=1)
    assert step == 1
    np.testing.assert_array_equal(r1["params"]["w"].numpy(),
                                  s1["params"]["w"].numpy())


def test_no_torn_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), blocking=True)
    # tmp- dirs never count as checkpoints
    os.makedirs(os.path.join(str(tmp_path), "tmp-99"), exist_ok=True)
    assert mgr.steps() == [1]


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())


def test_orphaned_tmp_dirs_swept_on_init(tmp_path):
    """A crash mid-write leaves tmp-<step>; a new manager must clean it."""
    orphan = tmp_path / "tmp-7"
    orphan.mkdir()
    (orphan / "state.npz").write_bytes(b"torn")
    keep = tmp_path / "step-3"
    keep.mkdir()
    mgr = CheckpointManager(str(tmp_path), orphan_ttl_s=0.0)
    assert not orphan.exists()
    assert keep.exists()                 # completed checkpoints untouched
    assert mgr.steps() == [3]


def test_fresh_tmp_dir_survives_init(tmp_path):
    """A recent tmp dir may be a live writer from another process — the
    default TTL must leave it alone."""
    live = tmp_path / "tmp-9"
    live.mkdir()
    CheckpointManager(str(tmp_path))     # default orphan_ttl_s
    assert live.exists()


def test_steps_skips_unparsable_entries(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(), blocking=True)
    (tmp_path / "step-backup").mkdir()   # foreign dir must not raise
    (tmp_path / "step-old.bak").mkdir()
    assert mgr.steps() == [5]
    assert mgr.latest_step() == 5
    _, step = mgr.restore(_state())      # restore still works around them
    assert step == 5


def test_failed_write_surfaces_on_the_next_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(1, _state(), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()                           # raised once
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, _state(), blocking=True)


# --- the files are the reference's ----------------------------------------------------

def _train_state(dtype, seed=3):
    """The same params (``param_dtype`` ``dtype``) and a stepped AdamW
    state in both packages: JAX pytrees and port tensors."""
    jcfg, tcfg = configs("smollm_360m", dtype, n_layers=2)
    flat = numpy_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                      j_unflatten(jm.decls(jcfg), flat))
    rng = np.random.default_rng(seed)
    jo = jopt.init_state(jp)
    jo = {"m": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
              a.shape), jnp.float32), jo["m"]),
          "v": jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape),
                                                  jnp.float32), jo["v"]),
          "step": jnp.asarray(7, jnp.int32)}
    tp = bridge.params_from_numpy(tcfg, j_flatten(jp), "cpu")
    to = bridge.opt_state_from_numpy(tcfg, j_flatten(jo), "cpu")
    return jcfg, tcfg, {"params": jp, "opt": jo}, {"params": tp, "opt": to}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_reference_checkpoint_restores_bit_for_bit(tmp_path, dtype):
    _, _, jstate, tstate = _train_state(dtype)
    JManager(str(tmp_path)).save(4, jstate, blocking=True)
    got, step = CheckpointManager(str(tmp_path)).restore(tstate)
    assert step == 4
    want = j_flatten(jstate)
    for k, t in pm.tree_items(got):
        assert t.dtype == dict(pm.tree_items(tstate))[k].dtype, k
        np.testing.assert_array_equal(_bits(t), _array_bits(want[k]),
                                      err_msg=k)
    if dtype == "bfloat16":
        assert got["params"]["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_port_checkpoint_is_the_references(tmp_path, dtype):
    """Keys, manifest and each key's bytes (bf16 as uint16) equal to the
    reference's file of the same state; ``np.load`` and the reference's
    ``_unflatten`` read it, and so does its manager."""
    _, _, jstate, tstate = _train_state(dtype)
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    JManager(str(jdir)).save(4, jstate, blocking=True)
    CheckpointManager(str(tdir)).save(4, tstate, blocking=True)
    with open(jdir / "step-4" / "manifest.json") as f:
        jman = json.load(f)
    with open(tdir / "step-4" / "manifest.json") as f:
        assert json.load(f) == jman
    with np.load(jdir / "step-4" / "state.npz") as zj, \
            np.load(tdir / "step-4" / "state.npz") as zt:
        assert zt.files == zj.files          # the same keys, same order
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(_array_bits(zt[k]),
                                          _array_bits(zj[k]), err_msg=k)
        read = j_unflatten(jstate, {k: zt[k] for k in zt.files})
    for k, a in j_flatten(read).items():
        np.testing.assert_array_equal(_array_bits(a),
                                      _array_bits(j_flatten(jstate)[k]))
    if dtype == "float32":               # the reference restores fp32 only
        back, step = JManager(str(tdir)).restore(jstate)    # (R7)
        assert step == 4
        for k, a in j_flatten(back).items():
            np.testing.assert_array_equal(a, j_flatten(jstate)[k])


def test_bf16_reference_checkpoint_loads_through_bridge(tmp_path):
    """Fault P4: ``np.load`` gives a reference-written bf16 leaf as raw
    ``|V2`` records; ``params_from_numpy(..., prefix="params/")`` reads
    them as bfloat16 bits."""
    jcfg, tcfg, jstate, _ = _train_state("bfloat16")
    JManager(str(tmp_path)).save(1, {"params": jstate["params"]},
                                 blocking=True)
    with np.load(tmp_path / "step-1" / "state.npz") as z:
        flat = {k: z[k] for k in z.files}
    assert flat["params/embed"].dtype == np.dtype("V2")
    got = bridge.params_from_numpy(tcfg, flat, "cpu", prefix="params/")
    want = j_flatten(jstate["params"])
    for k, t in pm.tree_items(got):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(want[k]).view(np.int16), err_msg=k)


# --- the snapshot, and sharded state ----------------------------------------------------

def test_non_blocking_save_survives_the_next_in_place_step(tmp_path,
                                                           monkeypatch):
    """The write is held until an in-place AdamW step has changed params,
    ``m``, ``v`` and step; the checkpoint still holds the saved state."""
    jcfg, tcfg = configs("smollm_360m", n_layers=2)
    params = bridge.params_from_numpy(tcfg, numpy_params(jcfg, 1), "cpu")
    state = topt.init_state(params)
    grads = topt.tree_unflatten((k, torch.full_like(t, 0.5))
                                for k, t in topt.tree_leaves(params))
    cfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    topt.apply_updates(params, grads, state, cfg)
    saved = {k: t.clone() for k, t in pm.tree_items(
        {"params": params, "opt": state})}
    stepped = threading.Event()
    real = np.savez

    def held(*a, **k):
        assert stepped.wait(30)
        real(*a, **k)

    monkeypatch.setattr(np, "savez", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": state}, blocking=False)
    topt.apply_updates(params, grads, state, cfg)     # in place
    stepped.set()
    mgr.wait()
    assert not torch.equal(params["layers"]["wq"],
                           saved["params/layers/wq"])
    got, _ = mgr.restore({"params": params, "opt": state})
    for k, t in pm.tree_items(got):
        assert torch.equal(t, saved[k]), k


@pytest.mark.parametrize("policy", ["fsdp_tp", "tp"])
def test_sharded_state_saves_whole_and_restores_onto_another_mesh(
        tmp_path, policy):
    """Params and AdamW state on a (2, 2) mesh save as whole arrays (the
    reference's keys) and restore onto a (1, 4) mesh, by a tree of
    ``Sharded`` or of (spec, mesh) pairs, bit for bit."""
    jcfg, tcfg = configs("qwen1_5_0_5b", n_layers=2, sharding=policy)
    full = bridge.params_from_numpy(tcfg, numpy_params(jcfg, 2), "cpu")
    decls = tm.decls(tcfg)
    a = data_model_mesh(2, 2, [CPU] * 4)
    b = data_model_mesh(1, 4, [CPU] * 4)
    params = pm.shard_tree(full, param_specs(decls, policy, a), a)
    state = topt.init_sharded_state(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params, "opt": state}, blocking=True)
    with np.load(tmp_path / "step-3" / "state.npz") as z:
        for k, t in pm.tree_items(full):
            np.testing.assert_array_equal(z["params/" + k], t.numpy())
        assert z["opt/step"].shape == () and int(z["opt/step"]) == 0
    specs = param_specs(decls, policy, b)
    target = pm.shard_tree(full, specs, b)
    tstate = topt.init_sharded_state(target)
    template = {"params": target, "opt": tstate}
    pairs = pm.tree_map(lambda _, x: (x.spec, x.mesh), template)
    for how in (template, pairs):
        got, step = mgr.restore(template, shardings=how)
        assert step == 3
        for k, x in pm.tree_items(got["params"]):
            assert x.mesh is b and x.spec == dict(pm.tree_items(specs))[k]
            assert torch.equal(pm.unshard(x, "cpu"), dict(
                pm.tree_items(full))[k])
        assert all(int(s) == 0 for s in got["opt"]["step"].blocks)
    with pytest.raises(TypeError, match="Sharded or a"):
        mgr.restore(template, shardings=pm.tree_map(
            lambda _, x: (x.spec, "mesh"), template))


def test_restore_without_shardings_follows_the_template():
    """Without ``shardings`` a tensor leaf comes back in its template's
    dtype on its device (bf16 from fp32 bits is a rounding the template
    asks for), and a shape that does not match raises."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
                 blocking=True)
        got, _ = mgr.restore({"x": torch.zeros(2, 3, dtype=torch.bfloat16)})
        assert got["x"].dtype == torch.bfloat16
        assert got["x"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
        with pytest.raises(ValueError, match="template of"):
            mgr.restore({"x": torch.zeros(3, 2)})

