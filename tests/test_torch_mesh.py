"""Sharded tensors, the collectives and the sharded train step on meshes
of CPU devices (``[torch.device("cpu")] * n``: one process runs every
position, as on one card).

The reference's own mesh step cannot run here (fault R1: its
``constrain`` fails inside ``jit`` on this jax), so the sharded step is
held against the port's single-device ``make_train_step`` on the same
seeded numpy weights (``bridge``), which ``tests/test_torch_train.py``
holds against the reference's single-device step.  Tolerances, fp32:

- loss: rtol 1e-5 (the same terms summed in another order: per dp shard,
  per vocab shard);
- every gradient leaf: 1e-5 of its max |g| (partial products summed over
  'model', replicas summed over 'data');
- params after one step with the clip on: the reference's own sharded
  test's rtol 2e-3 / atol 2e-4 (``tests/test_distributed.py:100-101``);
- every replica of a block, of params, ``m`` and ``v``, bit for bit equal
  after 3 steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.dist import placement as pm
from repro_torch.dist import spmd
from repro_torch.dist.mesh import data_model_mesh, pod_data_model_mesh
from repro_torch.dist.sharding import P, iter_decls, param_specs
from repro_torch.models import model as tm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

CPU = torch.device("cpu")
SEQ = 12
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, policy, **kw):
    return dataclasses.replace(get_config(arch).reduced(), sharding=policy,
                               head_dim=64, **kw)


def _numpy_params(cfg, seed):
    """Seeded numpy weights for every declared tensor (the shape of
    ``test_torch_model.numpy_params``, from the port's declarations)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, d in iter_decls(tm.decls(cfg)):
        if d.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "zeros":
            a = 0.1 * rng.standard_normal(d.shape)
        else:
            std = 0.02 if d.scale_dim is None else d.shape[d.scale_dim] ** -0.5
            a = std * rng.standard_normal(d.shape)
        flat[path] = a.astype(np.float32)
    return flat


def _batch(cfg, seed, n_micro, micro_batch, mask_first=True):
    """Tokens and labels (n_micro, micro_batch, SEQ); with ``mask_first``
    only the first sequence of each microbatch (on the first dp position)
    has masked labels, so the dp positions count different tokens.  The
    stubbed frontends' inputs are drawn after them (std 1): encdec's
    ``frames``, a vlm's ``patches``, whose positions lead the labels,
    masked."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n_micro, micro_batch, SEQ + 1))
    labels = toks[..., 1:].copy()
    if mask_first:
        labels[:, 0, : SEQ // 2] = tm.IGNORE_LABEL
    out = {"tokens": toks[..., :-1].astype(np.int32)}
    stub = {"encdec": ("frames", cfg.n_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        out[stub[0]] = rng.standard_normal(
            (n_micro, micro_batch, stub[1], cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        labels = np.concatenate([np.full(labels.shape[:2] + (
            cfg.n_patches,), tm.IGNORE_LABEL), labels], axis=-1)
    out["labels"] = labels.astype(np.int32)
    return out


def _mesh(shape):
    n = int(np.prod(shape))
    if len(shape) == 3:
        return pod_data_model_mesh(*shape, [CPU] * n)
    return data_model_mesh(*shape, [CPU] * n)


def _flat(tree):
    return dict(topt.tree_leaves(tree))


def _assert_replicas_equal(tree, what):
    for path, x in pm.tree_items(tree):
        for group in x.mesh.groups(pm.replica_axes(x.spec, x.mesh)):
            for p in group[1:]:
                assert torch.equal(x.blocks[p], x.blocks[group[0]]), \
                    f"{what} {path}: replica {p} != {group[0]}"


# --- placement -----------------------------------------------------------------------

@pytest.mark.parametrize("shape,policy", [((4, 2), "fsdp_tp"),
                                          ((2, 2), "tp"), ((1, 4), "tp"),
                                          ((2, 2, 1), "fsdp_tp")])
def test_shard_unshard_is_the_identity_for_every_leaf(shape, policy):
    cfg = _cfg("qwen1_5_0_5b", policy)
    mesh = _mesh(shape)
    flat = _numpy_params(cfg, 0)
    params = bridge.params_from_numpy(cfg, flat, "cpu")
    specs = param_specs(tm.decls(cfg), policy, mesh)
    sharded = pm.shard_tree(params, specs, mesh)
    storages = set()
    for path, x in pm.tree_items(sharded):
        assert x.spec == dict(pm.tree_items(specs))[path]
        for p, b in enumerate(x.blocks):
            assert b.is_contiguous() and b.device == CPU
            sl = pm.block_slices(x.shape, x.spec, mesh, p)
            assert torch.equal(b, _flat(params)[path][sl])
            storages.add(b.untyped_storage().data_ptr())
    # every block its own storage, also on a repeated device
    n_blocks = sum(len(x.blocks) for _, x in pm.tree_items(sharded))
    assert len(storages) == n_blocks
    back = bridge.sharded_params_to_numpy(sharded)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # a block written does not change its replica (nothing aliases)
    x = sharded["layers"]["ln1"]
    before = x.blocks[1].clone()
    x.blocks[0].add_(1.0)
    assert torch.equal(x.blocks[1], before)


@pytest.mark.parametrize("spec", [P(), P("data"), P(None, "model"),
                                  P("model", "data"), P(("data", "model")),
                                  P(None, ("pod", "data")),
                                  P(("pod", "model"), "data")])
def test_shard_unshard_every_spec(spec):
    mesh = _mesh((2, 2, 2))
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    x = pm.shard(full, spec, mesh)
    assert torch.equal(pm.unshard(x, "cpu"), full)
    n = len(pm.owners(x.spec, mesh))
    assert n == full.numel() // x.blocks[0].numel()


def test_shard_refuses_bad_specs():
    mesh = _mesh((2, 2))
    with pytest.raises(ValueError, match="not divide"):
        pm.shard(torch.zeros(3, 4), P("data"), mesh)
    with pytest.raises(ValueError, match="used twice"):
        pm.shard(torch.zeros(4, 4), P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in mesh"):
        pm.shard(torch.zeros(4, 4), P("pod"), mesh)


def test_collectives_and_their_gradients_match_a_single_tensor():
    """all_reduce_sum / all_gather / max / min over each axis and over
    both, forward and gradient against the same math on one tensor."""
    mesh = _mesh((2, 3))
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 4, 5, generator=g)
    coef = torch.randn(6, 4, 5, generator=g)
    for axes in ("data", "model", ("data", "model")):
        xs = [base[p].clone().requires_grad_() for p in range(6)]
        out = pm.all_reduce_sum(xs, mesh, axes)
        (sum((o * c).sum() for o, c in zip(out, coef))).backward()
        for group in mesh.groups(pm._axes(axes)):
            want = base[group].sum(0)
            for p in group:
                torch.testing.assert_close(out[p], want, rtol=0, atol=1e-6)
                # the sum's transpose: each input's grad sums the group's
                torch.testing.assert_close(xs[p].grad, coef[group].sum(0),
                                           rtol=0, atol=1e-6)
            mx = pm.all_reduce_max([base[p] for p in range(6)], mesh, axes)
            mn = pm.all_reduce_min([base[p] for p in range(6)], mesh, axes)
            assert torch.equal(mx[group[0]], base[group].amax(0))
            assert torch.equal(mn[group[-1]], base[group].amin(0))
        xs = [base[p].clone().requires_grad_() for p in range(6)]
        out = pm.all_gather(xs, mesh, axes, dim=1)
        (sum((o * torch.cat([coef[p]] * (o.shape[1] // 5), 1)).sum()
             for p, o in enumerate(out))).backward()
        for group in mesh.groups(pm._axes(axes)):
            want = torch.cat([base[q] for q in group], 1)
            for i, p in enumerate(group):
                assert torch.equal(out[p], want)
                # a reduce-scatter: block i's grad sums what each member
                # multiplied it by
                torch.testing.assert_close(
                    xs[p].grad, coef[group].sum(0), rtol=0, atol=1e-6)


def test_collectives_are_out_of_place_and_share_a_device_result():
    mesh = _mesh((1, 2))
    xs = [torch.ones(3), torch.full((3,), 2.0)]
    out = pm.all_reduce_sum(xs, mesh, "model")
    assert out[0] is out[1] and torch.equal(out[0], torch.full((3,), 3.0))
    assert torch.equal(xs[0], torch.ones(3))       # inputs untouched
    x = pm.Sharded((3,), P(), mesh, xs)
    s = pm.replica_group_sum(x)
    assert torch.equal(s.blocks[0], s.blocks[1]) and s.blocks[0] is not xs[0]


# --- the sharded loss and step ----------------------------------------------------------

# the meshes every family's step is held on (smollm_360m's cases are in
# test_torch_mesh_smollm.py, the state-space families' in
# test_torch_mesh_ssm.py: a file goes whole to one test worker)
MESHES = [((4, 2), "fsdp_tp"), ((2, 2), "tp"), ((1, 4), "tp"),
          ((2, 1), "fsdp_tp"), ((2, 2, 1), "fsdp_tp")]
CASES = [("qwen1_5_0_5b", shape, policy) for shape, policy in MESHES]


def _both(cfg, mesh, seed):
    flat = _numpy_params(cfg, seed)
    single = bridge.params_from_numpy(cfg, flat, "cpu")
    return single, bridge.sharded_params_from_numpy(cfg, flat, mesh)


def _check_grads(got, want):
    g = _flat(pm.unshard_tree(got, "cpu"))
    for k, w in _flat(want).items():
        err = (g[k] - w).abs().max().item()
        assert err <= GRAD_TOL * w.abs().max().item(), (k, err)


def step_matches_single_device(cfg, shape, weights, micro_batch,
                               adam_bound=None):
    """Loss, gradients, one step's params, and 3 steps' replicas, against
    ``make_train_step`` on the same weights and batches.  micro_batch 3
    divides no dp axis: the batch is replicated and its loss counted once;
    only the first dp position's sequences have masked labels.  With
    ``adam_bound``, a param whose one-device gradient is near zero (at
    most 1e-4 of its leaf's max |g|) is held to it instead: AdamW's first
    step moves it by lr g / (|g| + eps), anywhere in (-lr, lr) for a |g|
    near eps, whatever order its sums took (``test_torch_train``)."""
    mesh = _mesh(shape)
    single, sharded = _both(cfg, mesh, seed=1)
    batch = _batch(cfg, 2, 2, micro_batch)
    wl, wg = tts.loss_and_grads(cfg, single, batch, micro_weights=weights)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh,
                                micro_weights=weights)
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_RTOL)
    _check_grads(gg, wg)
    _assert_replicas_equal(gg, "grad")
    near = {k: (g.abs() <= 1e-4 * g.abs().max()).numpy()
            for k, g in _flat(wg).items()} if adam_bound else {}

    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=1.0)
    s_single = topt.init_state(single)
    s_sharded = topt.init_sharded_state(sharded)
    one = tts.make_train_step(cfg, ocfg, micro_weights=weights)
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, micro_batch,
                              micro_weights=weights)
    for i in range(3):
        b = batch if i == 0 else _batch(cfg, 10 + i, 2, micro_batch)
        single, s_single, m1 = one(single, s_single, b)
        sharded, s_sharded, m2 = step(sharded, s_sharded, b)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(float(m2["grad_norm"]),
                                       float(m1["grad_norm"]), rtol=1e-5)
            assert float(m2["lr"]) == float(m1["lr"])
            got = _flat(pm.unshard_tree(sharded, "cpu"))
            for k, w in _flat(single).items():
                g, w = got[k].numpy(), w.numpy()
                if k in near:
                    m = near[k]
                    assert np.abs(g[m] - w[m]).max(initial=0) <= \
                        adam_bound, k
                    g, w = g[~m], w[~m]
                np.testing.assert_allclose(g, w, rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=k)
    _assert_replicas_equal(sharded, "params")
    _assert_replicas_equal(s_sharded["m"], "m")
    _assert_replicas_equal(s_sharded["v"], "v")
    assert [int(s) for s in s_sharded["step"].blocks] == [3] * mesh.size


@pytest.mark.parametrize("micro_batch", [4, 3])
@pytest.mark.parametrize("weights", [None, (2 / 3, 1 / 3)])
@pytest.mark.parametrize("arch,shape,policy", CASES)
def test_sharded_step_matches_single_device(arch, shape, policy, weights,
                                            micro_batch):
    step_matches_single_device(_cfg(arch, policy), shape, weights,
                               micro_batch)


def test_loss_counts_each_token_once():
    """A microbatch whose dp positions count 6 and 12 tokens: the loss is
    the global sum over the global count, not the mean of the shards'
    means (which differs)."""
    cfg = _cfg("smollm_360m", "tp")
    mesh = _mesh((2, 2))
    single, sharded = _both(cfg, mesh, seed=3)
    b = _batch(cfg, 4, 1, 2)
    mb = {k: v[0] for k, v in b.items()}
    mb_t = {k: torch.as_tensor(v) for k, v in mb.items()}
    loss, met = tm.loss_fn(cfg, sharded, mb_t, mesh=mesh)
    want, wmet = tm.loss_fn(cfg, single, mb_t)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    assert int(met["tokens"]) == int(wmet["tokens"]) == 18
    assert float(met["accuracy"]) == float(wmet["accuracy"])
    halves = [tm.loss_fn(cfg, single, {k: v[i:i + 1] for k, v in
                                       mb_t.items()})[0] for i in range(2)]
    assert abs(float(sum(halves)) / 2 - float(want)) > 1e-3


@pytest.mark.parametrize("remat,impl", [("full", "kernel"), ("dots", "naive"),
                                        ("none", "chunked")])
def test_sharded_step_remat_and_kernel_paths(remat, impl):
    """``cfg.remat`` checkpoints each lockstep layer; ``attn_impl="kernel"``
    runs the kernels' plain versions on the local blocks (the fused norm
    at the seam)."""
    cfg = _cfg("smollm_360m", "fsdp_tp", remat=remat, attn_impl=impl)
    mesh = _mesh((2, 2))
    single, sharded = _both(cfg, mesh, seed=5)
    batch = _batch(cfg, 6, 2, 4)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_RTOL)
    _check_grads(gg, wg)


@pytest.mark.parametrize("policy,shape,heads,kv", [
    ("tp", (1, 2), 12, 3),          # 6 query heads a position over 3 KV
    ("replicated", (2, 2), 4, 2),   # wq sliced a position, logits split
    ("tp", (1, 3), 4, 2)])          # nothing divides 3: all replicated
def test_sharded_loss_on_uneven_layouts(policy, shape, heads, kv):
    cfg = _cfg("smollm_360m", policy, n_heads=heads, n_kv_heads=kv)
    mesh = _mesh(shape)
    single, sharded = _both(cfg, mesh, seed=7)
    batch = _batch(cfg, 8, 2, 2)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_RTOL)
    _check_grads(gg, wg)
    _assert_replicas_equal(gg, "grad")


def test_sharded_opt_state_crosses_bridge_both_ways():
    cfg = _cfg("qwen1_5_0_5b", "fsdp_tp")
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(0)
    flat = {f"{part}/{k}": rng.standard_normal(v.shape).astype(np.float32)
            for k, v in _numpy_params(cfg, 0).items() for part in "mv"}
    flat["step"] = np.asarray(7, np.int32)
    state = bridge.sharded_opt_state_from_numpy(cfg, flat, mesh)
    assert state["step"].spec == () and len(state["step"].blocks) == 4
    back = bridge.sharded_opt_state_to_numpy(state)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_mesh_arguments_refused():
    cfg = _cfg("smollm_360m", "tp")
    mesh = _mesh((1, 2))
    _, sharded = _both(cfg, mesh, seed=0)
    batch = _batch(cfg, 0, 1, 2)
    with pytest.raises(TypeError, match="Mesh"):
        tts.jit_train_step(cfg, topt.OptimizerConfig(), object(), 1, 2)
    with pytest.raises(TypeError, match="Mesh"):
        tts.make_train_step(cfg, topt.OptimizerConfig(), mesh={"model": 2})
    step = tts.jit_train_step(cfg, topt.OptimizerConfig(), mesh, 1, 2)
    with pytest.raises(ValueError, match="made for"):
        step(sharded, topt.init_sharded_state(sharded),
             _batch(cfg, 0, 2, 2))
    # a 'data' axis of size 1 divides any batch, as in the reference
    assert step.batch_specs == {"tokens": P(None, "data", None),
                                "labels": P(None, "data", None)}
    assert step.param_specs["embed"] == ("model", None)


def test_batch_shardings_match_reference_layout():
    cfg = _cfg("smollm_360m", "fsdp_tp")
    got = tts.batch_shardings(cfg, _mesh((2, 2, 1)), 2, 8)
    assert got == {"tokens": (None, ("pod", "data"), None),
                   "labels": (None, ("pod", "data"), None)}
    got = tts.batch_shardings(cfg, _mesh((4, 2)), 2, 6)
    assert got["tokens"] == (None, None, None)
    # a replicated batch counts once, a split one on each dp position
    assert spmd.loss_owners(_mesh((4, 2)), ()) == [0]
    assert spmd.loss_owners(_mesh((4, 2)), ("data",)) == [0, 2, 4, 6]
    assert spmd.loss_owners(_mesh((2, 2, 1)), ("data",)) == [0, 1]
