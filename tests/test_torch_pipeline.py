"""The port's MPMD pipeline (``repro_torch/dist/pipeline.py``) vs the
reference's, on the CPU (mesh stages on ``[cpu] * n`` positions).

The reference's ``MPMDPipeline.train_step`` does not run on this jax
(``ROADMAP.md`` §3, R2), but its stage functions do: the port's stage
programs are held against ``_stage_apply`` / ``_stage_loss`` under
``jax.vjp`` / ``jax.value_and_grad`` and against ``optimizer.apply_updates``
(1e-5), and the port's whole pipeline against the port's single-device
``make_train_step`` (itself held against the reference in
``test_torch_train.py``), on the same seeded numpy weights.  AdamW clips
each stage's gradients by the stage's own norm (the reference's
per-stage optimizer), so where updated params are compared the clip is
off (``grad_clip=0``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.planner.plan import BatchAssignment as JAssign
from repro.dist import pipeline as jpl
from repro.dist.sharding import Decl as JDecl
from repro.train import optimizer as jopt
from repro.models import model as jm
from repro.train.checkpoint import _flatten, _unflatten
from repro_torch import bridge
from repro_torch import graphs
from repro_torch.core.planner.plan import BatchAssignment, ReplicaBatch
from repro_torch.dist import pipeline as tpl
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.dist.sharding import batch_spec, iter_decls, param_specs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_model import configs, numpy_params

TOL = 1e-5
# params after a step on a mesh (test_torch_mesh.py; the reference's own
# sharded test, tests/test_distributed.py:100-101)
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4
CPU = torch.device("cpu")


def _cfgs(n_layers=4, **kw):
    return configs("smollm_360m", n_layers=n_layers, tie_embeddings=False,
                   **kw)


def _batch(cfg, n_micro, mbs, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (n_micro, mbs, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# --- stages and their declarations -------------------------------------------------

@pytest.mark.parametrize("tps", [[1], [1, 1], [2, 1, 1], [1, 1, 1, 1],
                                 [4, 2]])
def test_even_stages_and_stage_decls_equal(tps):
    jcfg, tcfg = _cfgs(n_layers=7)
    js, ts = jpl.even_stages(jcfg, tps, dp=2), tpl.even_stages(tcfg, tps,
                                                               dp=2)
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    assert [(s.n_layers, s.n_devices) for s in ts] == \
        [(s.n_layers, s.n_devices) for s in js]
    for j, t in zip(js, ts):
        jd = {"/".join(str(p.key) for p in path): d
              for path, d in jax.tree_util.tree_flatten_with_path(
                  jpl.stage_decls(jcfg, j),
                  is_leaf=lambda x: isinstance(x, JDecl))[0]}
        td = dict(iter_decls(tpl.stage_decls(tcfg, t)))
        assert {k: dataclasses.asdict(d) for k, d in td.items()} == \
            {k: dataclasses.asdict(d) for k, d in jd.items()}


def test_even_stages_refuses_more_stages_than_layers():
    _, tcfg = _cfgs(n_layers=2)
    with pytest.raises(ValueError, match="3 stages for 2 layers"):
        tpl.even_stages(tcfg, [1, 1, 1])


# --- the stage programs against the reference's stage functions --------------------

def _stage_inputs(jcfg, st, mbs=2, seq=16, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, jcfg.vocab_size, (mbs, seq)).astype(np.int32)
         if st.first else
         rng.standard_normal((mbs, seq, jcfg.d_model)).astype(np.float32))
    y = (rng.integers(0, jcfg.vocab_size, (mbs, seq)).astype(np.int32)
         if st.last else
         rng.standard_normal((mbs, seq, jcfg.d_model)).astype(np.float32))
    return x, y


def _both_stage_params(jcfg, tcfg, st, seed=5):
    flat = numpy_params(jcfg, seed)
    full_t = bridge.params_from_numpy(tcfg, flat, device="cpu")
    full_j = jax.tree.map(jnp.asarray, _unflatten(jm.decls(jcfg), flat))
    return (jpl._slice_full_params(full_j, st),
            tpl._slice_full_params(full_t, st, CPU))


def _grads_flat(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("tps", [[1], [1, 1, 1]])
def test_stage_programs_match_the_reference(remat, tps):
    """Each stage's forward, backward (bwd_first, bwd_mid, bwd_last; the
    single stage's bwd_last on tokens) and update against the reference's
    ``_stage_apply`` / ``_stage_loss`` under ``jax.vjp`` /
    ``jax.value_and_grad`` and ``apply_updates``, fp32, 1e-5."""
    jcfg, tcfg = _cfgs(remat=remat)
    ocfg_j = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    ocfg_t = topt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    for js, ts in zip(jpl.even_stages(jcfg, tps), tpl.even_stages(tcfg, tps)):
        jp, tp = _both_stage_params(jcfg, tcfg, js)
        x, y = _stage_inputs(jcfg, js)
        progs = tpl.stage_programs(tcfg, ts, ocfg_t)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        apply_ = lambda p, xx, js=js: jpl._stage_apply(jcfg, js, p, xx)  # noqa: E731

        got = progs["fwd"](tp, tx)
        _close(got, apply_(jp, jnp.asarray(x)), f"stage {js.index} fwd")

        out = progs["bwd"](tp, tx, ty)
        if js.last:
            loss_ = lambda p, xx, ll, js=js: jpl._stage_loss(  # noqa: E731
                jcfg, js, p, xx, ll)
            if js.first:
                wl, wg = jax.value_and_grad(loss_)(jp, jnp.asarray(x),
                                                   jnp.asarray(y))
                wx = None
            else:
                wl, (wg, wx) = jax.value_and_grad(loss_, argnums=(0, 1))(
                    jp, jnp.asarray(x), jnp.asarray(y))
            tl, tg, tgx = out
            _close(tl, wl, "loss")
            assert (tgx is None) == (wx is None)
            if wx is not None:
                _close(tgx, wx, "gx")
        elif js.first:
            _, vjp = jax.vjp(lambda p: apply_(p, jnp.asarray(x)), jp)
            (wg,) = vjp(jnp.asarray(y))
            tg = out
        else:
            _, vjp = jax.vjp(apply_, jp, jnp.asarray(x))
            wg, wx = vjp(jnp.asarray(y))
            tg, tgx = out
            _close(tgx, wx, "gx")
        want = _grads_flat(wg)
        got = dict(graphs.tree_leaves(tg))
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], f"stage {js.index} grad {k}")

        # the in-place update against the reference's, on the same grads
        # (AdamW's first step is ~ lr sign(g): it would magnify rounding)
        to = topt.init_state(tp)
        step0 = to["step"]
        same = topt.tree_unflatten((k, torch.from_numpy(np.array(v)))
                                   for k, v in want.items())
        assert progs["update"](tp, to, same) is None
        assert to["step"] is step0 and int(step0) == 1
        jnew, _, _ = jopt.apply_updates(jp, wg, jopt.init_state(jp), ocfg_j)
        jnew = _grads_flat(jnew)
        for k, t in graphs.tree_leaves(tp):
            _close(t, jnew[k], f"stage {js.index} updated {k}")


# --- the pipeline against the single-device step -----------------------------------

def _full(tcfg, jcfg, seed=9):
    return bridge.params_from_numpy(tcfg, numpy_params(jcfg, seed),
                                    device="cpu")


def _param_err(pipe, full):
    """Max |pipeline param - full param| over every stage's slice."""
    worst = 0.0
    for st, p in zip(pipe.stages, pipe.params):
        for k, t in graphs.tree_leaves(p):
            if k.startswith("layers/"):
                w = full["layers"][k[len("layers/"):]][st.start:st.stop]
            else:
                w = full[k]
            worst = max(worst, (t - w).abs().max().item())
    return worst


@pytest.mark.parametrize("n_stages", [2, 3])
def test_pipeline_matches_the_single_device_step(n_stages):
    """Two steps on ``[cpu] * n``: the loss within 1e-5 of
    ``make_train_step``'s at every step, the params after each within
    1e-5, and ``full`` (the loaded tree) never written."""
    jcfg, tcfg = _cfgs()
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    full = _full(tcfg, jcfg)
    before = {k: v.clone() for k, v in graphs.tree_leaves(full)}
    pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1] * n_stages),
                            ocfg, devices=["cpu"] * n_stages)
    assert pipe.full_params_like(full) is full
    ref = _full(tcfg, jcfg)
    state = topt.init_state(ref)
    step = tts.make_train_step(tcfg, ocfg)
    for i in range(2):
        batch = _batch(tcfg, 2, 2, 16, seed=i)
        loss = pipe.train_step(batch)
        _, _, m = step(ref, state, batch)
        assert isinstance(loss, float)
        assert abs(loss - m["loss"].item()) <= TOL * abs(loss), (i, loss)
        assert _param_err(pipe, ref) <= TOL, i
    assert all(torch.equal(v, before[k])
               for k, v in graphs.tree_leaves(full))
    assert [int(o["step"]) for o in pipe.opt_states] == [2] * n_stages


def test_pipeline_grads_match_loss_and_grads():
    """``grad_step`` (no update) gives ``loss_and_grads``' loss and each
    stage's slice of its gradients (fp32 buffers), clip on or off."""
    jcfg, tcfg = _cfgs()
    full = _full(tcfg, jcfg)
    pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1, 1]),
                            topt.OptimizerConfig(), devices=["cpu", "cpu"])
    pipe.full_params_like(full)
    batch = _batch(tcfg, 3, 2, 16)
    loss, grads = pipe.grad_step(batch)
    wl, wg = tts.loss_and_grads(tcfg, full, batch)
    assert abs(loss - wl.item()) <= TOL * abs(loss)
    flat = dict(graphs.tree_leaves(wg))
    for st, g in zip(pipe.stages, grads):
        for k, t in graphs.tree_leaves(g):
            assert t.dtype == torch.float32
            w = flat[k][st.start:st.stop] if k.startswith("layers/") \
                else flat[k]
            _close(t, w, k)


def test_uniform_weights_equal_no_weights():
    jcfg, tcfg = _cfgs(n_layers=2)
    batch = _batch(tcfg, 4, 2, 8)
    out = []
    for weights in (None, [0.25] * 4):
        pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1, 1]),
                                topt.OptimizerConfig(),
                                devices=["cpu", "cpu"])
        pipe.full_params_like(_full(tcfg, jcfg))
        loss, grads = pipe.grad_step(batch, weights=weights)
        out.append((loss, [{k: t.clone() for k, t in graphs.tree_leaves(g)}
                           for g in grads]))
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        for k in a:
            _close(a[k], b[k].numpy(), k, tol=1e-6)
    pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1, 1]),
                            topt.OptimizerConfig(), devices=["cpu", "cpu"])
    pipe.full_params_like(_full(tcfg, jcfg))
    with pytest.raises(ValueError, match="does not match 4 microbatches"):
        pipe.grad_step(batch, weights=[0.5, 0.5])


def test_init_params_draws_each_stage_from_its_own_generator():
    _, tcfg = _cfgs()
    stages = tpl.even_stages(tcfg, [1, 1])
    a, b, c = (tpl.MPMDPipeline(tcfg, stages, topt.OptimizerConfig(),
                                devices=["cpu", "cpu"]) for _ in range(3))
    a.init_params(0)
    b.init_params(0)
    c.init_params(1)
    for st, p, q, r in zip(stages, a.params, b.params, c.params):
        shapes = {k: d.shape
                  for k, d in iter_decls(tpl.stage_decls(tcfg, st))}
        assert {k: tuple(t.shape) for k, t in graphs.tree_leaves(p)} == \
            shapes
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
            graphs.tree_leaves(p), graphs.tree_leaves(q)))
        assert not torch.equal(p["layers"]["wq"], r["layers"]["wq"])
    assert not torch.equal(a.params[0]["layers"]["wq"],
                           a.params[1]["layers"]["wq"])
    assert a.train_step(_batch(tcfg, 2, 2, 8)) > 0


# --- the adaptive DP group ------------------------------------------------------------

def _group_run(tcfg, jcfg, assignment, staleness=0, steps=3):
    reps = []
    for _ in range(len(assignment.replicas)):
        pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1, 1]),
                                topt.OptimizerConfig(lr=1e-3),
                                devices=["cpu", "cpu"])
        pipe.full_params_like(_full(tcfg, jcfg, seed=7))
        reps.append(pipe)
    group = tpl.AdaptiveDPGroup.from_assignment(reps, assignment,
                                                staleness=staleness)
    rng = np.random.default_rng(0)
    t = rng.integers(0, tcfg.vocab_size, (8, 17)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    losses = [group.train_step(tpl.shard_batch_by_assignment(batch,
                                                             assignment))
              for _ in range(steps)]
    return losses, group


def test_adaptive_group_is_deterministic_and_tracks_uniform():
    """The reference's ``test_adaptive.py`` scenario (2-stage replicas of
    a 4-layer model, one repeated batch of 8) on the CPU with fewer
    steps: staleness 0 repeats bit for bit, and a 2:1 assignment tracks
    the uniform one (fp association only) and learns."""
    jcfg, tcfg = _cfgs()
    uni = BatchAssignment.uniform(dp=2, mbs=4, n_micro=1)
    l_uni, g_uni = _group_run(tcfg, jcfg, uni)
    l_again, _ = _group_run(tcfg, jcfg, uni, staleness=0)
    assert l_uni == l_again
    ad = BatchAssignment(replicas=(ReplicaBatch(6, 1), ReplicaBatch(2, 1)))
    ad.validate(8)
    l_ad, g_ad = _group_run(tcfg, jcfg, ad)
    for a, b in zip(l_uni, l_ad):
        assert abs(a - b) < 1e-4 * abs(a), (l_uni, l_ad)
    assert l_ad[-1] < l_ad[0]
    # every replica holds the same params after the combined updates
    for rep in g_ad.replicas[1:]:
        for p, q in zip(rep.params, g_ad.replicas[0].params):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
                graphs.tree_leaves(p), graphs.tree_leaves(q)))


def test_adaptive_group_staleness_and_flush():
    """Staleness 1: the first step applies nothing, each later one the
    previous step's gradient, and ``flush`` drains the last one."""
    jcfg, tcfg = _cfgs(n_layers=2)
    uni = BatchAssignment.uniform(dp=2, mbs=4, n_micro=1)
    losses, group = _group_run(tcfg, jcfg, uni, staleness=1, steps=2)
    assert losses[0] == losses[1]          # nothing applied after step 1
    assert [int(o["step"]) for o in group.replicas[0].opt_states] == [1, 1]
    assert group.flush() == 1 and group.flush() == 0
    assert [int(o["step"]) for o in group.replicas[0].opt_states] == [2, 2]
    with pytest.raises(ValueError, match="staleness"):
        tpl.AdaptiveDPGroup(group.replicas, staleness=-1)
    with pytest.raises(ValueError, match="1 batches for 2 replicas"):
        group.train_step([{}])


def test_adaptive_combine_sums_in_replica_order():
    g = [[{"a": torch.tensor([1.0, 2.0])}],
         [{"a": torch.tensor([0.5, 0.25], dtype=torch.bfloat16)}]]
    out = tpl.AdaptiveDPGroup._combine(g)
    assert out[0]["a"].dtype == torch.float32
    assert out[0]["a"].tolist() == [1.5, 2.25]
    assert g[0][0]["a"].tolist() == [1.0, 2.0]      # inputs untouched


@pytest.mark.parametrize("as_tensor", [False, True])
def test_shard_batch_by_assignment_equal(as_tensor):
    batch = {"tokens": np.arange(24 * 4).reshape(24, 4),
             "labels": np.arange(24 * 4).reshape(24, 4) + 1000}
    for t, j in ((BatchAssignment.proportional([2.0, 1.0], 24, 2),
                  JAssign.proportional([2.0, 1.0], 24, 2)),
                 (BatchAssignment.uniform(3, 2, 4),
                  JAssign.uniform(3, 2, 4))):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()} \
            if as_tensor else batch
        got = tpl.shard_batch_by_assignment(tb, t)
        want = jpl.shard_batch_by_assignment(
            {k: jnp.asarray(v) for k, v in batch.items()}, j)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                gv = g[k].numpy() if as_tensor else g[k]
                np.testing.assert_array_equal(gv, np.asarray(w[k]))


# --- what raises -------------------------------------------------------------------

def test_pipeline_refusals(monkeypatch):
    jcfg, tcfg = _cfgs()
    ocfg = topt.OptimizerConfig()
    st = tpl.even_stages(tcfg, [1, 1])
    cpu2 = ["cpu", "cpu"]
    with pytest.raises(ValueError, match="graphed=True.*stage 0 is a mesh"):
        tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [2, 1]), ocfg,
                         devices=["cpu"] * 3, graphed=True)
    with pytest.raises(ValueError, match="plan needs 4 devices, have 3"):
        tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [1, 1], dp=2), ocfg,
                         devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="tied embeddings"):
        tpl.MPMDPipeline(dataclasses.replace(tcfg, tie_embeddings=True),
                         st, ocfg, devices=cpu2)
    with pytest.raises(NotImplementedError, match="'ssm'"):
        tpl.MPMDPipeline(dataclasses.replace(tcfg, family="ssm"), st, ocfg,
                         devices=cpu2)
    with pytest.raises(ValueError, match="do not cover"):
        tpl.MPMDPipeline(tcfg, st[:1], ocfg, devices=cpu2)
    with pytest.raises(ValueError, match="not contiguous"):
        tpl.MPMDPipeline(tcfg, [st[0], dataclasses.replace(st[1], start=3)],
                         ocfg, devices=cpu2)
    with pytest.raises(ValueError, match="flags"):
        tpl.MPMDPipeline(tcfg, [st[0], dataclasses.replace(st[1],
                                                           last=False)],
                         ocfg, devices=cpu2)
    with pytest.raises(KeyError, match="unknown sharding policy"):
        tpl.MPMDPipeline(tcfg, st, ocfg, devices=cpu2, policy="zero3")
    with pytest.raises(ValueError, match="plan needs 2 devices, have 1"):
        tpl.MPMDPipeline(tcfg, st, ocfg, devices=["cpu"])
    with pytest.raises(ValueError, match="graphed=True"):
        tpl.MPMDPipeline(tcfg, st, ocfg, devices=cpu2, graphed=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.MPMDPipeline(tcfg, st, ocfg)
    pipe = tpl.MPMDPipeline(tcfg, st, ocfg, devices=cpu2, policy="replicated")
    with pytest.raises(RuntimeError, match="load parameters first"):
        pipe.train_step(_batch(tcfg, 1, 1, 8))
    assert pipe.graphs == []
    pipe.full_params_like(_full(tcfg, jcfg))
    assert pipe.graphs == [None, None]       # the CPU runs eagerly


# --- mesh stages (tp > 1 or dp > 1 inside a stage) ----------------------------------

def _summed(grads, params):
    """A mesh stage's block gradients (None where no counted position read
    the block) summed over their replicas, gathered whole."""
    flat = dict(pm.tree_items(params))
    return {k: pm.unshard(pm.replica_group_sum(x.with_blocks([
        torch.zeros_like(b) if g is None else g
        for g, b in zip(x.blocks, flat[k].blocks)])), "cpu")
        for k, x in pm.tree_items(grads)}


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_mesh_stage_programs_match_the_reference(dp, tp):
    """Each stage's programs on a (dp, tp) mesh of CPU positions, unsharded
    (block gradients summed over their replicas; the input's gradient
    summed over 'model'), against the reference's ``_stage_apply`` /
    ``_stage_loss`` under ``jax.vjp`` / ``jax.value_and_grad``, 1e-5;
    and the update (``apply_sharded_updates``) against its
    ``apply_updates``."""
    jcfg, tcfg = _cfgs(n_layers=3, remat="full")
    ocfg_j = jopt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    ocfg_t = topt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    mesh = data_model_mesh(dp, tp, [CPU] * (dp * tp))
    for js, ts in zip(jpl.even_stages(jcfg, [tp] * 3, dp=dp),
                      tpl.even_stages(tcfg, [tp] * 3, dp=dp)):
        jp, tp_full = _both_stage_params(jcfg, tcfg, js)
        params = pm.shard_tree(tp_full, param_specs(
            tpl.stage_decls(tcfg, ts), "fsdp_tp", mesh), mesh)
        x, y = _stage_inputs(jcfg, js)
        lay = lambda a: pm.shard(torch.from_numpy(a),  # noqa: E731
                                 batch_spec(mesh, a.shape[0]), mesh)
        progs = tpl.mesh_stage_programs(tcfg, ts, ocfg_t, mesh)
        apply_ = lambda p, xx, js=js: jpl._stage_apply(jcfg, js, p, xx)  # noqa: E731
        out = progs["fwd"](params, lay(x))
        _close(pm.unshard(out, "cpu"), apply_(jp, jnp.asarray(x)),
               f"stage {js.index} fwd")
        if js.last:
            loss_ = lambda p, xx, ll, js=js: jpl._stage_loss(  # noqa: E731
                jcfg, js, p, xx, ll)
            wl, (wg, wx) = jax.value_and_grad(loss_, argnums=(0, 1))(
                jp, jnp.asarray(x), jnp.asarray(y))
            tl, tg, tgx = progs["bwd"](params, lay(x), lay(y))
            _close(tl, wl, "loss")
        elif js.first:
            _, vjp = jax.vjp(lambda p: apply_(p, jnp.asarray(x)), jp)
            (wg,) = vjp(jnp.asarray(y))
            tg, tgx, wx = progs["bwd"](params, lay(x), lay(y)), None, None
        else:
            _, vjp = jax.vjp(apply_, jp, jnp.asarray(x))
            wg, wx = vjp(jnp.asarray(y))
            tg, tgx = progs["bwd"](params, lay(x), lay(y))
        if wx is not None:
            _close(pm.unshard(tgx, "cpu"), wx, f"stage {js.index} gx")
        want = _grads_flat(wg)
        got = _summed(tg, params)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], f"stage {js.index} grad {k}")
        state = topt.init_sharded_state(params)
        grads = pm.shard_tree(topt.tree_unflatten(
            (k, torch.from_numpy(np.array(v))) for k, v in want.items()),
            param_specs(tpl.stage_decls(tcfg, ts), "fsdp_tp", mesh), mesh)
        assert progs["update"](params, state, grads) is None
        jnew = _grads_flat(jopt.apply_updates(jp, wg, jopt.init_state(jp),
                                              ocfg_j)[0])
        for k, t in pm.tree_items(params):
            _close(pm.unshard(t, "cpu"), jnew[k], f"updated {k}")


def test_input_grad_sums_over_model_not_data():
    """A stage input's gradient: each position's share summed over its
    'model' group in group order (None as zero); the 'data' positions,
    which hold other sequences, are never added."""
    mesh = data_model_mesh(2, 2, [CPU] * 4)
    x = pm.shard(torch.zeros(4, 3, 2), batch_spec(mesh, 4), mesh)
    shares = [torch.full((2, 3, 2), float(10 ** p)) for p in range(4)]
    got = tpl._input_grad(x, shares)
    assert [b[0, 0, 0].item() for b in got.blocks] == [11.0, 11.0,
                                                       1100.0, 1100.0]
    got = tpl._input_grad(x, [shares[0], None, None, shares[3]])
    assert [b[0, 0, 0].item() for b in got.blocks] == [1.0, 1.0,
                                                       1000.0, 1000.0]
    full = pm.unshard(got, "cpu")
    assert full[:2].eq(1.0).all() and full[2:].eq(1000.0).all()


def _mesh_pipe(tcfg, tps, dp, ocfg, full, policy="fsdp_tp"):
    stages = tpl.even_stages(tcfg, tps, dp=dp)
    pipe = tpl.MPMDPipeline(tcfg, stages, ocfg, policy=policy,
                            devices=["cpu"] * sum(s.n_devices
                                                  for s in stages))
    pipe.full_params_like(full)
    return pipe


def _stage_params_full(pipe):
    """Every stage's params gathered whole, keyed like the full tree's
    slices: {(stage, path): tensor}."""
    return {(st.index, k): tpl._full(t) for st, p in zip(pipe.stages,
                                                         pipe.params)
            for k, t in pm.tree_items(p)}


@pytest.mark.parametrize("tps,dp,policy", [([4, 2], 1, "fsdp_tp"),
                                           ([2, 1], 2, "fsdp_tp"),
                                           ([2, 2], 2, "tp")])
def test_mesh_stage_pipeline_matches_one_device_and_single_step(tps, dp,
                                                                policy):
    """The reference's heterogeneous ``tps=[4, 2]`` case
    (``tests/test_distributed.py:41-68``) and ``[2, 1]`` at dp 2 on CPU
    positions, from the same weights as the ``[1, 1]`` pipeline and
    ``make_train_step``: the first step's loss (1e-5) and every stage's
    gradients (1e-5 of max |g|) against ``loss_and_grads`` and the ``[1,
    1]`` pipeline's, the params after that step (clip off) at the mesh
    tests' bounds (``test_torch_mesh.py``), then the second step's loss,
    against both.  The params take the reference's sharded test's rtol
    2e-3 / atol 2e-4, not 1e-5:
    AdamW's first step is ~lr sign(g), so an element whose gradient is
    near zero moves by up to ~lr whatever the summation order did to it.
    Every replica of a block stays bit for bit equal."""
    jcfg, tcfg = _cfgs()
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    full = _full(tcfg, jcfg)
    pipe = _mesh_pipe(tcfg, tps, dp, ocfg, full, policy)
    assert [dict(m.shape) for m in pipe.meshes] == \
        [{"data": dp, "model": tp} for tp in tps]
    one = _mesh_pipe(tcfg, [1, 1], 1, ocfg, full)
    batch = _batch(tcfg, 2, 4, 16)
    loss, grads = pipe.grad_step(batch)
    l1, g1 = one.grad_step(batch)
    wl, wg = tts.loss_and_grads(tcfg, full, batch)
    assert abs(loss - wl.item()) <= TOL * abs(loss)
    assert abs(loss - l1) <= TOL * abs(loss)
    flat = dict(graphs.tree_leaves(wg))
    for st, g, h in zip(pipe.stages, grads, g1):
        ones = dict(graphs.tree_leaves(h))
        for k, x in pm.tree_items(g):
            t = tpl._full(x)
            w = flat[k][st.start:st.stop] if k.startswith("layers/") \
                else flat[k]
            _close(t, w, f"stage {st.index} grad {k}")
            _close(t, ones[k].numpy(), f"stage {st.index} grad {k} vs [1, 1]")
    pipe.apply_grads(grads)
    one.apply_grads(g1)
    ref = _full(tcfg, jcfg)
    state = topt.init_state(ref)
    step = tts.make_train_step(tcfg, ocfg)
    step(ref, state, batch)
    got, ones = _stage_params_full(pipe), _stage_params_full(one)
    assert got.keys() == ones.keys()
    for (i, k), t in got.items():
        st = pipe.stages[i]
        w = ref["layers"][k[len("layers/"):]][st.start:st.stop] \
            if k.startswith("layers/") else ref[k]
        for want in (w, ones[(i, k)]):
            np.testing.assert_allclose(t.numpy(), want.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"stage {i} {k}")
    b2 = _batch(tcfg, 2, 4, 16, seed=1)
    loss2, l2 = pipe.train_step(b2), one.train_step(b2)
    _, _, m = step(ref, state, b2)
    assert abs(loss2 - m["loss"].item()) <= TOL * abs(loss2)
    assert abs(loss2 - l2) <= TOL * abs(loss2)
    for st, p, o in zip(pipe.stages, pipe.params, pipe.opt_states):
        if st.n_devices > 1:
            for _, x in pm.tree_items({"p": p, "m": o["m"], "v": o["v"]}):
                for group in x.mesh.groups(pm.replica_axes(x.spec, x.mesh)):
                    assert all(torch.equal(x.blocks[q], x.blocks[group[0]])
                               for q in group[1:])
            assert [int(s) for s in o["step"].blocks] == [2] * st.n_devices
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        graphs.tree_leaves(full), graphs.tree_leaves(_full(tcfg, jcfg))))


def test_init_params_same_logical_params_for_any_tps():
    """One seed gives the same logical params whatever the stages' (dp,
    tp): each stage draws its full tensors as a one-device stage does,
    then lays them out on its mesh."""
    _, tcfg = _cfgs()
    ocfg = topt.OptimizerConfig()
    seen = []
    for tps, dp in (([1, 1], 1), ([2, 1], 1), ([4, 2], 1), ([1, 2], 2)):
        stages = tpl.even_stages(tcfg, tps, dp=dp)
        pipe = tpl.MPMDPipeline(tcfg, stages, ocfg,
                                devices=["cpu"] * sum(s.n_devices
                                                      for s in stages))
        pipe.init_params(0)
        seen.append(_stage_params_full(pipe))
    for other in seen[1:]:
        assert other.keys() == seen[0].keys()
        assert all(torch.equal(other[k], seen[0][k]) for k in seen[0])


def test_adaptive_group_of_mesh_stage_pipelines_matches_one_device():
    """An ``AdaptiveDPGroup`` of two ``[2, 1]`` pipelines (stage 0 on a
    (1, 2) mesh) under a 2:1 assignment gives the losses and params of the
    same group of ``[1, 1]`` pipelines: the loss 1e-5, the params after
    the step at the mesh bounds."""
    jcfg, tcfg = _cfgs(n_layers=2)
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    ad = BatchAssignment(replicas=(ReplicaBatch(6, 1), ReplicaBatch(2, 1)))
    rng = np.random.default_rng(0)
    t = rng.integers(0, tcfg.vocab_size, (8, 17)).astype(np.int32)
    shards = tpl.shard_batch_by_assignment(
        {"tokens": t[:, :-1], "labels": t[:, 1:]}, ad)
    runs = []
    for tps in ([2, 1], [1, 1]):
        reps = [_mesh_pipe(tcfg, tps, 1, ocfg, _full(tcfg, jcfg, seed=7))
                for _ in range(2)]
        group = tpl.AdaptiveDPGroup.from_assignment(reps, ad)
        losses = [group.train_step(shards)]
        runs.append((losses, [_stage_params_full(r) for r in reps]))
    (lm, pm_), (lo, po) = runs
    for a, b in zip(lm, lo):
        assert abs(a - b) <= TOL * abs(b), (lm, lo)
    for rep_m, rep_o in zip(pm_, po):
        for k in rep_o:
            np.testing.assert_allclose(rep_m[k].numpy(), rep_o[k].numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=str(k))


# --- telemetry (attach_telemetry) ---------------------------------------------------

def _tel_pipe(tcfg, jcfg, tps, full=None, **kw):
    stages = tpl.even_stages(tcfg, tps)
    pipe = tpl.MPMDPipeline(tcfg, stages, topt.OptimizerConfig(lr=1e-3),
                            devices=["cpu"] * sum(s.n_devices
                                                  for s in stages), **kw)
    pipe.full_params_like(_full(tcfg, jcfg) if full is None else full)
    return pipe


@pytest.mark.parametrize("tps", [[2, 2], [1, 1]])
def test_pipeline_emits_telemetry(tps):
    """The reference's ``test_pipeline_emits_telemetry``
    (``tests/test_telemetry.py:406-443``) on the port: ``tps=[2, 2]`` on
    ``[cpu] * 4`` (mesh stages), and ``[1, 1]``; 3 steps of 2
    microbatches: a ``fwd_time`` and ``bwd_time`` sample a microbatch and
    stage, a ``p2p_time`` a microbatch each way, one ``step_time`` and one
    heartbeat a stage a step (``chips`` the stage's positions), the
    zones in the meta."""
    from repro_torch.telemetry import TelemetryBus
    jcfg, tcfg = _cfgs()
    pipe = _tel_pipe(tcfg, jcfg, tps)
    bus = TelemetryBus()
    ends = []
    bus.on_step(lambda step, t: ends.append(step))
    pipe.attach_telemetry(bus)
    NM = 2
    batch = _batch(tcfg, NM, 4, 16)
    for _ in range(3):
        pipe.train_step(batch)
    for i in range(2):
        assert len(bus.values("fwd_time", (i, 0))) == 3 * NM
        assert len(bus.values("bwd_time", (i, 0))) == 3 * NM
        hb = bus.series("heartbeat", (i, 0))
        assert [s.step for s in hb] == [0, 1, 2]
        assert hb[-1].meta == {"zone": f"stage{i}", "acc_type": "host",
                               "chips": tps[i]}
        assert bus.latest("fwd_time", (i, 0)).meta["zone"] == f"stage{i}"
    p2p = bus.series("p2p_time", (0, 1, 0, 0))
    assert len(p2p) == 2 * 3 * NM
    assert {(s.meta["zone"], s.meta["zone_b"]) for s in p2p} == \
        {("stage0", "stage1")}
    assert len(bus.values("step_time", ())) == 3 and ends == [0, 1, 2]
    assert all(v > 0 for v in bus.values("step_time", ()))
    assert all(v > 0 for k in bus.keys("fwd_time")
               for v in bus.values("fwd_time", k))
    assert bus.keys("p2p_time") == [(0, 1, 0, 0)]


@pytest.mark.parametrize("tps", [[1, 1], [2, 1], [1, 1, 1]])
def test_attached_bus_leaves_the_step_bit_for_bit(tps):
    """A bus attached without a fault adds only synchronizations and
    clock reads: the losses, gradients and params of two steps and a
    ``grad_step`` equal a detached pipeline's from the same weights, bit
    for bit."""
    from repro_torch.telemetry import TelemetryBus
    jcfg, tcfg = _cfgs()
    full = _full(tcfg, jcfg)
    off, on = (_tel_pipe(tcfg, jcfg, tps, full) for _ in range(2))
    on.attach_telemetry(TelemetryBus(), zones=[f"z{i}" for i in
                                               range(len(tps))])
    for seed in range(2):
        batch = _batch(tcfg, 2, 4, 16, seed=seed)
        assert on.train_step(batch) == off.train_step(batch)
    batch = _batch(tcfg, 3, 4, 16, seed=5)
    (la, ga), (lb, gb) = on.grad_step(batch), off.grad_step(batch)
    assert la == lb
    for a, b in zip(ga, gb):
        for (ka, xa), (kb, xb) in zip(pm.tree_items(a), pm.tree_items(b)):
            assert ka == kb and torch.equal(tpl._full(xa), tpl._full(xb))
    assert _stage_params_full(on).keys() == _stage_params_full(off).keys()
    assert all(torch.equal(x, _stage_params_full(off)[k])
               for k, x in _stage_params_full(on).items())
    assert on._telemetry.n_samples > 0 and off._telemetry is None


@pytest.mark.parametrize("kind", ["compute_delay", "link_degrade"])
def test_injected_fault_slows_the_stage_samples(kind, monkeypatch):
    """Under an injected fault the affected samples are at least
    ``factor`` x the span measured without the delay (the injector is
    handed that span), the host sleeps the difference, and nothing else
    is delayed."""
    from repro_torch.telemetry import FaultInjector, FaultSpec, TelemetryBus
    jcfg, tcfg = _cfgs(n_layers=2)
    pipe = _tel_pipe(tcfg, jcfg, [1, 1])
    factor, start = 3.0, 1
    spec = FaultSpec("compute_delay", zone="stage1", acc_type="host",
                     start_step=start, factor=factor) \
        if kind == "compute_delay" else \
        FaultSpec("link_degrade", zone="stage0", zone_b="stage1",
                  start_step=start, factor=factor)
    inj = FaultInjector([spec])
    spans, slept = [], []
    real_delay = inj.compute_delay_s

    def delay(step, zone, acc, base_s):
        spans.append((step, zone, base_s))
        return real_delay(step, zone, acc, base_s)

    inj.compute_delay_s = delay
    sleep = tpl.time.sleep
    monkeypatch.setattr(tpl.time, "sleep",
                        lambda s: (slept.append(s), sleep(s)))
    bus = TelemetryBus()
    pipe.attach_telemetry(bus, injector=inj)
    for _ in range(3):
        pipe.train_step(_batch(tcfg, 2, 2, 8))
    metrics = ("fwd_time", "bwd_time") if kind == "compute_delay" \
        else ("p2p_time",)
    hit = [s for m in metrics for k in bus.keys(m)
           for s in bus.series(m, k) if s.step >= start
           and (s.meta["zone"] == "stage1" or m == "p2p_time")]
    assert len(hit) == 2 * 2 * 2
    assert len(slept) == len(hit)
    if kind == "compute_delay":
        base = {(st, z): [] for st, z, _ in spans}
        for st, z, b in spans:
            base[(st, z)].append(b)
        for s in hit:
            # the sample is the span plus the sleep: factor x the span
            assert any(s.value >= factor * b * (1 - 1e-12)
                       for b in base[(s.step, "stage1")])
        assert all(x > 0 for x in slept)
    untouched = [s for m in ("fwd_time", "bwd_time", "p2p_time")
                 for k in bus.keys(m) for s in bus.series(m, k)
                 if s not in hit]
    assert untouched and len(untouched) + len(hit) == \
        sum(len(bus.series(m, k)) for m in ("fwd_time", "bwd_time",
                                            "p2p_time")
            for k in bus.keys(m))
    assert sum(slept) <= sum(bus.values("step_time", ()))


def test_worker_hang_silences_the_heartbeat_until_node_failure():
    """A hung stage stops heartbeating; ``miss_limit`` silent steps later
    ``DetectorBank`` publishes one ``NodeFailure`` through
    ``monitor.observe_failure`` (the snapshot loses the stage's chips),
    and not before."""
    from repro_torch.core.cluster import multi_zone
    from repro_torch.manager import AvailabilityMonitor, EventBus, NodeFailure
    from repro_torch.telemetry import (DetectorBank, FaultInjector,
                                       FaultSpec, TelemetryBus)
    jcfg, tcfg = _cfgs(n_layers=2)
    pipe = _tel_pipe(tcfg, jcfg, [1, 2])
    cluster = multi_zone({"za": ("r", {"host": 1}), "zb": ("r", {"host": 2})})
    bus, events = TelemetryBus(), EventBus()
    monitor = AvailabilityMonitor(cluster, feeds=[], bus=events)
    DetectorBank(bus, events, monitor=monitor, heartbeat_miss=3)
    hang = 2
    pipe.attach_telemetry(bus, zones=("za", "zb"), injector=FaultInjector(
        [FaultSpec("worker_hang", zone="zb", acc_type="host",
                   start_step=hang)]))
    seen = []
    for step in range(7):
        pipe.train_step(_batch(tcfg, 2, 2, 8, seed=step))
        seen.append(len(events.of_type(NodeFailure)))
    beats = {k: [s.step for s in bus.series("heartbeat", k)]
             for k in ((0, 0), (1, 0))}
    assert beats == {(0, 0): list(range(7)), (1, 0): list(range(hang))}
    # silent from step 2: the last beat at step 1, 3 steps missed at 4
    assert seen == [0, 0, 0, 0, 1, 1, 1]
    fail = events.of_type(NodeFailure)[0]
    assert (fail.zone, fail.acc_type, fail.lost, fail.available) == \
        ("zb", "host", 2, 0)
    assert fail.cluster is monitor.current
    assert monitor.current.zone("zb").capacity["host"] == 0
