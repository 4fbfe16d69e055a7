"""The sharded programs' CUDA-graph counterpart of ``jax.jit``, on the CPU:
what a capture needs of the sharded step's device body, and the rule of
``graphed=`` (``train_step.jit_train_step``, ``MPMDPipeline``,
``ElasticTrainer``).

A graph is only captured on a card (``tests/test_torch_gpu.py -k
graphed_mesh``).  Here the device body of the sharded step
(``sharded_train_step_on_device``: the sharded loss and gradients, the
replica sums, the global norm and AdamW) runs under
``test_torch_train._HostSyncGuard``, which raises on what a capture
cannot hold, for every family on (2, 2) ``fsdp_tp`` and (1, 2) ``tp``,
and must give the eager step's results bit for bit: loss, grad norm, lr,
every block of params, ``m``, ``v`` and the step.
"""
import dataclasses

import pytest
import torch

from repro_torch import bridge
from repro_torch import graphs
from repro_torch.configs import get_config
from repro_torch.dist import placement as pm
from repro_torch.dist.mesh import data_model_mesh
from repro_torch.dist.sharding import P
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.elastic import ElasticTrainer, RuntimePlan
from test_torch_mesh import _batch, _mesh, _numpy_params
from test_torch_train import _HostSyncGuard


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# family -> (arch, overrides of its reduced config)
FAMILIES = {
    "dense": ("qwen1_5_0_5b", dict(head_dim=64)),
    "moe": ("dbrx_132b", dict(head_dim=64, n_experts=4,
                              capacity_factor=0.5)),
    "ssm": ("mamba2_130m", {}),
    "hybrid": ("zamba2_2_7b", {}),
    "encdec": ("whisper_tiny", dict(head_dim=16)),
    "vlm": ("internvl2_26b", dict(head_dim=16)),
}
W = (2 / 3, 1 / 3)
# every family on both meshes; each family and each mesh with and without
# micro_weights
BODY_CASES = [(fam, shape, policy, weights)
              for i, fam in enumerate(FAMILIES)
              for j, (shape, policy) in enumerate((((2, 2), "fsdp_tp"),
                                                   ((1, 2), "tp")))
              for weights in ((None if (i + j) % 2 else W),)]


def _cfg(family, policy):
    arch, over = FAMILIES[family]
    return dataclasses.replace(get_config(arch).reduced(), sharding=policy,
                               remat="full", attn_impl="kernel", **over)


def _blocks_equal(a, b, what):
    for (k, x), (_, y) in zip(pm.tree_items(a), pm.tree_items(b),
                              strict=True):
        for p, (u, v) in enumerate(zip(x.blocks, y.blocks, strict=True)):
            assert torch.equal(u, v), f"{what} {k} position {p}"


@pytest.mark.parametrize("family,shape,policy,weights", BODY_CASES)
def test_sharded_device_body_makes_no_host_sync(family, shape, policy,
                                                weights):
    """The device body under ``_HostSyncGuard`` (the batch laid out and
    the weights on the device before it) against ``jit_train_step``'s
    eager step from the same weights on the same batch, bit for bit."""
    cfg = _cfg(family, policy)
    mesh = _mesh(shape)
    flat = _numpy_params(cfg, 5)
    ep, gp = (bridge.sharded_params_from_numpy(cfg, flat, mesh)
              for _ in range(2))
    es, gs = topt.init_sharded_state(ep), topt.init_sharded_state(gp)
    batch = _batch(cfg, 7, 2, 4)
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1)
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4, micro_weights=weights)
    assert step.graphed is False            # CPU positions run eagerly
    _, es, em = step(ep, es, batch)
    sharded = tts.shard_batch(cfg, batch, mesh)
    w = None if weights is None else torch.tensor(weights,
                                                  dtype=torch.float32)
    bound = gs["step"]
    with _HostSyncGuard():
        _, gs, gm = tts.sharded_train_step_on_device(cfg, ocfg, mesh, gp, gs,
                                                     sharded, w)
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(gm[key], em[key]), key
    _blocks_equal(gp, ep, "params")
    _blocks_equal(gs["m"], es["m"], "m")
    _blocks_equal(gs["v"], es["v"], "v")
    _blocks_equal({"s": gs["step"]}, {"s": es["step"]}, "step")
    assert all(int(b) == 0 for b in bound.blocks)   # the eager update's
    assert all(int(b) == 1 for b in gs["step"].blocks)  # new step blocks


# --- the rule of graphed= ---------------------------------------------------------

def test_jit_train_step_graphed_rule_and_refusals():
    """None graphs a mesh of one card only; True raises on CPU positions
    and on positions over several cards, before anything is made (so no
    card is needed here); False runs eagerly."""
    cfg = _cfg("dense", "fsdp_tp")
    ocfg = topt.OptimizerConfig()

    def step(devices, graphed):
        mesh = data_model_mesh(2, 2, devices)
        return tts.jit_train_step(cfg, ocfg, mesh, 2, 4, graphed=graphed)

    assert step(["cuda:0"] * 4, None).graphed is True
    assert step(["cpu"] * 4, None).graphed is False
    assert step(["cuda:0", "cuda:1"] * 2, None).graphed is False
    assert step(["cuda:0"] * 4, False).graphed is False
    assert step(["cuda:0"] * 4, True).graphed is True
    assert step(["cuda:0"] * 4, None).capture_seconds is None
    with pytest.raises(ValueError, match="CUDA device"):
        step(["cpu"] * 4, True)
    with pytest.raises(ValueError, match="more than one card"):
        step(["cuda:0", "cuda:1"] * 2, True)
    with pytest.raises(ValueError, match="more than one card"):
        graphs.one_card(["cuda:0", "cuda:1"], "x")


def test_graphed_sharded_step_refuses_cpu_params():
    cfg = _cfg("dense", "tp")
    mesh = _mesh((1, 2))
    params = bridge.sharded_params_from_numpy(cfg, _numpy_params(cfg, 1),
                                              mesh)
    with pytest.raises(ValueError, match="CUDA"):
        tts.GraphedShardedTrainStep(
            cfg, topt.OptimizerConfig(), mesh, params,
            topt.init_sharded_state(params), _batch(cfg, 1, 2, 4))


def test_graph_binds_every_block_of_a_sharded_tree():
    mesh = _mesh((1, 2))
    x = pm.shard(torch.arange(8.0).reshape(2, 4), P(None, "model"), mesh)
    leaves = graphs.tree_leaves({"a": {"x": x}, "b": torch.ones(1)})
    assert [k for k, _ in leaves] == ["a/x[0]", "a/x[1]", "b"]
    assert leaves[0][1] is x.blocks[0] and leaves[1][1] is x.blocks[1]


def test_a_capture_records_apart_and_a_replay_adds_to_every_record():
    """``record_apart`` (what a capture runs its body under) keeps its
    entries from the records active around it; ``add_to_records`` (what
    a replay runs) appends them to every active record."""
    mesh = _mesh((1, 2))
    xs = [torch.ones(2), torch.ones(2)]
    with pm.record_collectives() as outer:
        with pm.record_apart() as inner:
            pm.all_reduce_sum(xs, mesh, "model")
        assert len(inner.entries) == 1 and outer.entries == []
        with pm.record_collectives() as nested:
            pm.add_to_records(inner.entries)
        pm.add_to_records(inner.entries)
    assert nested.entries == inner.entries
    assert outer.entries == inner.entries * 2
    pm.add_to_records(inner.entries)        # no record active: nothing
    assert len(inner.entries) == 1


def test_elastic_trainer_makes_a_new_step_on_every_build(tmp_path):
    """The trainer's step is ``jit_train_step``'s (eager on CPU
    positions); every build (a kill-free reshard) makes a new step, which
    a graph would bind anew."""
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64)
    dc = tdata.DataConfig(seq_len=16, global_batch=4)
    ocfg = topt.OptimizerConfig()
    shapes = iter([(1, 1), (2, 2)])
    tr = ElasticTrainer(cfg, ocfg, dc, str(tmp_path / "a"),
                        devices=["cpu"] * 4,
                        plan_fn=lambda n: RuntimePlan(n, *next(shapes)))
    tr.build(1)
    first = tr.step_fn
    assert first.graphed is False and tr.captures == []
    tr.on_availability_change(4)
    assert tr.step_fn is not first and tr.step_fn.graphed is False
