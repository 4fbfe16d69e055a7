"""The port's mesh rules (``repro_torch.dist.sharding``, ``dist.mesh``,
``serve_step.cache_specs``, ``launch.mesh``) against the reference's.

The rules read only ``mesh.shape``, so both packages run on the reference
tests' fake meshes (``tests/test_sharding.py``): every config at full
width under every policy on every fake mesh must give specs ``==`` to the
reference's, compared as tuples (the reference's ``PartitionSpec`` is not
a tuple).  The reference's declarations of the families the port has no
model of go through the port's rules as port ``Decl``s.
"""
import itertools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget
from repro.dist import sharding as jshd
from repro.models import model as jm
from repro.serve import serve_step as jserve
from repro_torch.configs import ARCH_IDS, PAPER_IDS
from repro_torch.configs import get_config as tget
from repro_torch.dist import mesh as tmesh
from repro_torch.dist import sharding as tshd
from repro_torch.launch import mesh as tlaunch
from repro_torch.models import model as tm
from repro_torch.serve import serve_step as tserve

MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((1, 5), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = ARCH_IDS + PAPER_IDS
DENSE = [a for a in ARCHS if tget(a).family == "dense"]


def _fake_mesh(shape, axes):
    # AbstractMesh-like: only .shape is used by the rules
    class M:
        pass
    m = M()
    m.shape = dict(zip(axes, shape))
    return m


def _t(spec):
    return tuple(spec)


def _flat_specs(tree):
    """path -> spec tuple of a nested dict of specs (either package's)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            out[path] = _t(t)
    walk(tree, "")
    return out


def _port_decls(tree):
    """The reference's Decl tree as the port's."""
    if isinstance(tree, jshd.Decl):
        return tshd.Decl(tree.shape, tree.axes, tree.init, tree.scale_dim)
    return {k: _port_decls(v) for k, v in tree.items()}


def test_policies_are_the_reference_policies():
    assert tshd.POLICIES == jshd.POLICIES
    assert tshd.DP_AXIS_NAMES == jshd.DP_AXIS_NAMES
    for name in jshd.POLICIES:
        assert tshd.policy_rules(name) == jshd.policy_rules(name)
    with pytest.raises(KeyError, match="unknown sharding policy"):
        tshd.policy_rules("zero3")


def test_partition_spec_is_a_tuple():
    spec = tshd.P("data", None, ("pod", "data"))
    assert spec == ("data", None, ("pod", "data"))
    assert _t(spec) == _t(JP("data", None, ("pod", "data")))
    assert tshd.P() == () and repr(tshd.P(None)) == "P(None,)"


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("policy", sorted(jshd.POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, policy, shape, axes):
    """Every config at full width, every policy, every fake mesh."""
    mesh = _fake_mesh(shape, axes)
    jdecls = jm.decls(jget(arch))
    want = _flat_specs(jshd.param_specs(jdecls, policy, mesh))
    got = _flat_specs(tshd.param_specs(_port_decls(jdecls), policy, mesh))
    assert got == want
    if arch in DENSE:      # the port's own declarations too
        assert _flat_specs(tshd.param_specs(tm.decls(tget(arch)), policy,
                                            mesh)) == want


@pytest.mark.parametrize("shape,axes", MESHES)
def test_logical_to_spec_matches_reference(shape, axes):
    """Every rule's candidates on dims that divide, do not divide, and
    repeat a mesh axis."""
    mesh = _fake_mesh(shape, axes)
    logical = (None, "embed", "vocab", "heads", "kv_heads", "ff", "experts",
               "e_ff", "ssm_inner", "layers", "kv_seq")
    dims = (1, 5, 15, 16, 960, 2560, 49152)
    for policy in jshd.POLICIES:
        rules = jshd.policy_rules(policy)
        for ax in itertools.product(logical, repeat=2):
            for shp in itertools.product(dims, repeat=2):
                assert _t(tshd.logical_to_spec(shp, ax, rules, mesh)) == \
                    _t(jshd.logical_to_spec(shp, ax, rules, mesh)), \
                    (policy, ax, shp)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_dp_axes_batch_spec_and_sanitize_match_reference(shape, axes):
    mesh = _fake_mesh(shape, axes)
    assert tshd.dp_axes(mesh) == jshd.dp_axes(mesh)
    for batch in (1, 2, 3, 4, 5, 6, 8, 16, 32, 256, 512):
        for rest in ((), (None,), (None, "model"), (None, "model", None)):
            assert _t(tshd.batch_spec(mesh, batch, *rest)) == \
                _t(jshd.batch_spec(mesh, batch, *rest))
    sizes = dict(mesh.shape)
    parts = (None, "data", "model", "pod", ("pod", "data"),
             ("data", "model"), "bogus")
    for spec in itertools.product(parts, repeat=3):
        for shp in ((8, 15, 64), (32, 16, 960), (2, 5, 49152), (1, 4, 4)):
            assert _t(tshd.sanitize(shp, spec, sizes)) == \
                _t(jshd._sanitize(shp, JP(*spec), sizes)), (spec, shp)


def test_reference_tests_own_cases():
    """``tests/test_sharding.py`` and ``tests/test_dist_unit.py:61-84``."""
    m = _fake_mesh((16, 16), ("data", "model"))
    fsdp = tshd.policy_rules("fsdp_tp")
    assert tshd.logical_to_spec((1024, 32, 128), ("embed", "heads", None),
                                fsdp, m) == ("data", "model", None)
    assert tshd.logical_to_spec((960, 15, 64), ("embed", "heads", None),
                                fsdp, m) == ("data", None, None)
    assert tshd.logical_to_spec((6144, 1, 128), ("embed", "kv_heads", None),
                                tshd.policy_rules("tp"), m) == \
        (None, None, None)
    assert tshd.logical_to_spec((64, 64), ("heads", "ff"),
                                tshd.policy_rules("tp"),
                                _fake_mesh((4,), ("model",))) == \
        ("model", None)
    assert tshd.logical_to_spec((64, 64), ("embed", "ff"),
                                tshd.policy_rules("replicated"),
                                _fake_mesh((4, 4), ("data", "model"))) == \
        (None, None)
    pod = _fake_mesh((2, 16, 16), ("pod", "data", "model"))
    assert tshd.batch_spec(pod, 256) == (("pod", "data"),)
    assert tshd.batch_spec(pod, 16) == ("data",)
    assert tshd.batch_spec(pod, 1) == (None,)
    assert tshd.dp_axes(_fake_mesh((4, 2), ("data", "model"))) == ("data",)
    assert tshd.dp_axes(pod) == ("pod", "data")
    assert tshd.dp_axes(_fake_mesh((8,), ("model",))) == ()
    dm = _fake_mesh((4, 2), ("data", "model"))
    assert tshd.batch_spec(dm, 8, None, "model", None) == \
        ("data", None, "model", None)
    assert tshd.batch_spec(dm, 3, None) == (None, None)


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_cache_specs_match_reference(arch, shape, axes):
    mesh = _fake_mesh(shape, axes)
    for batch, max_len in ((8, 576), (1, 4096), (3, 100), (32, 2048)):
        want = jserve.cache_specs(jget(arch), batch, max_len, mesh)
        got = tserve.cache_specs(tget(arch), batch, max_len, mesh)
        assert {k: _t(v) for k, v in got.items()} == \
            {k: _t(v) for k, v in want.items()}
    assert tserve.CACHE_RULES == jserve.CACHE_RULES


def test_cache_specs_smollm_on_2x2():
    got = tserve.cache_specs(tget("smollm_360m"), 8, 576,
                             _fake_mesh((2, 2), ("data", "model")))
    assert got["k"] == (None, "data", "model", None, None)
    assert got["v"] == (None, "data", "model", None, None)
    assert got["len"] == ()


def test_named_mesh_on_given_devices():
    cpu = torch.device("cpu")
    m = tmesh.data_model_mesh(2, 2, [cpu] * 4)
    assert dict(m.shape) == {"data": 2, "model": 2}
    assert list(m.shape) == ["data", "model"] and m.size == 4
    assert m.devices.shape == (2, 2) and m.device_list == [cpu] * 4
    assert m.coords(3) == {"data": 1, "model": 1}
    assert m.groups(("model",)) == [[0, 1], [2, 3]]
    assert m.groups(("data",)) == [[0, 2], [1, 3]]
    assert m.groups(("data", "model")) == [[0, 1, 2, 3]]
    assert m.groups(()) == [[0], [1], [2], [3]]
    p = tmesh.pod_data_model_mesh(2, 2, 1, ["cpu"] * 4)
    assert dict(p.shape) == {"pod": 2, "data": 2, "model": 1}
    assert p.groups(("pod", "data")) == [[0, 1, 2, 3]]
    assert p.groups(("data",)) == [[0, 1], [2, 3]]
    # the reference's message
    with pytest.raises(ValueError, match=r"need 4 devices for mesh \(2, 2\), "
                                         r"got 3"):
        tmesh.data_model_mesh(2, 2, [cpu] * 3)
    with pytest.raises(ValueError):
        tmesh.Mesh(np.empty((2, 2), dtype=object), ("data",))


def test_meshes_without_devices_need_the_cards(monkeypatch):
    """devices=None takes CUDA devices: none raises, too few raises with
    the reference's message; a repeating list runs any shape."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.data_model_mesh(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"need 256 devices for mesh "
                                         r"\(16, 16\), got 1"):
        tlaunch.make_production_mesh()
    with pytest.raises(ValueError, match=r"need 512 devices"):
        tlaunch.make_production_mesh(multi_pod=True)
    single = tlaunch.make_production_mesh(devices=["cpu"] * 256)
    assert dict(single.shape) == {"data": 16, "model": 16}
    multi = tlaunch.make_production_mesh(multi_pod=True,
                                         devices=["cpu"] * 512)
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
