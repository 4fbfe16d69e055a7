"""The sharded train step of smollm_360m against the single-device step,
on the meshes ``test_torch_mesh.py`` holds qwen1_5_0_5b on (its cases
live in a file of their own, so that a test worker takes each half), at
that file's tolerances."""
import pytest

from test_torch_mesh import MESHES, _cfg, step_matches_single_device

CASES = [("smollm_360m", shape, policy) for shape, policy in MESHES]


@pytest.mark.parametrize("micro_batch", [4, 3])
@pytest.mark.parametrize("weights", [None, (2 / 3, 1 / 3)])
@pytest.mark.parametrize("arch,shape,policy", CASES)
def test_sharded_step_matches_single_device(arch, shape, policy, weights,
                                            micro_batch):
    step_matches_single_device(_cfg(arch, policy), shape, weights,
                               micro_batch)
