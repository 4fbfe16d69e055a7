"""The sharded train step of smollm_360m against the single-device step,
on the meshes ``test_torch_mesh.py`` holds qwen1_5_0_5b on (its cases
live in a file of their own, so that a test worker takes each half), at
that file's tolerances."""
import pytest
import torch

from test_torch_mesh import MESHES, _cfg, step_matches_single_device

CASES = [("smollm_360m", shape, policy) for shape, policy in MESHES]


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("micro_batch", [4, 3])
@pytest.mark.parametrize("weights", [None, (2 / 3, 1 / 3)])
@pytest.mark.parametrize("arch,shape,policy", CASES)
def test_sharded_step_matches_single_device(arch, shape, policy, weights,
                                            micro_batch):
    step_matches_single_device(_cfg(arch, policy), shape, weights,
                               micro_batch)
