"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks for a CUDA device through the ``cuda``
fixture and skips without one.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2, fp32 2e-5 (the reference's kernel tolerances).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops
from repro_torch.models import model as tm

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (2, 128, 128, 15, 5, 64, True),     # smollm heads, GQA group 3
    (2, 509, 509, 15, 5, 64, True),     # ragged vs both tiles
    (2, 130, 70, 4, 2, 64, False),      # unequal lengths
    (1, 70, 130, 4, 4, 64, True),       # causal, sk > sq
    (1, 200, 200, 6, 2, 80, True),
    (2, 256, 256, 4, 2, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_q", [16, 32])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, sk, h, kh, d,
                                              causal, dtype, block_q):
    q = _rand(cuda, b, sq, h, d, dtype=dtype)
    k = _rand(cuda, b, sk, kh, d, dtype=dtype)
    v = _rand(cuda, b, sk, kh, d, dtype=dtype)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, block_q=block_q)
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=block_q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_attention_kernel_reads_strided_views(cuda):
    """(B, S, H, D) views with non-packed strides (a slice of a wider
    projection) are read in place."""
    qkv = _rand(cuda, 2, 100, 3 * 4, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("rows,d", [(4096, 960), (4071, 960), (7, 64),
                                    (33, 8192), (1, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_add_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    x = _rand(cuda, rows, d, dtype=dtype)
    r = _rand(cuda, rows, d, dtype=dtype)
    sc = _rand(cuda, d, dtype=dtype)
    ops.reset_launches()
    h, y = ops.fused_add_rmsnorm(x, r, sc, block_rows=3)
    wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_add_rmsnorm"] == 1
    torch.testing.assert_close(h.float(), wh.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(y.float(), wy.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_model_kernel_path_matches_plain_path(cuda):
    """fp32, 2 layers: the kernel path against the plain path on the card,
    with one launch of each kernel per layer."""
    cfg = dataclasses.replace(get_config("qwen1_5_0_5b").reduced(),
                              head_dim=64)
    params = tm.init(cfg, 0)
    toks = torch.randint(0, cfg.vocab_size, (3, 45), device="cuda",
                         generator=cuda)
    ops.reset_launches()
    got = tm.forward(cfg, params, {"tokens": toks})
    assert ops.LAUNCHES == {"flash_attention": cfg.n_layers,
                            "fused_add_rmsnorm": cfg.n_layers}
    want = tm.forward(cfg, params, {"tokens": toks}, attn_impl="naive")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
