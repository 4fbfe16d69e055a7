"""Port kernels (plain versions on the CPU) vs the reference's Pallas kernels.

The reference's ``repro.kernels.ops`` wrappers run the Pallas kernels in
interpret mode on the CPU; the port's ``repro_torch.kernels.ops`` wrappers
route CPU tensors to each kernel's plain PyTorch version.  Both get the
same numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2 (one bf16 ulp at |x|~4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops

RNG = np.random.default_rng(11)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(arr, name):
    """The same numpy values as a JAX array and a CPU tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _attn_inputs(b, sq, sk, h, kh, d, name):
    q = _pair(RNG.standard_normal((b, sq, h, d)), name)
    k = _pair(RNG.standard_normal((b, sk, kh, d)), name)
    v = _pair(RNG.standard_normal((b, sk, kh, d)), name)
    return q, k, v


@pytest.mark.parametrize("b,s,h,kh,d", [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),
    (1, 256, 3, 1, 80),        # MQA, odd head count, zamba head_dim
    (2, 128, 8, 8, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(b, s, h, kh, d, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(b, s, s, h, kh, d, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("sq,sk,causal", [
    (100, 100, True),          # ragged vs any block size
    (192, 192, False),         # divisible by 64, ragged vs default 128
    (130, 70, False),          # unequal lengths (cross-attention shaped)
    (257, 300, False),         # both ragged vs default blocks
    (70, 130, True),           # causal, sk > sq: top-left aligned mask
])
def test_flash_attention_plain_non_divisible(sq, sk, causal):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(2, sq, sk, 2, 2, 64,
                                                "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_q", [16, 32])
def test_flash_attention_plain_block_q_invariant(block_q):
    """The q tile the kernel is launched with does not change the result."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(2, 77, 77, 6, 2, 64,
                                                "float32")
    want = jops.flash_attention(jq, jk, jv, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=block_q,
                              block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(4, 100, 512), (3, 87, 128), (16, 2048),
                                   (8, 61, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_rmsnorm_plain_matches_pallas(shape, dtype):
    jx, tx = _pair(RNG.standard_normal(shape), dtype)
    jr, tr = _pair(RNG.standard_normal(shape), dtype)
    js, ts = _pair(RNG.standard_normal(shape[-1:]), dtype)
    want_h, want_y = jops.fused_add_rmsnorm(jx, jr, js)
    got_h, got_y = ops.fused_add_rmsnorm(tx, tr, ts)
    assert got_h.dtype == tx.dtype and got_y.shape == tx.shape
    np.testing.assert_allclose(_np(got_h), _np(want_h), **_tol(dtype))
    np.testing.assert_allclose(_np(got_y), _np(want_y), **_tol(dtype))


def test_fused_add_rmsnorm_keeps_the_kernel_rounding_order():
    """bf16: the norm is taken from the fp32 sum, not from the rounded y,
    and the scale multiplies before the single cast (fused.py:36-40)."""
    x = torch.tensor([[1.0, 2.0 ** -9, 3.0, -1.5]], dtype=torch.bfloat16)
    r = torch.tensor([[2.0 ** -9, 1.0, 0.5, 0.25]], dtype=torch.bfloat16)
    sc = torch.tensor([1.5, 0.75, 1.25, 2.0], dtype=torch.bfloat16)
    h, y = ops.fused_add_rmsnorm(x, r, sc, eps=1e-5)
    y32 = x.float() + r.float()
    want = (y32 * torch.rsqrt(y32.square().mean(-1, keepdim=True) + 1e-5)
            * sc.float()).to(torch.bfloat16)
    assert torch.equal(h, want)
    assert torch.equal(y, y32.to(torch.bfloat16))


# --- wrapper contract ----------------------------------------------------------

def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(*shape, dtype=dtype, device=device)


def test_block_args():
    q = _t(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="autotuner"):
        ops.flash_attention(q, q, q, block_q="auto")
    with pytest.raises(NotImplementedError, match="autotuner"):
        ops.fused_add_rmsnorm(_t(2, 64), _t(2, 64), _t(64), block_rows="auto")
    with pytest.raises(ValueError, match="block_q"):
        ops.flash_attention(q, q, q, block_q=48)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q, block_k=64.0)
    assert ops.flash_attention(q, q, q, block_q=16, block_k=64).shape \
        == q.shape


@pytest.mark.parametrize("bad", [
    dict(d=16),                           # head dim the kernel is not built for
    dict(dtype=torch.float16),
    dict(kh=3),                           # 4 query heads over 3 KV heads
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    d, kh = bad.get("d", 64), bad.get("kh", 2)
    dt = bad.get("dtype", torch.float32)
    with pytest.raises(ValueError):
        ops.flash_attention(_t(1, 8, 4, d, dtype=dt), _t(1, 8, kh, d, dtype=dt),
                            _t(1, 8, kh, d, dtype=dt))


def test_fused_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ops.fused_add_rmsnorm(_t(2, 9000), _t(2, 9000), _t(9000))
    with pytest.raises(ValueError):
        ops.fused_add_rmsnorm(_t(2, 64), _t(2, 64),
                              _t(64, dtype=torch.bfloat16))


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the CUDA launch or raises."""
    ops.reset_launches()
    q = _t(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    x = _t(2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_add_rmsnorm(x, x, _t(64, device="meta"))
    assert ops.LAUNCHES == {"flash_attention": 0, "fused_add_rmsnorm": 0}


def test_cuda_launchers_raise_without_a_card(monkeypatch):
    """The CUDA launch path refuses CPU tensors, and never returns the plain
    version's result."""
    q = _t(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q)
    x = _t(2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mod.fused_add_rmsnorm_cuda(x, x, _t(64))


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q = _t(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    ops.fused_add_rmsnorm(_t(2, 64), _t(2, 64), _t(64))
    assert ops.LAUNCHES == {"flash_attention": 0, "fused_add_rmsnorm": 0}


def test_fused_block_threads():
    assert fused_mod.block_threads(960) == 128
    assert fused_mod.block_threads(64) == 32
    assert fused_mod.block_threads(8192) == 1024
    for d in (1, 100, 960, 4097, 8192):
        assert fused_mod.block_threads(d) * 8 >= d
