"""Port kernels (plain versions on the CPU) vs the reference's Pallas kernels.

The reference's ``repro.kernels.ops`` wrappers run the Pallas kernels in
interpret mode on the CPU; the port's ``repro_torch.kernels.ops`` wrappers
route CPU tensors to each kernel's plain PyTorch version.  Both get the
same numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2 (one bf16 ulp at |x|~4);
SSD y 1e-4 / 4e-2 and state 1e-4 / 1e-2 (fp32 / bf16).
"""
import os
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import add as add_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models import layers as tlayers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_small_head_dims(d, causal):
    """Head dims 16 and 32 (the reduced configs and the calibration test's
    grid) are kernel shapes too."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(2, 70, 70, 4, 2, d,
                                                "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_attention_plain_block_q_invariant(block_q):
    """The q tile the kernel is launched with does not change the result."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(2, 77, 77, 6, 2, 64,
                                                "float32")
    want = jops.flash_attention(jq, jk, jv, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=block_q,
                              block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (1, 128, 128, 15, 5, 64, True),     # smollm-360M's heads
    (2, 77, 77, 15, 5, 64, True),       # ragged vs both bf16 tiles
    (1, 509, 509, 15, 5, 64, True),
    (2, 130, 70, 15, 5, 64, False),     # non-causal, unequal lengths
    (2, 77, 77, 4, 2, 16, True),        # the reduced configs' head dim
    (1, 130, 130, 6, 2, 80, True),
    (1, 128, 128, 4, 2, 128, False),
])
def test_flash_attention_bf16_plain_matches_pallas(b, sq, sk, h, kh, d,
                                                   causal):
    """bf16 takes the tensor-core kernel's arithmetic (P split into two
    bf16 parts for P V, 128-row q tiles); it stays within the bf16
    tolerance of the Pallas kernel, which keeps P in fp32."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(b, sq, sk, h, kh, d,
                                                "bfloat16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert fa.kernel_for(tq.dtype) == "wgmma" and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))


@pytest.mark.parametrize("dtype,ok,refused", [
    (torch.bfloat16, (64, 128), (16, 32, 48)),
    (torch.float32, (128, 64), (16, 32, 48)),
])
def test_flash_attention_block_q_by_dtype(dtype, ok, refused):
    """bf16 runs the wgmma kernel (one or two 64-row warpgroups), fp32 the
    CUDA-core one (4 or 8 warps of 16 rows); the plain version is held to
    the same tiles, and None takes each kernel's default."""
    q = _t(1, 40, 2, 64, dtype=dtype)
    for bq in ok:
        assert ops.flash_attention(q, q, q, block_q=bq).shape == q.shape
    for bq in refused:
        with pytest.raises(ValueError, match="block_q"):
            ops.flash_attention(q, q, q, block_q=bq)
    assert fa.default_block_q(dtype) == ok[-1]
    assert fa.default_block_q(dtype, "cuda_core") == 64
    with pytest.raises(ValueError, match="impl"):
        fa.kernel_for(dtype, "tf32")


def _lse_f64(q, k, v, causal):
    """Each row's log-sum-exp of its scaled, masked scores in float64,
    (B, H, Sq), from the same values the kernels read."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    idx = torch.arange(h) // (h // kh)
    qd, kd = q.double().transpose(1, 2), k.double()[:, :, idx].transpose(1, 2)
    sc = qd @ kd.transpose(-1, -2) / d ** 0.5
    if causal:
        sc = sc.masked_fill(torch.ones(sq, sk, dtype=torch.bool).triu(1),
                            float("-inf"))
    return torch.logsumexp(sc, dim=-1)


@pytest.mark.parametrize("block_q", fa.BLOCK_Q_CHOICES["cuda_core"])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (1, 300, 300, 6, 2, 64, True),      # GQA 3, sk not a multiple of 64
    (2, 130, 200, 4, 4, 32, False),     # non-causal, sk > sq, ragged tail
    (1, 200, 77, 4, 1, 16, False),      # MQA, sq > sk
    (1, 150, 150, 4, 2, 128, True),     # causal, a q tile past sq
])
def test_flash_attention_cuda_core_tiles_match_pallas(block_q, b, sq, sk, h,
                                                      kh, d, causal):
    """The CUDA-core kernel's plain version at each of its q tiles against
    the Pallas kernel (interpret mode) at fp32's 2e-5, and its row LSE
    against a float64 log-sum-exp of the same scores."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(b, sq, sk, h, kh, d,
                                                "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        block_q=block_q, return_lse=True)
    assert fa.kernel_for(tq.dtype) == "cuda_core"
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse.double(), _lse_f64(tq, tk, tv, causal),
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("bad", ["base", "head_stride", "seq_stride"])
def test_flash_attention_cuda_refuses_unaligned_fp32(bad):
    """Both forward kernels copy 16 bytes at a time: an fp32 q, k or v
    whose base or batch/seq/head strides are not 16-byte multiples is
    refused by the wrapper before anything else (here on CPU tensors,
    which it then refuses for not lying on the card)."""
    ok = _t(1, 8, 2, 64)
    if bad == "base":
        t = torch.zeros(1 * 8 * 2 * 64 + 1)[1:].view(1, 8, 2, 64)
    elif bad == "head_stride":
        t = torch.zeros(1, 8, 2, 66)[..., :64]       # head stride 264 bytes
    else:
        t = torch.zeros(8 * 129).as_strided((1, 8, 2, 64),
                                            (8 * 129, 129, 64, 1))
    for args in ((t, ok, ok), (ok, t, ok), (ok, ok, t)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(ok, ok, ok)


def test_flash_attention_split_p_adds_little_error():
    """The wgmma kernel feeds P to P V as two bf16 parts (hi, the rounding
    of p - hi) instead of fp32 P (the Pallas kernel, and the plain version
    under ``impl="cuda_core"``); both are held against float64 attention on
    the same bf16 inputs at smollm's heads.  hi + lo is within 2^-17 p of
    p, so before the output cast the two differ by at most 2^-17 max|v|.
    Found: the max error is 7.7e-3 either way (one bf16 ulp of the output),
    the mean errors agree to 1e-9 (1.45e-4), and 0.2% of the outputs round
    to a neighbouring bf16 value; the bounds below are 1e-6 on the mean and
    1% of the outputs."""
    rng = np.random.default_rng(0)
    b, s, h, kh, d = 2, 509, 15, 5, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).bfloat16()
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    idx = torch.arange(h) // (h // kh)
    qd, kd, vd = (t.double().transpose(1, 2)
                  for t in (q, k[:, :, idx], v[:, :, idx]))
    sc = (qd @ kd.transpose(-1, -2) / d ** 0.5).masked_fill(
        torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    want = (torch.softmax(sc, -1) @ vd).transpose(1, 2)
    split = fa.flash_attention_plain(q, k, v).double()
    fp32_p = fa.flash_attention_plain(q, k, v, impl="cuda_core").double()
    ulp = 2.0 ** -7 * want.abs().max().item()      # a bf16 ulp at the top
    assert (split - want).abs().max() <= (fp32_p - want).abs().max() + ulp
    assert abs((split - want).abs().mean() - (fp32_p - want).abs().mean()) \
        <= 1e-6
    assert (split != fp32_p).double().mean() <= 0.01
    assert (split - want).abs().max() <= 2e-2


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


# --- decode attention ------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [0, 1, 137, 300])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(cache_len, d, dtype):
    """GQA 4/2 against the Pallas decode kernel in interpret mode;
    ``cache_len=0`` gives zeros there (every tile skipped), and here."""
    jq, tq = _pair(RNG.standard_normal((2, 1, 4, d)), dtype)
    jk, tk = _pair(RNG.standard_normal((2, 300, 2, d)), dtype)
    jv, tv = _pair(RNG.standard_normal((2, 300, 2, d)), dtype)
    want = jops.flash_attention_decode(
        jq, jk, jv, cache_len=jnp.asarray(cache_len, jnp.int32))
    got = ops.flash_attention_decode(tq, tk, tv, cache_len=cache_len)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if cache_len == 0:
        assert not got.float().abs().any()


@pytest.mark.parametrize("n_splits", [1, 2, 3, None])
@pytest.mark.parametrize("cache_len", [0, 1, 63, 64, 65, 200])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (12, 1)])
@pytest.mark.parametrize("d,dtype", [(16, "float32"), (16, "bfloat16"),
                                     (128, "float32"), (128, "bfloat16")])
def test_flash_decode_split_plain_matches_pallas(n_splits, cache_len, h, kh,
                                                 d, dtype):
    """The split plain version (per-split partials, then the merge) against
    the Pallas decode kernel in interpret mode.  S = 200 is 4 tiles: 2
    splits of 128 keys leave the second empty below 129 keys, 3 splits of
    128 leave the third empty at every length, and the helper's choice is
    one tile a split; MHA, GQA and MQA with a group over 8 (two head groups
    on the card)."""
    jq, tq = _pair(RNG.standard_normal((2, 1, h, d)), dtype)
    jk, tk = _pair(RNG.standard_normal((2, 200, kh, d)), dtype)
    jv, tv = _pair(RNG.standard_normal((2, 200, kh, d)), dtype)
    want = jops.flash_attention_decode(
        jq, jk, jv, cache_len=jnp.asarray(cache_len, jnp.int32))
    got = ops.flash_attention_decode(tq, tk, tv, cache_len=cache_len,
                                     n_splits=n_splits)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if cache_len == 0:
        assert not got.float().abs().any()


@pytest.mark.parametrize("b,kh,g,s", [
    (1, 120, 1, 4096),      # calibrate's longest cache: 120 (row, head) pairs
    (1, 120, 1, 549),       # calibrate's held-out length
    (1, 120, 1, 256),
    (8, 5, 3, 549),         # the serve phase's decode: smollm 15/5, batch 8
    (8, 1, 48, 549),        # MQA, granite-20b's 48 heads: 6 head groups
    (2, 1, 12, 200),        # MQA with a group over 8, tiny
    (1, 1, 1, 64),          # one tile
    (1, 1, 1, 1),
])
def test_decode_splits_cover_the_cache_in_whole_tiles(b, kh, g, s):
    nh = fa.decode_heads(g)
    groups = -(-g // nh)
    assert nh in fa.DECODE_HEADS and nh >= min(g, 8) and groups * nh >= g
    n = fa.decode_splits(b, kh, groups, s)
    per = fa.split_keys(s, n)
    tiles = -(-s // 64)
    assert per % 64 == 0 and per >= 64
    bounds = [(i * per, min((i + 1) * per, s)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(a == c for (_, a), (c, _) in zip(bounds, bounds[1:]))
    assert all(hi > lo for lo, hi in bounds)    # none empty at cache_len S
    # stated limits: at most one tile a split; at least half the least count
    # that gives BLOCKS_PER_SM blocks an SM, unless the tiles run out first
    base = b * kh * groups
    want = -(-fa.BLOCKS_PER_SM * fa.H100_SMS // base)
    assert 1 <= n <= min(tiles, max(want, 1))
    assert 2 * n >= min(want, tiles)
    assert fa.decode_plan(b, s, kh * g, kh) == (n, per, nh)


def test_decode_splits_at_the_main_shapes():
    """The counts the kernel line and the tables are measured at."""
    assert fa.decode_plan(1, 4096, 120, 120) == (5, 832, 1)     # 600 blocks
    assert fa.decode_plan(8, 549, 15, 5) == (9, 64, 4)          # 360 blocks
    assert fa.decode_plan(8, 549, 48, 1) == (9, 64, 8)
    assert fa.decode_plan(1, 549, 120, 120, n_splits=9) == (9, 64, 1)
    assert fa.decode_plan(1, 200, 4, 4, n_splits=3) == (3, 128, 1)


def test_flash_decode_plain_takes_a_tensor_length_and_clamps():
    (_, tq), (_, tk), (_, tv) = _attn_inputs(2, 1, 50, 4, 2, 64, "float32")
    want = ops.flash_attention_decode(tq, tk, tv, cache_len=37)
    got = ops.flash_attention_decode(tq, tk, tv,
                                     cache_len=torch.tensor(37))
    assert torch.equal(got, want)
    assert torch.equal(ops.flash_attention_decode(tq, tk, tv, cache_len=99),
                       ops.flash_attention_decode(tq, tk, tv, cache_len=50))


# --- RMSNorm, SSD, add ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 100, 512), (1, 7, 64), (16, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    jx, tx = _pair(RNG.standard_normal(shape), dtype)
    js, ts = _pair(RNG.standard_normal(shape[-1:]), dtype)
    want = jops.rmsnorm(jx, js)
    got = ops.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm_ref(jx, js)),
                               **_tol(dtype))


def test_rmsnorm_keeps_the_kernel_rounding_order():
    """The scale multiplies in fp32 before the single cast
    (``rmsnorm.py:39-42``), unlike ``layers.rms_norm`` (cast, then scale)."""
    x = torch.tensor([[1.0, 2.0 ** -9, 3.0, -1.5]], dtype=torch.bfloat16)
    sc = torch.tensor([1.5, 0.75, 1.25, 2.0], dtype=torch.bfloat16)
    x32 = x.float()
    want = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-5)
            * sc.float()).to(torch.bfloat16)
    assert torch.equal(ops.rmsnorm(x, sc), want)


def _ssd_inputs(b, s, h, p, n, dtype):
    """The reference sweep's draws: B and C scaled by 0.5."""
    jx, tx = _pair(RNG.standard_normal((b, s, h, p)), dtype)
    dt = RNG.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -RNG.uniform(0.5, 2.0, (h,)).astype(np.float32)
    jb, tb = _pair(RNG.standard_normal((b, s, n)) * 0.5, dtype)
    jc, tc = _pair(RNG.standard_normal((b, s, n)) * 0.5, dtype)
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 16, 32),
    (2, 256, 3, 64, 64, 64),
    (1, 256, 4, 64, 128, 128),   # mamba2-130m geometry
    (1, 200, 2, 32, 16, 64),     # S not a multiple of the chunk
    (1, 200, 2, 32, 16, 77),     # a chunk not a multiple of 16, ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_ref(b, s, h, p, n, chunk, dtype):
    jargs, targs = _ssd_inputs(b, s, h, p, n, dtype)
    y, st = ops.ssd_scan(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n)
    bf16 = dtype == "bfloat16"
    ytol = dict(rtol=4e-2, atol=4e-2) if bf16 else dict(rtol=1e-4, atol=1e-4)
    stol = dict(rtol=1e-2, atol=1e-2) if bf16 else dict(rtol=1e-4, atol=1e-4)
    for wy, wst in (jops.ssd_scan(*jargs, chunk=chunk),
                    jref.ssd_ref(*jargs)):
        np.testing.assert_allclose(_np(y), _np(wy), **ytol)
        np.testing.assert_allclose(_np(st), _np(wst), **stol)


@pytest.mark.parametrize("chunk", [32, 77, 128])
def test_ssd_passes_entering_states_match_sequential(chunk):
    """Pass 3's state entering chunk c equals the sequential scan's final
    state over the first c chunks, state by state; and the passes' y and
    final state equal the sequential scan's."""
    _, (x, dt, a, b, c) = _ssd_inputs(2, 200, 3, 32, 16, "float32")
    cum, local = ssd_mod.ssd_chunk_state_plain(x, dt, a, b, chunk=chunk)
    entering, final = ssd_mod.ssd_state_pass_plain(local, cum)
    q = min(chunk, 200)
    assert entering.shape[2] == -(-200 // q)
    assert not entering[:, :, 0].any()
    for ci in range(1, entering.shape[2]):
        s0 = ci * q
        _, want = ssd_mod.ssd_scan_plain(x[:, :s0], dt[:, :s0], a, b[:, :s0],
                                         c[:, :s0], chunk=chunk)
        torch.testing.assert_close(entering[:, :, ci], want, rtol=1e-5,
                                   atol=1e-6)
    wy, wst = ssd_mod.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    y, st = ssd_mod.ssd_scan_passes_plain(x, dt, a, b, c, chunk=chunk)
    torch.testing.assert_close(st, final)
    torch.testing.assert_close(st, wst, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_passes_stay_finite_past_exp_overflow(dtype):
    """|sum dt a| over 88 in a chunk (fault R5: exp of the upper triangle
    would overflow): every pass's output is finite and the composition
    agrees with the sequential scan."""
    _, (x, _, _, b, c) = _ssd_inputs(1, 256, 2, 32, 16, dtype)
    dt = torch.full((1, 256, 2), 0.5)
    a = torch.tensor([-2.0, -16.0])
    cb = ssd_mod.ssd_cb_plain(b, c)
    cum, local = ssd_mod.ssd_chunk_state_plain(x, dt, a, b)
    assert cum[..., -1].abs().min() > 88
    entering, final = ssd_mod.ssd_state_pass_plain(local, cum)
    y = ssd_mod.ssd_chunk_scan_plain(x, dt, c, cb, cum, entering)
    for t in (cb, cum, local, entering, final, y):
        assert torch.isfinite(t.float()).all()
    wy, wst = ssd_mod.ssd_scan_plain(x, dt, a, b, c)
    torch.testing.assert_close(y.float(), wy.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(final, wst, rtol=1e-4, atol=1e-4)


def test_ssd_buffers_have_the_plain_passes_shapes():
    """The kernel's intermediates are laid out as the plain passes return
    them: chunk 77 is zero-filled to 80 rows, S = 200 makes 3 chunks."""
    _, (x, dt, a, b, c) = _ssd_inputs(2, 200, 3, 40, 16, "bfloat16")
    bufs = ssd_mod.ssd_buffers(x, b, chunk=77)
    cum, local = ssd_mod.ssd_chunk_state_plain(x, dt, a, b, chunk=77)
    assert bufs["cb"].shape == ssd_mod.ssd_cb_plain(b, c, chunk=77).shape \
        == (2, 3, 80, 80)
    assert bufs["cum"].shape == cum.shape == (2, 3, 3, 80)
    assert bufs["states"].shape == local.shape == (2, 3, 3, 40, 16)
    assert bufs["y"].dtype == torch.bfloat16 and bufs["y"].shape == x.shape
    assert bufs["state"].shape == (2, 3, 40, 16)


@pytest.mark.parametrize("d,dtype,offset,want", [
    (960, torch.bfloat16, 0, (True, 4, 1)),     # 120 vectors: 4 a lane
    (960, torch.float32, 0, (True, 4, 2)),      # 240: two warps a row
    (1024, torch.bfloat16, 0, (True, 4, 1)),    # the widest row of one warp
    (2048, torch.bfloat16, 0, (True, 4, 2)),
    (8192, torch.bfloat16, 0, (True, 4, 8)),
    (8192, torch.float32, 0, (True, 8, 8)),     # 2048 vectors: 8 a lane
    (1000, torch.bfloat16, 0, (True, 4, 1)),    # 125 vectors, masked tail
    (1001, torch.bfloat16, 0, (False, 4, 1)),   # not a multiple of 8
    (100, torch.bfloat16, 0, (False, 1, 1)),
    (100, torch.float32, 0, (True, 1, 1)),
    (960, torch.bfloat16, 1, (False, 4, 1)),    # 2 bytes off a boundary
    (960, torch.float32, 4, (True, 4, 2)),      # 16 bytes off: aligned
])
def test_rmsnorm_plan_from_width_dtype_and_offset(d, dtype, offset, want):
    """The wrapper's choice between the 16-byte and the scalar
    instantiation, and of values a lane and warps a row."""
    x = torch.zeros(3 * d + offset, dtype=dtype)[offset:].view(3, d)
    sc = torch.zeros(d, dtype=dtype)
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    got = rn.plan(x, sc)
    assert tuple(got) == want
    per = 16 // x.element_size()
    assert 32 * got.vals * got.warps_per_row * per >= d
    assert rn.WARPS % got.warps_per_row == 0


@pytest.mark.parametrize("rows,d,br", [(64, 512, 16), (256, 960, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_plain_matches_pallas_add(rows, d, br, dtype):
    """Against the benchmark's own Pallas add (``kernels_bench.py:116``)."""
    sys.path.insert(0, ROOT)
    try:
        from benchmarks.kernels_bench import _pallas_add
    finally:
        sys.path.remove(ROOT)
    jx, tx = _pair(RNG.standard_normal((rows, d)), dtype)
    jr, tr = _pair(RNG.standard_normal((rows, d)), dtype)
    want = jax.jit(_pallas_add, static_argnames=("br",))(jx, jr, br=br)
    got = ops.add(tx, tr)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# --- wrapper contract ----------------------------------------------------------

def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(*shape, dtype=dtype, device=device)


def test_block_args(tmp_path, monkeypatch):
    """Ints pin the tile, None and "auto" resolve (the autotuner's tests
    are ``test_torch_autotune.py``), anything else raises."""
    monkeypatch.setenv("REPRO_KERNEL_CACHE_DIR", str(tmp_path))
    q = _t(1, 8, 2, 64)
    assert ops.flash_attention(q, q, q, block_q="auto").shape == q.shape
    assert ops.fused_add_rmsnorm(_t(2, 64), _t(2, 64), _t(64),
                                 block_rows="auto")[0].shape == (2, 64)
    with pytest.raises(TypeError):
        ops.rmsnorm(_t(2, 64), _t(64), block_rows="fast")
    with pytest.raises(ValueError, match="block_q"):
        ops.flash_attention(q, q, q, block_q=48)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q, q, block_k=64.0)
    assert ops.flash_attention(q, q, q, block_q=64, block_k=64).shape \
        == q.shape


@pytest.mark.parametrize("bad", [
    dict(d=24),                           # head dim the kernel is not built for
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


@pytest.mark.parametrize("call", [
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 24), _t(1, 8, 2, 24),
                                       _t(1, 8, 2, 24), cache_len=3),
    lambda: ops.flash_attention_decode(_t(1, 2, 4, 64), _t(1, 8, 2, 64),
                                       _t(1, 8, 2, 64), cache_len=3),
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 64), _t(1, 8, 3, 64),
                                       _t(1, 8, 3, 64), cache_len=3),
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 64), _t(1, 8, 2, 64),
                                       _t(1, 8, 2, 64),
                                       cache_len=torch.tensor(3.0)),
    lambda: ops.rmsnorm(_t(2, 9000), _t(9000)),
    lambda: ops.rmsnorm(_t(2, 64), _t(64, dtype=torch.bfloat16)),
    lambda: ops.ssd_scan(_t(1, 8, 2, 16), _t(1, 8, 2), _t(2),
                         _t(1, 8, 256), _t(1, 8, 256)),
    lambda: ops.ssd_scan(_t(1, 8, 2, 16), _t(1, 8, 2, dtype=torch.bfloat16),
                         _t(2), _t(1, 8, 16), _t(1, 8, 16)),
    lambda: ops.ssd_scan(_t(1, 8, 2, 16), _t(1, 8, 2), _t(2),
                         _t(1, 8, 16), _t(1, 8, 16), chunk=256),
    lambda: ops.add(_t(2, 64), _t(2, 65)),
    lambda: ops.add(_t(2, 64, dtype=torch.float16),
                    _t(2, 64, dtype=torch.float16)),
    # n_splits outside [1, ceil(S / 64)], or not an int
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 64), _t(1, 130, 2, 64),
                                       _t(1, 130, 2, 64), cache_len=3,
                                       n_splits=4),
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 64), _t(1, 130, 2, 64),
                                       _t(1, 130, 2, 64), cache_len=3,
                                       n_splits=0),
    lambda: ops.flash_attention_decode(_t(1, 1, 4, 64), _t(1, 130, 2, 64),
                                       _t(1, 130, 2, 64), cache_len=3,
                                       n_splits=True),
])
def test_new_wrappers_reject_what_their_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the CUDA launch or raises."""
    ops.reset_launches()
    q = _t(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    x = _t(2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_add_rmsnorm(x, x, _t(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_decode(_t(1, 1, 2, 64, device="meta"), q, q,
                                   cache_len=3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, _t(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.add(x, x)
    x4, bc = _t(1, 8, 2, 16, device="meta"), _t(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(x4, _t(1, 8, 2, device="meta"), _t(2, device="meta"),
                     bc, bc)
    assert not any(ops.LAUNCHES.values())


def test_cuda_launchers_raise_without_a_card(monkeypatch):
    """The CUDA launch path refuses CPU tensors, and never returns the plain
    version's result."""
    q = _t(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q)
    x = _t(2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mod.fused_add_rmsnorm_cuda(x, x, _t(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_decode_cuda(_t(1, 1, 2, 64), q, q, cache_len=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rn.rmsnorm_cuda(x, _t(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        add_mod.add_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_mod.ssd_scan_cuda(_t(1, 8, 2, 16), _t(1, 8, 2), _t(2),
                              _t(1, 8, 16), _t(1, 8, 16))


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q = _t(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    ops.fused_add_rmsnorm(_t(2, 64), _t(2, 64), _t(64))
    ops.flash_attention_decode(q[:, :1], q, q, cache_len=4)
    ops.rmsnorm(_t(2, 64), _t(64))
    ops.add(_t(2, 64), _t(2, 64))
    ops.ssd_scan(_t(1, 8, 2, 16), _t(1, 8, 2), _t(2), _t(1, 8, 16),
                 _t(1, 8, 16))
    q.requires_grad_()
    ops.flash_attention(q, q, q).sum().backward()
    x = _t(2, 64).requires_grad_()
    sum(ops.fused_add_rmsnorm(x, x, _t(64))).sum().backward()
    assert ops.LAUNCHES == dict.fromkeys(
        ["flash_attention", "fused_add_rmsnorm", "flash_attention_decode",
         "rmsnorm", "ssd_scan", "add", "flash_attention_bwd",
         "fused_add_rmsnorm_bwd"], 0)


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dtype,which,offset,want", [
    (960, _BF16, None, 0, (True, 2, 2)),      # 120 vectors: two warps of 2
    (960, _F32, None, 0, (True, 2, 4)),       # 240: four warps a row
    (512, _BF16, None, 0, (True, 2, 1)),      # the widest row of one warp
    (1024, _BF16, None, 0, (True, 2, 2)),
    (2048, _BF16, None, 0, (True, 2, 4)),
    (8192, _BF16, None, 0, (True, 4, 8)),     # 1024 vectors: 8 warps of 4
    (8192, _F32, None, 0, (True, 8, 8)),      # 2048 vectors: 8 warps of 8
    (1001, _BF16, None, 0, (False, 2, 2)),    # not a multiple of 8
    (1001, _F32, None, 0, (False, 2, 4)),     # not a multiple of 4
    (100, _BF16, None, 0, (False, 1, 1)),
    (100, _F32, None, 0, (True, 1, 1)),
    (960, _BF16, "x", 2, (False, 2, 2)),      # 2 bytes off a boundary
    (960, _BF16, "res", 2, (False, 2, 2)),
    (960, _BF16, "scale", 2, (False, 2, 2)),
    (960, _F32, "res", 4, (False, 2, 4)),
    (960, _BF16, "x", 16, (True, 2, 2)),      # 16 bytes off: aligned
    (960, _F32, "res", 16, (True, 2, 4)),
    (960, _BF16, "scale", 16, (True, 2, 2)),
])
def test_fused_plan_from_width_dtype_and_offset(d, dtype, which, offset,
                                                want):
    """The fused kernel's choice between the 16-byte and the scalar
    instantiation, and of values a lane and warps a row: RMSNorm's planner
    over x, res and scale at ``fused.WARP_VALS`` values a lane."""
    es = torch.tensor([], dtype=dtype).element_size()

    def make(name, *shape):
        n, k = int(np.prod(shape)), offset // es if name == which else 0
        return torch.zeros(n + k, dtype=dtype)[k:].view(*shape)

    x, r, sc = make("x", 3, d), make("res", 3, d), make("scale", d)
    if which is not None:
        t = {"x": x, "res": r, "scale": sc}[which]
        assert t.data_ptr() % 16 == offset % 16
    got = fused_mod.plan(x, r, sc)
    assert tuple(got) == want
    per = 16 // es
    assert 32 * got.vals * got.warps_per_row * per >= d
    assert rn.WARPS % got.warps_per_row == 0
    assert got.vals == fused_mod.WARP_VALS \
        or got.warps_per_row in (1, rn.WARPS)


# --- backward (the reference has no backward kernel: jax.grad of its jnp paths) ----

BWD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}   # times max |reference grad|


def _close_bwd(got, want, dtype, what):
    w = np.asarray(want, np.float32)
    err = np.abs(_np(got) - w).max()
    assert err <= BWD_TOL[dtype] * np.abs(w).max(), (
        f"{what}: {err:.3e} > {BWD_TOL[dtype]} * {np.abs(w).max():.3e}")


@pytest.mark.parametrize("impl", [None, "cuda_core"])
@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_plain_matches_reference_grad(s, d, causal,
                                                          dtype, impl):
    """GQA 4/2: the plain backward (from the plain forward's LSE)
    against ``jax.vjp`` of the reference's ``attn_naive`` for one seeded
    cotangent; the LSE against a logsumexp of the reference's scaled,
    masked scores (fp32 scores of the same values, atol 2e-5).  bf16 with
    ``impl`` None repeats the tensor-core kernels' roundings of P and dS;
    ``"cuda_core"`` (and fp32 either way) keeps them in fp32."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(2, s, s, 4, 2, d, dtype)
    jdo, tdo = _pair(RNG.standard_normal((2, s, 4, d)), dtype)
    pos = jnp.arange(s)
    _, vjp = jax.vjp(lambda q, k, v: jlayers.attn_naive(
        q, k, v, q_pos=pos, k_pos=pos, causal=causal), jq, jk, jv)
    want = vjp(jdo)
    _, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, tdo, lse, causal=causal,
                                       impl=impl)
    for name, g, w, t in zip("qkv", got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close_bwd(g, w, dtype, f"d{name}")
    qf, kf = (np.asarray(x.astype(jnp.float32)) for x in (jq, jk))
    qg = qf.reshape(2, s, 2, 2, d)
    sc = np.einsum("bqkgh,bskh->bkgqs", qg, kf) / np.sqrt(d)
    if causal:
        sc = np.where(np.arange(s)[None, :] > np.arange(s)[:, None],
                      -np.inf, sc)
    want_lse = jax.nn.logsumexp(jnp.asarray(sc), axis=-1)
    np.testing.assert_allclose(_np(lse), np.asarray(want_lse).reshape(
        2, 4, s), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype,impl,kernel", [
    (torch.float32, None, "cuda_core"), (torch.bfloat16, None, "wgmma"),
    (torch.bfloat16, "cuda_core", "cuda_core"),
    (torch.float32, "cuda_core", "cuda_core")])
def test_flash_attention_bwd_routes_by_dtype_and_impl(dtype, impl, kernel):
    """fp32 takes the CUDA-core kernels, bf16 the tensor-core ones, and
    ``impl="cuda_core"`` pins the CUDA-core ones: the plain version rounds
    P and dS (as ``WGMMA_BWD_SPLIT`` says) exactly when the kernel does,
    and the launcher takes only its kernel's blocks.  An unknown ``impl``
    raises in both."""
    assert fa.kernel_for(dtype, impl) == kernel
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 70, 4, 32, generator=gen).to(dtype)
                   for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    _, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, do, lse, impl=impl)
    fp32_ops = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                            impl="cuda_core")
    split, one = (fa.flash_attention_bwd_plain(
        q, k, v, do, lse, impl=impl,
        split=dict.fromkeys(fa.WGMMA_BWD_SPLIT, part)) for part in (True,
                                                                    False))
    same = [all(torch.equal(a, b) for a, b in zip(x, fp32_ops))
            for x in (got, split, one)]
    if kernel == "cuda_core":       # nothing rounds, whatever split says
        assert same == [True, True, True]
    else:                           # rounded, and the split counts
        assert same == [False, False, False]
        assert not all(torch.equal(a, b) for a, b in zip(split, one))
    with pytest.raises(ValueError, match="block_q=16"):
        fa.flash_attention_bwd_cuda(q, k, v, do, lse, impl=impl, block_q=16)
    if kernel == "cuda_core":       # 128 is a tensor-core block only
        with pytest.raises(ValueError, match="block_k=128"):
            fa.flash_attention_bwd_cuda(q, k, v, do, lse, impl=impl,
                                        block_k=128)
    else:                           # 32 a CUDA-core block only
        with pytest.raises(ValueError, match="block_k=32"):
            fa.flash_attention_bwd_cuda(q, k, v, do, lse, impl=impl,
                                        block_k=32)
    for bk in fa.BWD_BLOCK_CHOICES[kernel]:   # taken: CPU tensors refused
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.flash_attention_bwd_cuda(q, k, v, do, lse, impl=impl,
                                        block_k=bk)
    for fn in (fa.flash_attention_bwd_plain, fa.flash_attention_bwd_cuda):
        with pytest.raises(ValueError, match="impl='tiled'"):
            fn(q, k, v, do, lse, impl="tiled")


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("dtype,impl", [(torch.float32, None),
                                        (torch.bfloat16, "cuda_core"),
                                        (torch.bfloat16, None)])
def test_flash_attention_bwd_cuda_refuses_unaligned_rows(which, dtype, impl):
    """Both pairs of backward kernels copy rows 16 bytes at a time: an
    input whose base is not on a 16-byte boundary is refused before the
    device is looked at (here on CPU tensors, which the wrapper otherwise
    refuses for not lying on the card), for the CUDA-core kernels as for
    the tensor-core ones; nothing falls back."""
    gen = torch.Generator().manual_seed(5)
    args = [torch.randn(1, 64, n, 64, generator=gen).to(dtype)
            for n in (4, 2, 2, 4)]
    lse = torch.zeros(1, 4, 64)
    i = ("q", "k", "v", "do").index(which)
    flat = torch.zeros(args[i].numel() + 1, dtype=dtype)
    args[i] = flat[1:].view(args[i].shape).copy_(args[i])
    with pytest.raises(ValueError,
                       match=f"{which} must start on a 16-byte boundary"):
        fa.flash_attention_bwd_cuda(*args, lse, impl=impl)
    args[i] = args[i].clone()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_cuda(*args, lse, impl=impl)


def test_cuda_core_bwd_blocks_mirror_the_source():
    """``BWD_BLOCK_CHOICES["cuda_core"]`` is the source's kBlockSmall and
    kBlockLarge (each an instantiation of both CUDA-core kernels), the
    default pair is among them, the streamed tile is the plain version's
    ``BWD_BLOCK``, and the wrapper names the C entry's scratch refusal."""
    src = (Path(fa.__file__).parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()
    m = re.search(r"constexpr int kBlockSmall = (\d+), kBlockLarge = (\d+);",
                  src)
    assert m and tuple(map(int, m.groups())) == fa.BWD_BLOCK_CHOICES[
        "cuda_core"]
    assert set(fa.BWD_BLOCKS["cuda_core"]) <= set(
        fa.BWD_BLOCK_CHOICES["cuda_core"])
    m = re.search(r"constexpr int kCols = (\d+);", src)
    assert m and int(m.group(1)) == fa.BWD_BLOCK
    assert "-7 scratch" in src and fa._BWD_ERRORS[-7] == "scratch"


@pytest.mark.parametrize("b,sq,h,sms,want", [
    (4, 1024, 15, 132, (64, 32)),       # the train shape: 960 blocks of 64
    (4, 128, 15, 132, (32, 32)),        # the plan phase's fp32 fits
    (2, 128, 15, 132, (32, 32)),
    (1, 128, 15, 132, (32, 32)),
    (4, 256, 15, 132, (32, 32)),        # 240 blocks: under two an SM
    (11, 128, 12, 132, (32, 32)),       # 264 blocks: the limit
    (1, 1089, 16, 132, (64, 32)),       # 18 tiles x 16 = 288 blocks
    (4, 128, 15, 30, (64, 32)),         # a card of fewer SMs
])
def test_bwd_block_pair_adapts_the_cuda_core_dq_block_to_the_grid(
        b, sq, h, sms, want):
    """The CUDA-core dQ kernel takes 32-row blocks while its 64-row grid
    is at most ``BWD_SMALL_GRID`` blocks an SM, else 64; the dK/dV block
    and the tensor-core pair are the fixed defaults."""
    assert fa.bwd_block_pair("cuda_core", b, sq, h, sms) == want
    assert want[1] == fa.BWD_BLOCKS["cuda_core"][1]
    assert fa.bwd_block_pair("wgmma", b, sq, h, sms) == fa.BWD_BLOCKS[
        "wgmma"]


def test_library_digest_covers_included_headers(tmp_path, monkeypatch):
    """Both attention sources include ``wgmma.cuh``: an edit to the header
    changes their libraries' names (so no stale build loads) and leaves a
    source that does not include it alone."""
    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources_of("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "wgmma.cuh"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = tmp_path / "wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    changed = {n for n in _build.SOURCES if before[n] != after[n]}
    assert changed == {"flash_attention", "flash_attention_bwd"}


def test_wgmma_bwd_split_mirrors_the_source():
    """The plain version's ``WGMMA_BWD_SPLIT`` is the tensor-core kernels'
    ``kSplit*`` constants, product by product."""
    src = (Path(fa.__file__).parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()
    names = {"p_dv": "kSplitPdV", "ds_dk": "kSplitDsDk", "ds_dq": "kSplitDsDq"}
    assert set(fa.WGMMA_BWD_SPLIT) == set(names)
    for part, const in names.items():
        m = re.search(rf"constexpr bool {const} = (true|false);", src)
        assert m and (m.group(1) == "true") == fa.WGMMA_BWD_SPLIT[part], part


@pytest.mark.parametrize("shape", [(37, 960), (2, 19, 1001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_rmsnorm_bwd_plain_matches_reference_grad(shape, dtype):
    """The plain backward against ``jax.vjp`` of the reference's
    ``rms_norm_residual(impl="jnp")`` (res, delta, scale -> (h, y)) for
    seeded cotangents of both outputs: dx = dres = d(res) = d(delta)."""
    jx, tx = _pair(RNG.standard_normal(shape), dtype)
    jr, tr = _pair(RNG.standard_normal(shape), dtype)
    js, ts = _pair(1 + 0.1 * RNG.standard_normal(shape[-1:]), dtype)
    jdh, tdh = _pair(RNG.standard_normal(shape), dtype)
    jdy, tdy = _pair(RNG.standard_normal(shape), dtype)
    _, vjp = jax.vjp(lambda x, r, sc: jlayers.rms_norm_residual(
        x, r, sc, impl="jnp"), jx, jr, js)
    wx, wr, ws = vjp((jdh, jdy))
    dsum, dscale = fused_mod.fused_add_rmsnorm_bwd_plain(tdh, tdy, tx, tr, ts)
    assert dsum.dtype == tx.dtype and dscale.shape == ts.shape
    _close_bwd(dsum, wx, dtype, "dx")
    _close_bwd(dsum, wr, dtype, "dres")
    _close_bwd(dscale, ws, dtype, "dscale")


# --- the fused norm backward's launch plan and order of summation ------------------

_PLAN_SHAPES = [(1, 960), (7, 960), (8, 960), (9, 960), (4071, 960),
                (4096, 960), (16384, 960), (100_000, 960), (33, 1001),
                (64, 8192), (5, 64), (2053, 512)]
_BWD_SRC = (Path(fused_mod.__file__).parents[1] / "csrc"
            / "fused_add_rmsnorm_bwd.cu").read_text()
_BWD_CONST = dict(re.findall(r"constexpr (?:int|bool) (k\w+) = (\w+);",
                             _BWD_SRC))
_GROUP_BLOCKS = int(_BWD_CONST["kGroupBlocks"])


def _row_plan(d, dtype, offset=0):
    """``rmsnorm.plan`` of the backward's five inputs, x ``offset``
    elements off a 16-byte boundary."""
    x = torch.zeros(d + offset, dtype=dtype)[offset:].view(1, d)
    z = torch.zeros(1, d, dtype=dtype)
    return rn.plan(x, z, z[0], z, z, warp_vals=fused_mod.BWD_WARP_VALS)


def _bwd_blocks(dh, dy, x, res, scale, bp, group_blocks=_GROUP_BLOCKS,
                eps=1e-5):
    """The plain backward with dscale added in the kernel's order under
    launch ``bp``: in each block, row group k (its warps) takes step row
    i when i % (rows a step) % (row groups) == k and adds dh * n over its
    rows in row order; the group rows are added in group order into the
    block's fp32 partial row; the partial rows of each run of
    ``group_blocks`` blocks are added in block order, then those sums in
    order (the kernel splits the columns over its reducers, which changes
    no sum).  Not bit for bit the kernel's: it takes no fused multiply-add
    and PyTorch's rsqrt."""
    d = x.shape[-1]
    dsum, dhn = fused_mod._bwd_rows(dh, dy, x, res, scale, eps)
    dhn = dhn.reshape(-1, d)
    groups = rn.WARPS // bp.warps_per_row
    parts = []
    for b in range(bp.blocks):
        run = dhn[b * bp.rows_per_block:(b + 1) * bp.rows_per_block]
        acc = torch.zeros(groups, d)
        for i, row in enumerate(run):
            k = i % bp.rows_per_step % groups
            acc[k] = acc[k] + row
        part = torch.zeros(d)
        for k in range(groups):
            part = part + acc[k]
        parts.append(part)
    sums = []
    for g0 in range(0, bp.blocks, group_blocks):
        t = torch.zeros(d)
        for part in parts[g0:g0 + group_blocks]:
            t = t + part
        sums.append(t)
    total = torch.zeros(d)
    for t in sums:
        total = total + t
    return dsum.to(x.dtype), total.to(scale.dtype)


@pytest.mark.parametrize("rows,d", _PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [_BF16, _F32])
@pytest.mark.parametrize("sms", [132, 114, 3])
def test_fused_bwd_plan_covers_every_row_once(rows, d, dtype, sms):
    """The persistent grid: at most one block an SM (``BWD_BLOCKS_PER_SM``)
    and one a step, every block a whole number of steps and at least one
    row, the runs covering the rows exactly once (1 and 7 rows: one block);
    a ring on the 16-byte plan only, no more stages than a block has steps,
    and the ring within one block's shared memory."""
    es = torch.tensor([], dtype=dtype).element_size()
    pl = _row_plan(d, dtype)
    bp = fused_mod.bwd_plan(rows, d, es, pl, sms)
    assert tuple(bp[:3]) == tuple(pl)
    assert bp.vals in ((1, 2, 4) if dtype == _BF16 else (1, 2, 4, 8))
    steps = -(-rows // bp.rows_per_step)
    assert 1 <= bp.blocks <= min(sms * fused_mod.BWD_BLOCKS_PER_SM, steps)
    assert bp.rows_per_block % bp.rows_per_step == 0
    runs = [(b * bp.rows_per_block, min(rows, (b + 1) * bp.rows_per_block))
            for b in range(bp.blocks)]
    assert all(lo < hi for lo, hi in runs)            # no block without rows
    assert runs[0][0] == 0 and runs[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    if rows <= bp.rows_per_step:
        assert bp.blocks == 1
    per = bp.rows_per_block // bp.rows_per_step
    if pl.vector:
        assert 1 <= bp.stages <= min(fused_mod.BWD_STAGES, per)
    else:
        assert bp.stages == 0
    ring = bp.stages * bp.rows_per_step * 4 * d * es
    assert ring <= fused_mod.BLOCK_SMEM - fused_mod.STATIC_SMEM
    assert bp.blocks <= sms or fused_mod.BWD_REDUCERS < sms


@pytest.mark.parametrize("setting,sms,want", [
    (dict(BWD_STAGES=1), 132, dict(stages=1, rows_per_step=8)),
    (dict(BWD_STAGES=4), 132, dict(stages=3, rows_per_step=8)),  # 3 fit
    (dict(BWD_ROWS_PER_STEP=16), 132,
     dict(stages=1, rows_per_step=16)),                          # 123 KB
    (dict(BWD_ROWS_PER_STEP=4, BWD_STAGES=4), 132,
     dict(stages=4, rows_per_step=4)),
    (dict(BWD_BLOCKS_PER_SM=2), 132, dict(stages=1, blocks=256)),
    (dict(BWD_BLOCKS_PER_SM=2, BWD_ROWS_PER_STEP=4), 132,
     dict(stages=2, blocks=256)),
    (dict(BWD_BLOCKS_PER_SM=2), 17, dict(stages=1, blocks=32)),
    (dict(BWD_BLOCKS_PER_SM=2), 16, dict(stages=2, blocks=16)),
])
def test_fused_bwd_plan_settings(monkeypatch, setting, sms, want):
    """The ablation settings at the train shape, 4096 x 960 bf16: stages
    and rows a step shrink to what fits in 227 KB (115 KB a block at two
    blocks an SM); a card with no more SMs than the kernel's reducers
    takes one block an SM, so no grid can leave a waiting reducer on
    every SM while blocks wait for one."""
    for k, v in setting.items():
        monkeypatch.setattr(fused_mod, k, v)
    bp = fused_mod.bwd_plan(4096, 960, 2, _row_plan(960, _BF16), sms)
    assert {k: getattr(bp, k) for k in want} == want
    assert bp.blocks <= sms or fused_mod.BWD_REDUCERS < sms


def test_fused_bwd_plan_fits_one_row_at_two_blocks_an_sm(monkeypatch):
    """An fp32 row of 8192 (128 KB over x, res, dh, dy) does not fit two
    blocks an SM: the plan takes one, one stage of one row."""
    monkeypatch.setattr(fused_mod, "BWD_BLOCKS_PER_SM", 2)
    bp = fused_mod.bwd_plan(64, 8192, 4, _row_plan(8192, _F32), 132)
    assert (bp.stages, bp.rows_per_step, bp.blocks) == (1, 1, 64)
    assert bp.stages * bp.rows_per_step * 4 * 8192 * 4 == 131072
    monkeypatch.setattr(fused_mod, "BWD_STAGES", 5)
    with pytest.raises(ValueError, match="stages=5"):
        fused_mod.bwd_plan(64, 960, 2, _row_plan(960, _BF16), 132)


def test_fused_bwd_plan_mirrors_the_source():
    """The planner's warps a block, largest ring, spans a stage and
    reducers are the kernel's ``kWarps``, ``kMaxStages``, ``kSpans`` and
    ``kReducers``; the 16-byte plan is built with bulk copies only; the C
    entry refuses a grid that could hang (-4); one kernel, no second."""
    assert int(_BWD_CONST["kWarps"]) == rn.WARPS
    assert int(_BWD_CONST["kMaxStages"]) == 4
    assert int(_BWD_CONST["kSpans"]) == 4
    assert int(_BWD_CONST["kReducers"]) == fused_mod.BWD_REDUCERS
    assert _BWD_CONST["kBulk"] == "true"
    assert "launch_vals<T, true, kBulk>" in _BWD_SRC
    assert "launch_vals<T, true, false>" not in _BWD_SRC
    assert "return -4;" in _BWD_SRC and -4 in fused_mod._BWD_ERRORS
    assert _BWD_SRC.count("<<<") == 1 and "dscale_reduce" not in _BWD_SRC


@pytest.mark.parametrize("rows,d", [(37, 960), (1000, 96), (4071, 960),
                                    (9, 1001), (300, 8192), (2053, 64)])
@pytest.mark.parametrize("setting,group_blocks", [
    ({}, _GROUP_BLOCKS), ({}, 1), ({}, 1 << 30),
    (dict(BWD_ROWS_PER_STEP=3), _GROUP_BLOCKS)])
def test_fused_bwd_block_order_matches_plain(monkeypatch, rows, d, setting,
                                             group_blocks):
    """The kernel's order of summation for dscale (per row group in row
    order, the groups into a block's fp32 partial row, the partial rows in
    block order within groups of blocks, then the groups in order), on
    rows that are no multiple of the step: dsum is the plain backward's
    bit for bit, dscale within 1e-6 of its max."""
    for k, v in setting.items():
        monkeypatch.setattr(fused_mod, k, v)
    gen = torch.Generator().manual_seed(rows + d)
    x, r, dh, dy = (torch.randn(rows, d, generator=gen) for _ in range(4))
    sc = 1 + 0.1 * torch.randn(d, generator=gen)
    bp = fused_mod.bwd_plan(rows, d, 4, _row_plan(d, _F32), 132)
    got = _bwd_blocks(dh, dy, x, r, sc, bp, group_blocks)
    want = fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, r, sc)
    assert torch.equal(got[0], want[0])
    assert (got[1] - want[1]).abs().max() <= 1e-6 * want[1].abs().max()


@pytest.mark.parametrize("shape", [(37, 960), (2, 19, 1001), (9, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bwd_block_order_matches_reference_grad(monkeypatch, shape,
                                                      dtype):
    """The kernel's order of summation against ``jax.vjp`` of the
    reference's ``rms_norm_residual(impl="jnp")``, as the plain backward
    is held (``BWD_TOL`` of max |reference grad|)."""
    jx, tx = _pair(RNG.standard_normal(shape), dtype)
    jr, tr = _pair(RNG.standard_normal(shape), dtype)
    js, ts = _pair(1 + 0.1 * RNG.standard_normal(shape[-1:]), dtype)
    jdh, tdh = _pair(RNG.standard_normal(shape), dtype)
    jdy, tdy = _pair(RNG.standard_normal(shape), dtype)
    _, vjp = jax.vjp(lambda x, r, sc: jlayers.rms_norm_residual(
        x, r, sc, impl="jnp"), jx, jr, js)
    wx, wr, ws = vjp((jdh, jdy))
    rows, d = int(np.prod(shape[:-1])), shape[-1]
    monkeypatch.setattr(fused_mod, "BWD_ROWS_PER_STEP", 2)
    bp = fused_mod.bwd_plan(rows, d, tx.element_size(),
                            _row_plan(d, tx.dtype), 4)
    assert bp.blocks > 1
    dsum, dscale = _bwd_blocks(tdh, tdy, tx, tr, ts, bp)
    assert dsum.dtype == tx.dtype and dscale.dtype == ts.dtype
    _close_bwd(dsum, wx, dtype, "dx")
    _close_bwd(dsum, wr, dtype, "dres")
    _close_bwd(dscale, ws, dtype, "dscale")


def test_no_path_reaches_the_block_order_mirror(monkeypatch):
    """The mirror lives in the tests: no module of the port and not
    ``chip_smoke.py`` names it; the CPU path takes the plain backward, and
    a tensor off the CPU goes to the launch (here a stand-in), never to
    the plain version."""
    pkg = Path(fused_mod.__file__).parents[1]
    users = {p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
             if "bwd_blocks" in p.read_text()}
    assert users == set()
    assert "bwd_blocks" not in Path(ROOT, "chip_smoke.py").read_text()

    def refuse(*a, **kw):
        raise AssertionError("the plain backward was called")
    plain, real = [], fused_mod.fused_add_rmsnorm_bwd_plain
    monkeypatch.setattr(fused_mod, "fused_add_rmsnorm_bwd_plain",
                        lambda *a, **kw: plain.append(1) or real(*a, **kw))
    x = _t(3, 64).requires_grad_()
    sum(ops.fused_add_rmsnorm(x, x, _t(64))).sum().backward()
    assert plain == [1] and x.grad is not None
    launched = []
    monkeypatch.setattr(fused_mod, "fused_add_rmsnorm_bwd_plain", refuse)
    monkeypatch.setattr(fused_mod, "fused_add_rmsnorm_bwd_cuda",
                        lambda *a, **kw: launched.append(1) or (a[0], a[4]))
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    ops.reset_launches()
    y = _t(3, 64)
    ops.fused_add_rmsnorm_bwd(y, y, y, y, _t(64))
    assert launched == [1] and ops.LAUNCHES["fused_add_rmsnorm_bwd"] == 1
    ops.reset_launches()        # a stand-in launched: no count survives it


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_grads_equal_attn_naive(causal):
    """On the CPU the autograd Function runs the plain forward and backward:
    gradients through ``ops.flash_attention`` equal those through the
    port's ``attn_naive`` (fp32, 1e-5 of max |g|; 1e-4 on O for a non-
    multiple-of-the-tile S with GQA 6/2)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=gen).requires_grad_()
               for shape in ((2, 77, 6, 32), (2, 77, 2, 32), (2, 77, 2, 32)))
    do = torch.randn(2, 77, 6, 32, generator=gen)
    pos = torch.arange(77)
    o1 = ops.flash_attention(q, k, v, causal=causal)
    o2 = tlayers.attn_naive(q, k, v, q_pos=pos, k_pos=pos, causal=causal)
    torch.testing.assert_close(o1, o2, rtol=0, atol=1e-5)
    for g1, g2 in zip(torch.autograd.grad(o1, (q, k, v), do),
                      torch.autograd.grad(o2, (q, k, v), do)):
        assert (g1 - g2).abs().max() <= 1e-5 * g2.abs().max()


def test_fused_function_grads_equal_the_jnp_seam():
    """Gradients through ``ops.fused_add_rmsnorm`` (the Function, plain
    versions on the CPU) equal those through ``rms_norm_residual``'s plain
    path, fp32, with both outputs used."""
    gen = torch.Generator().manual_seed(1)
    x, r = (torch.randn(2, 13, 96, generator=gen).requires_grad_()
            for _ in range(2))
    sc = (1 + 0.1 * torch.randn(96, generator=gen)).requires_grad_()
    dh, dy = torch.randn(2, 2, 13, 96, generator=gen)
    got = torch.autograd.grad(tlayers.rms_norm_residual(
        x, r, sc, impl="kernel"), (x, r, sc), (dh, dy))
    want = torch.autograd.grad(tlayers.rms_norm_residual(
        x, r, sc, impl="jnp"), (x, r, sc), (dh, dy))
    for g1, g2 in zip(got, want):
        assert (g1 - g2).abs().max() <= 1e-5 * g2.abs().max()


def test_inputs_needing_no_grad_keep_the_forward_only_path(monkeypatch):
    """No grad wanted (no input requires one, or grad mode off): the
    wrappers run the forward alone, and attention asks for no LSE."""
    asked = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **kw: (
        asked.append(kw.get("return_lse", False)) or plain(*a, **kw)))
    q = _t(1, 8, 2, 16)
    assert ops.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        ops.flash_attention(qg, qg, qg)
        assert ops.fused_add_rmsnorm(qg, qg, _t(16))[0].grad_fn is None
    assert asked == [False, False]
    assert ops.flash_attention(qg, qg, qg).grad_fn is not None
    assert asked[-1] is True


def test_backward_wrappers_never_take_the_plain_version_off_the_cpu():
    """The backward wrappers route like the forward ones: a tensor off the
    CPU goes to the CUDA launch, which raises here (no card, or a CPU
    tensor handed to it directly)."""
    q, lse = _t(1, 8, 2, 64, device="meta"), _t(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bwd(q, q, q, q, lse)
    x = _t(2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_add_rmsnorm_bwd(x, x, x, x, _t(64, device="meta"))
    c = _t(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_cuda(c, c, c, c, _t(1, 2, 8))
    y = _t(2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_mod.fused_add_rmsnorm_bwd_cuda(y, y, y, y, _t(64))
    assert not ops.LAUNCHES["flash_attention_bwd"]
    assert not ops.LAUNCHES["fused_add_rmsnorm_bwd"]


def _attention_ablations():
    from repro_torch.bench import attention_ablations
    return attention_ablations


@pytest.mark.parametrize("name", ["bwd_f32_base", "bwd_f32_two_stages"])
def test_attention_bwd_f32_ablation_variants_apply(name):
    """The fp32 backward's variants find their anchor in
    ``csrc/flash_attention_bwd.cu`` and change only the CUDA-core kernels'
    stage count; the bench times them in fp32 (``F32_BWD_SHAPES``: the
    train shape and the plan phase's fit shape)."""
    ab = _attention_ablations()
    base = (Path(ROOT) / "src/repro_torch/csrc/flash_attention_bwd.cu"
            ).read_text()
    src = ab.variant_source(name)
    removed = set(base.splitlines()) - set(src.splitlines())
    assert len(removed) == (name != "bwd_f32_base")
    if name == "bwd_f32_two_stages":
        assert removed == {"constexpr int kStages = 1;"}
        assert "constexpr int kStages = 2;" in src
    assert ab.F32_BWD_SHAPES == ((4, 1024, 15, 5, 64), (4, 128, 15, 5, 64))


@pytest.mark.parametrize("name", ["f32_base", "f32_two_stages",
                                  "f32_mask_every_tile", "f32_generic_copy",
                                  "f32_expf"])
def test_attention_fp32_ablation_variants_apply(name):
    """Each fp32 forward variant of ``bench/attention_ablations.py`` finds
    its anchor in ``csrc/flash_attention.cu`` (the bench raises otherwise)
    and changes only what it names: the source constant it flips, the
    mask's condition, the copies' calls, the two exponentials."""
    ab = _attention_ablations()
    base = (Path(ROOT) / "src/repro_torch/csrc/flash_attention.cu").read_text()
    src = ab.variant_source(name)
    assert name.startswith("f32_") and name in ab.VARIANTS
    removed = set(base.splitlines()) - set(src.splitlines())
    assert len(removed) == {"f32_base": 0, "f32_expf": 2,
                            "f32_generic_copy": 3}.get(name, 1)
    if name == "f32_two_stages":
        assert "constexpr int kKvStages = 2;" in src
    if name == "f32_mask_every_tile":
        assert "      if (true) {" in src
    if name == "f32_generic_copy":     # the three tile copies
        assert "copy_rows<" not in src and src.count("copy_rows_each<") == 3
    if name == "f32_expf":
        assert src.count("expf(kLn2 * ") == 2
