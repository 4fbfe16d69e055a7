"""Port kernels (plain versions on the CPU) vs the reference's Pallas kernels.

The reference's ``repro.kernels.ops`` wrappers run the Pallas kernels in
interpret mode on the CPU; the port's ``repro_torch.kernels.ops`` wrappers
route CPU tensors to each kernel's plain PyTorch version.  Both get the
same numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2 (one bf16 ulp at |x|~4);
SSD y 1e-4 / 4e-2 and state 1e-4 / 1e-2 (fp32 / bf16).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import add as add_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod

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


@pytest.mark.parametrize("block_q", [16, 32])
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
    (torch.float32, (16, 32), (48, 64, 128)),
])
def test_flash_attention_block_q_by_dtype(dtype, ok, refused):
    """bf16 runs the wgmma kernel (one or two 64-row warpgroups), fp32 the
    CUDA-core one; the plain version is held to the same tiles, and None
    takes each kernel's default."""
    q = _t(1, 40, 2, 64, dtype=dtype)
    for bq in ok:
        assert ops.flash_attention(q, q, q, block_q=bq).shape == q.shape
    for bq in refused:
        with pytest.raises(ValueError, match="block_q"):
            ops.flash_attention(q, q, q, block_q=bq)
    assert fa.default_block_q(dtype) == ok[-1]
    assert fa.default_block_q(dtype, "cuda_core") == 32
    with pytest.raises(ValueError, match="impl"):
        fa.kernel_for(dtype, "tf32")


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
    assert ops.LAUNCHES == dict.fromkeys(
        ["flash_attention", "fused_add_rmsnorm", "flash_attention_decode",
         "rmsnorm", "ssd_scan", "add"], 0)


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
