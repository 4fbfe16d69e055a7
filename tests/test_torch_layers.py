"""``repro_torch.models.layers`` vs ``repro.models.layers``, function by function.

Inputs come from a seeded numpy generator and go to both packages.  fp32
comparisons hold to 2e-5 (the reference's kernel tolerance; both sides
compute the same fp32 expressions, differing only in summation order);
bf16 to 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

RNG = np.random.default_rng(5)
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _both(shape, dtype="float32", scale=1.0):
    a = RNG.standard_normal(shape) * scale
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _close(got, want, tol=F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm(dtype, tol):
    jx, tx = _both((3, 7, 96), dtype)
    js, ts = _both((96,), dtype)
    got = TL.rms_norm(tx, ts, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, JL.rms_norm(jx, js, 1e-5), tol)


@pytest.mark.parametrize("impl_t,impl_j", [("jnp", "jnp"),
                                           ("kernel", "pallas")])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rms_norm_residual(impl_t, impl_j, dtype, tol):
    jx, tx = _both((2, 9, 128), dtype)
    jd, td = _both((2, 9, 128), dtype)
    js, ts = _both((128,), dtype)
    h, y = TL.rms_norm_residual(tx, td, ts, 1e-5, impl=impl_t)
    wh, wy = JL.rms_norm_residual(jx, jd, js, 1e-5, impl=impl_j)
    _close(h, wh, tol)
    _close(y, wy, tol)


def test_rms_norm_residual_unknown_impl():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        TL.rms_norm_residual(x, x, torch.ones(64), impl="pallas")


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_rope(per_row, dtype, tol):
    jx, tx = _both((2, 11, 3, 64), dtype)
    pos = RNG.integers(0, 4000, (2, 11) if per_row else (11,))
    got = TL.rope(tx, torch.from_numpy(pos), 1e4)
    want = JL.rope(jx, jnp.asarray(pos), 1e4)
    assert got.dtype == tx.dtype
    # positions up to 4000 put fp32 angles at ~1e3 rad: sin/cos of such
    # angles agree to ~1e-4 between the two libraries' fp32 routines
    _close(got, want, dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else tol)


def test_swiglu():
    jx, tx = _both((2, 5, 64))
    jg, tg = _both((64, 96), scale=0.1)
    ju, tu = _both((64, 96), scale=0.1)
    jd, td = _both((96, 64), scale=0.1)
    _close(TL.swiglu(tx, tg, tu, td), JL.swiglu(jx, jg, ju, jd))


def test_split_gqa_and_mask_bias():
    q = torch.arange(2 * 3 * 6 * 4, dtype=torch.float32).reshape(2, 3, 6, 4)
    np.testing.assert_array_equal(
        TL._split_gqa(q, 2).numpy(),
        np.asarray(JL._split_gqa(jnp.asarray(q.numpy()), 2)))
    with pytest.raises(ValueError):
        TL._split_gqa(q, 4)
    qp, kp = np.arange(5, 12), np.arange(0, 12)
    for causal, window, kv_len in [(True, 0, None), (False, 3, None),
                                   (True, 4, 9), (False, 0, 7)]:
        got = TL._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp),
                            causal, window, kv_len)
        want = JL._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal,
                             window, kv_len)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(b, sq, sk, h, kh, d, dtype="float32"):
    return (_both((b, sq, h, d), dtype), _both((b, sk, kh, d), dtype),
            _both((b, sk, kh, d), dtype))


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, None), (False, 0, None), (True, 8, None), (True, 0, 13)])
def test_attn_naive(causal, window, kv_len):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 20, 20, 6, 2, 16)
    pos = np.arange(20)
    got = TL.attn_naive(tq, tk, tv, q_pos=torch.from_numpy(pos),
                        k_pos=torch.from_numpy(pos), causal=causal,
                        window=window, kv_len=kv_len)
    want = JL.attn_naive(jq, jk, jv, q_pos=jnp.asarray(pos),
                         k_pos=jnp.asarray(pos), causal=causal,
                         window=window, kv_len=kv_len)
    _close(got, want)


@pytest.mark.parametrize("s,block", [(40, 16), (48, 16), (40, 1024)])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_attn_chunked(s, block, dtype, tol):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, 4, 2, 16, dtype)
    pos = np.arange(s)
    got = TL.attn_chunked(tq, tk, tv, q_pos=torch.from_numpy(pos),
                          k_pos=torch.from_numpy(pos), block=block)
    want = JL.attn_chunked(jq, jk, jv, q_pos=jnp.asarray(pos),
                           k_pos=jnp.asarray(pos), block=block)
    assert got.dtype == tq.dtype
    _close(got, want, tol)


def test_attn_chunked_masks_its_padding_when_not_causal():
    """The port masks the KV padding it adds for a ragged last chunk on
    every path; it equals naive attention.  (The reference masks the pad
    only through the causal mask or an explicit kv_len.)"""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 10, 40, 2, 2, 16)
    qp, kp = torch.arange(10), torch.arange(40)
    got = TL.attn_chunked(tq, tk, tv, q_pos=qp, k_pos=kp, causal=False,
                          block=16)
    want = TL.attn_naive(tq, tk, tv, q_pos=qp, k_pos=kp, causal=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cache_len,window", [(1, 0), (17, 0), (30, 0),
                                              (25, 8)])
def test_attn_decode(cache_len, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 30, 6, 2, 16)
    got = TL.attn_decode(tq, tk, tv, cache_len=cache_len, window=window)
    want = JL.attn_decode(jq, jk, jv, cache_len=jnp.asarray(cache_len),
                          window=window)
    _close(got, want)


@pytest.mark.parametrize("cache_len,window", [(0, 0), (1, 0), (17, 0),
                                              (30, 0), (25, 8)])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_attn_decode_kernel_matches_pallas(cache_len, window, d, dtype, tol):
    """``impl="kernel"`` against the reference's ``impl="pallas"``: the
    decode kernel for a scalar length, the plain path under a window."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 30, 6, 2, d, dtype)
    got = TL.attn_decode(tq, tk, tv, cache_len=cache_len, window=window,
                         impl="kernel")
    want = JL.attn_decode(jq, jk, jv, cache_len=jnp.asarray(cache_len),
                          window=window, impl="pallas")
    assert got.dtype == tq.dtype
    _close(got, want, tol)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attn_decode_per_row_matches_reference(window, impl):
    """(B,) lengths 1, 17 and 30 against the reference's per-row mask; a
    (B,) length takes the plain path under ``impl="kernel"`` too, as
    under the reference's ``impl="pallas"``."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 30, 6, 2, 16)
    lens = np.array([1, 17, 30])
    got = TL.attn_decode(tq, tk, tv, cache_len=torch.from_numpy(lens),
                         window=window, impl=impl)
    want = JL.attn_decode(jq, jk, jv, cache_len=jnp.asarray(lens),
                          window=window,
                          impl="pallas" if impl == "kernel" else "naive")
    _close(got, want)
    plain = TL.attn_decode(tq, tk, tv, cache_len=torch.from_numpy(lens),
                           window=window)
    assert torch.equal(got, plain)


def test_attn_decode_waits_for_later_slices():
    """Per-row lengths are ported (the rows equal the scalar path's at the
    same length, bit for bit); an unknown impl still raises.  Sliding-window
    prefill is ported (``test_torch_moe.py`` holds it against the
    reference): the dispatch reaches it."""
    (_, tq), (_, tk), (_, tv) = _qkv(2, 1, 8, 4, 2, 16)
    rows = TL.attn_decode(tq, tk, tv, cache_len=torch.tensor([3, 8]))
    for i, n in enumerate((3, 8)):
        assert torch.equal(rows[i], TL.attn_decode(
            tq[i:i + 1], tk[i:i + 1], tv[i:i + 1], cache_len=n)[0])
        assert torch.equal(rows[i], TL.attn_decode(
            tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
            cache_len=torch.tensor(n))[0])
    q, c = torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="unknown impl"):
        TL.attn_decode(q, c, c, cache_len=3, impl="pallas")
    z = torch.zeros(1, 16, 2, 16)
    assert torch.equal(TL.attention(z, z, z, impl="chunked", window=4),
                       TL.attn_window_linear(z, z, z, window=4))


@pytest.mark.parametrize("s", [64, 45])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kh", [4, 2])
@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_attention_kernel_dispatch_matches_pallas(s, causal, kh, dtype, tol):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, 4, kh, 64, dtype)
    got = TL.attention(tq, tk, tv, impl="kernel", causal=causal)
    want = JL.attention(jq, jk, jv, impl="pallas", causal=causal)
    _close(got, want, tol)


def test_attention_kernel_routes_like_the_reference():
    """Causal with sq != sk and explicit kv_len leave the kernel for the
    chunked path (layers.py:249-252); both match the reference."""
    from repro_torch.kernels import ops
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 24, 40, 2, 2, 64)
    ops.reset_launches()
    got = TL.attention(tq, tk, tv, impl="kernel", causal=True,
                       q_pos=torch.arange(16, 40))
    want = JL.attention(jq, jk, jv, impl="pallas", causal=True,
                        q_pos=jnp.arange(16, 40))
    _close(got, want)
    got = TL.attention(tq, tk, tv, impl="kernel", causal=False, kv_len=30)
    want = JL.attention(jq, jk, jv, impl="pallas", causal=False, kv_len=30)
    _close(got, want)
    with pytest.raises(ValueError, match="unknown impl"):
        TL.attention(tq, tk, tv, impl="pallas")


def test_pick_attn_impl():
    assert TL.pick_attn_impl("chunked", 128, "cuda") == "chunked"
    assert TL.pick_attn_impl("auto", 128, "cuda") == "kernel"
    assert TL.pick_attn_impl("auto", 128, torch.device("cuda", 0)) == "kernel"
    assert TL.pick_attn_impl("auto", 128, "cpu") == "naive"
    assert TL.pick_attn_impl("auto", 2048, "cpu") == "naive"
    assert TL.pick_attn_impl("auto", 8192, "cpu") == "chunked"
    assert JL.pick_attn_impl("auto", 8192, backend="cpu") == "chunked"
