"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks for a CUDA device through the ``cuda``
fixture and skips without one.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2, fp32 2e-5; SSD y 4e-2 / 1e-4 and state 1e-2 / 1e-4
(the reference's kernel tolerances, ``tests/test_kernels.py``).
"""
import dataclasses
import json
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import add as add_mod
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused as fused_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssd_mod
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
    (2, 77, 77, 4, 2, 16, True),        # reduced configs' head dim
    (2, 150, 150, 4, 2, 32, False),
    (1, 2048, 2048, 120, 120, 64, True),    # calibration: q (1, s, 120, 64)
])
@pytest.mark.parametrize("dtype,block_q", [
    (torch.float32, 64), (torch.float32, 128),      # the CUDA-core kernel
    (torch.bfloat16, 64), (torch.bfloat16, 128),    # the wgmma kernel
])
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


@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_attention_kernel_reads_strided_views(cuda, block_q):
    """(B, S, H, D) views with non-packed strides (a slice of a wider
    projection) are read in place, at both bf16 tiles."""
    qkv = _rand(cuda, 2, 100, 3 * 4, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    got = ops.flash_attention(q, k, v, causal=True, block_q=block_q)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True,
                                    block_q=block_q)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_attention_wgmma_every_head_dim(cuda, d, block_q):
    """Every bf16 head dim runs the wgmma kernel (ragged q and keys, GQA,
    causal and not)."""
    for sq, sk, causal in ((200, 200, True), (130, 70, False)):
        q = _rand(cuda, 2, sq, 6, d, dtype=torch.bfloat16)
        k = _rand(cuda, 2, sk, 2, d, dtype=torch.bfloat16)
        v = _rand(cuda, 2, sk, 2, d, dtype=torch.bfloat16)
        got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                      block_q=block_q)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        block_q=block_q)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("block_q", [None, 64, 128])
def test_flash_attention_cuda_core_kernel_takes_bf16(cuda, block_q):
    """``impl="cuda_core"`` runs the fp32 CUDA-core kernel on bf16 inputs
    (staged as bf16, keeping P in fp32), against the plain version of that
    arithmetic, at its default and both q tiles; a direct launch counts no
    wrapper launch, and a tile it is not built for is refused."""
    q = _rand(cuda, 2, 509, 15, 64, dtype=torch.bfloat16)
    k = _rand(cuda, 2, 509, 5, 64, dtype=torch.bfloat16)
    v = _rand(cuda, 2, 509, 5, 64, dtype=torch.bfloat16)
    ops.reset_launches()
    got = fa.flash_attention_cuda(q, k, v, impl="cuda_core", block_q=block_q)
    want = fa.flash_attention_plain(q, k, v, impl="cuda_core",
                                    block_q=block_q)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 0
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(RuntimeError, match="block_q"):
        fa.flash_attention_cuda(q, k, v, impl="cuda_core", block_q=32)


def _cuda_core_close(q, k, v, causal, block_q, impl=None):
    got = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=block_q,
                                  impl=impl)
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                    impl=impl)
    torch.cuda.synchronize()
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_attention_cuda_core_every_head_dim(cuda, d, block_q):
    """Every head dim runs the fp32 CUDA-core kernel at both q tiles
    (ragged q and keys, GQA, causal and not), and the same instantiation
    on bf16 under ``impl="cuda_core"``."""
    for sq, sk, causal in ((200, 200, True), (130, 70, False)):
        for dtype, impl in ((torch.float32, None),
                            (torch.bfloat16, "cuda_core")):
            q = _rand(cuda, 2, sq, 6, d, dtype=dtype)
            k = _rand(cuda, 2, sk, 2, d, dtype=dtype)
            v = _rand(cuda, 2, sk, 2, d, dtype=dtype)
            _cuda_core_close(q, k, v, causal, block_q, impl)


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (2, 300, 300, 6, 2, 64, True),      # a ragged sk tail on the diagonal
    (1, 100, 1000, 4, 2, 64, False),    # non-causal, sk > sq, ragged tail
    (1, 333, 333, 8, 1, 64, True),      # MQA, causal
    (2, 64, 700, 15, 1, 128, False),    # MQA, one q tile, many K/V tiles
    (1, 1, 65, 2, 2, 16, True),         # one row: one key, then the tail
])
def test_flash_attention_cuda_core_edges(cuda, block_q, b, sq, sk, h, kh, d,
                                         causal):
    """The fp32 CUDA-core kernel where its masks and skips bite: the tile
    holding sk, sk past sq without the causal limit, one KV head for every
    query head, and a q tile almost wholly past sq."""
    q = _rand(cuda, b, sq, h, d, dtype=torch.float32)
    k = _rand(cuda, b, sk, kh, d, dtype=torch.float32)
    v = _rand(cuda, b, sk, kh, d, dtype=torch.float32)
    _cuda_core_close(q, k, v, causal, block_q)


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("dtype,impl", [(torch.float32, None),
                                        (torch.bfloat16, "cuda_core")])
def test_flash_attention_cuda_core_lse_and_stream(cuda, block_q, dtype, impl):
    """With and without the LSE pointer the CUDA-core kernel writes the
    same O bit for bit, at both q tiles; the LSE matches the plain
    version's; and a launch on a side stream gives the same O as on the
    default stream."""
    q = _rand(cuda, 2, 333, 15, 64, dtype=dtype)
    k = _rand(cuda, 2, 333, 5, 64, dtype=dtype)
    v = _rand(cuda, 2, 333, 5, 64, dtype=dtype)
    kw = dict(causal=True, block_q=block_q, impl=impl)
    o1 = fa.flash_attention_cuda(q, k, v, **kw)
    o2, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o3 = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(o1, o3)
    torch.testing.assert_close(lse, want, rtol=0, atol=2e-4)


def test_flash_attention_cuda_core_refuses_unaligned_rows(cuda):
    """The CUDA-core kernel copies 16 bytes at a time too: an fp32 view
    whose rows do not start on 16-byte boundaries is refused before any
    launch, and nothing falls back."""
    wide = _rand(cuda, 2, 64, 4, 66, dtype=torch.float32)
    q = wide[..., :64]                    # head stride 264 bytes
    ok = _rand(cuda, 2, 64, 4, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, ok, ok)
    flat = _rand(cuda, 2 * 64 * 4 * 64 + 1, dtype=torch.float32)
    shifted = flat[1:].view(2, 64, 4, 64)  # base 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(ok, shifted, ok)


def test_flash_attention_wgmma_refuses_unaligned_rows(cuda):
    """The wgmma kernel copies 16 bytes a lane: a view whose rows do not
    start on 16-byte boundaries is refused before any launch."""
    wide = _rand(cuda, 2, 64, 4, 68, dtype=torch.bfloat16)
    q = wide[..., :64]                    # head stride 136 bytes
    ok = _rand(cuda, 2, 64, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, ok, ok)
    flat = _rand(cuda, 2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 64, 4, 64)  # base 2 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(ok, shifted, ok)


@pytest.mark.parametrize("rows,d", [(4096, 960), (4071, 960), (7, 64),
                                    (33, 8192), (1, 100), (16, 1001),
                                    (9, 2048), (8, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_rows", [None, 3])
def test_fused_add_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype,
                                                block_rows):
    """Each width runs the instantiation ``fused.plan`` picks: one warp a
    row or several, 16-byte accesses or (1001; 100 in bf16) one element an
    access.  y is the plain version's bit for bit (one fp32 add, one
    rounding); h is within the kernel tolerance."""
    x = _rand(cuda, rows, d, dtype=dtype)
    r = _rand(cuda, rows, d, dtype=dtype)
    sc = _rand(cuda, d, dtype=dtype)
    ops.reset_launches()
    h, y = ops.fused_add_rmsnorm(x, r, sc, block_rows=block_rows)
    wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_add_rmsnorm"] == 1
    assert fused_mod.LAST_PLAN == fused_mod.plan(x, r, sc)
    assert torch.equal(y, wy)
    torch.testing.assert_close(h.float(), wh.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("which", ["x", "res", "scale"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_add_rmsnorm_kernel_takes_unaligned_views(cuda, which, dtype):
    """A view of x, res or scale whose storage starts one element (2 bytes
    in bf16) off a 16-byte boundary runs the scalar instantiation."""
    shapes = {"x": (300, 960), "res": (300, 960), "scale": (960,)}
    t = {}
    for name, shape in shapes.items():
        k = 1 if name == which else 0
        flat = _rand(cuda, int(torch.Size(shape).numel()) + k, dtype=dtype)
        t[name] = flat[k:].view(shape)
    h, y = ops.fused_add_rmsnorm(t["x"], t["res"], t["scale"])
    wh, wy = fused_mod.fused_add_rmsnorm_plain(t["x"], t["res"], t["scale"])
    torch.cuda.synchronize()
    assert fused_mod.LAST_PLAN == fused_mod.plan(t["x"], t["res"], t["scale"])
    assert not fused_mod.LAST_PLAN.vector
    assert torch.equal(y, wy)
    _close(h, wh, TOL[dtype])


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
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "flash_attention": cfg.n_layers,
                            "fused_add_rmsnorm": cfg.n_layers}
    want = tm.forward(cfg, params, {"tokens": toks}, attn_impl="naive")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_reduced_model_runs_the_kernel_at_head_dim_16(cuda):
    """The reduced configs (head_dim 16) take the attention kernel under
    ``attn_impl="auto"`` on the card and agree with the plain path."""
    cfg = get_config("smollm_360m").reduced()
    assert cfg.hd == 16 and cfg.attn_impl == "auto"
    params = tm.init(cfg, 0)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device="cuda",
                         generator=cuda)
    ops.reset_launches()
    got = tm.forward(cfg, params, {"tokens": toks})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    want = tm.forward(cfg, params, {"tokens": toks}, attn_impl="naive")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# --- decode attention ------------------------------------------------------------

def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kh,d", [
    (8, 549, 15, 5, 64),                # the serve phase's decode shape
    (2, 300, 4, 2, 128),
    (3, 130, 4, 2, 16),
    (2, 200, 15, 1, 64),                # MQA: a group of 15 spans two blocks
    (1, 549, 120, 120, 64),             # calibration: one KV head a head
    (1, 4096, 120, 120, 64),            # calibration's longest cache
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frac", [0.0, 0.002, 0.5, 1.0, 1.5])
def test_flash_decode_kernel_matches_plain(cuda, b, s, h, kh, d, dtype, frac):
    q = _rand(cuda, b, 1, h, d, dtype=dtype)
    k = _rand(cuda, b, s, kh, d, dtype=dtype)
    v = _rand(cuda, b, s, kh, d, dtype=dtype)
    n = max(int(frac * s), 1) if frac else 0
    ops.reset_launches()
    got = ops.flash_attention_decode(q, k, v, cache_len=n)
    want = fa.flash_attention_decode_plain(q, k, v, cache_len=n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_decode"] == 1
    _close(got, want, TOL[dtype])
    if n == 0:
        assert not got.float().abs().any()    # the reference skips every tile


def test_flash_decode_reads_a_device_length_and_strided_caches(cuda):
    """``cache_len`` as a CUDA tensor (read by the kernel, no host sync),
    and K/V as views of one wider cache buffer."""
    kv = _rand(cuda, 4, 600, 2 * 5, 64, dtype=torch.bfloat16)
    k, v = kv[:, :549, :5], kv[:, :549, 5:]
    q = _rand(cuda, 4, 1, 15, 64, dtype=torch.bfloat16)
    for n in (0, 1, 300, 549):
        got = ops.flash_attention_decode(
            q, k, v, cache_len=torch.tensor(n, device="cuda"))
        want = fa.flash_attention_decode_plain(q, k.contiguous(),
                                               v.contiguous(), cache_len=n)
        _close(got, want, 2e-2)


@pytest.mark.parametrize("b,s,h,kh,d", [
    (8, 549, 15, 5, 64),
    (1, 4096, 120, 120, 64),
    (2, 300, 4, 2, 128),
    (2, 130, 15, 1, 16),                # MQA, fp32 D 16: 4 lanes a key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("forced", ["one", "max"])
def test_flash_decode_forced_splits(cuda, b, s, h, kh, d, dtype, forced):
    """One split (the output written by the split kernel, no merge) and one
    tile a split, with a device length that leaves the last splits empty;
    the plain version repeats the same split."""
    q = _rand(cuda, b, 1, h, d, dtype=dtype)
    k = _rand(cuda, b, s, kh, d, dtype=dtype)
    v = _rand(cuda, b, s, kh, d, dtype=dtype)
    ns = 1 if forced == "one" else -(-s // fa.BLOCK_K)
    for n in (0, 1, 65, s // 2 + 3, s):
        ops.reset_launches()
        got = ops.flash_attention_decode(
            q, k, v, cache_len=torch.tensor(n, device="cuda"), n_splits=ns)
        want = fa.flash_attention_decode_plain(q, k, v, cache_len=n,
                                               n_splits=ns)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention_decode"] == 1
        _close(got, want, TOL[dtype])
        if n == 0:
            assert not got.float().abs().any()


def test_flash_decode_refuses_unaligned_caches(cuda):
    """The kernel reads 16 bytes a lane: a K view off a 16-byte boundary,
    or with a stride that is not a 16-byte multiple, raises before any
    launch (there is no scalar path)."""
    q = _rand(cuda, 2, 1, 4, 64, dtype=torch.bfloat16)
    buf = _rand(cuda, 2, 100, 2, 65, dtype=torch.bfloat16)
    v = _rand(cuda, 2, 100, 2, 64, dtype=torch.bfloat16)
    ops.reset_launches()
    for k in (buf[..., 1:], buf[..., :64]):      # 2-byte offset; 130-byte rows
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention_decode(q, k, v, cache_len=50)
    assert ops.LAUNCHES["flash_attention_decode"] == 0


# --- RMSNorm, add, SSD --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4096, 960), (4071, 960), (7, 64),
                                   (33, 8192), (1, 100), (4, 100, 512),
                                   (8, 960), (16, 1000), (16, 1001),
                                   (9, 2048), (5, 4104)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    """Each width runs the instantiation ``rmsnorm.plan`` picks: one warp a
    row or several (bf16 past 1024, fp32 past 512); 16-byte loads or, where
    the width is not a multiple of the vector (1001; 100 in bf16), one
    element a load."""
    x = _rand(cuda, *shape, dtype=dtype)
    sc = _rand(cuda, shape[-1], dtype=dtype)
    ops.reset_launches()
    got = ops.rmsnorm(x, sc)
    want = rn.rmsnorm_plain(x, sc)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == 1 and got.shape == x.shape
    assert rn.LAST_PLAN == rn.plan(x, sc)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_rows", [None, 1, 3])
def test_rmsnorm_kernel_takes_unaligned_views(cuda, dtype, block_rows):
    """A view whose storage starts off a 16-byte boundary runs the scalar
    instantiation; at any rows a block."""
    flat = _rand(cuda, 300 * 960 + 1, dtype=dtype)
    x = flat[1:].view(300, 960)
    sc = _rand(cuda, 960, dtype=dtype)
    got = ops.rmsnorm(x, sc, block_rows=block_rows)
    torch.cuda.synchronize()
    assert rn.LAST_PLAN == rn.plan(x, sc) and not rn.LAST_PLAN.vector
    _close(got, rn.rmsnorm_plain(x, sc), TOL[dtype])


@pytest.mark.parametrize("shape", [(4096, 960), (4096, 512), (1001,),
                                   (3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_kernel_matches_plain(cuda, shape, dtype):
    x = _rand(cuda, *shape, dtype=dtype)
    r = _rand(cuda, *shape, dtype=dtype)
    ops.reset_launches()
    got = ops.add(x, r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["add"] == 1
    assert torch.equal(got, add_mod.add_plain(x, r))   # one rounding each


def test_add_kernel_takes_unaligned_views(cuda):
    """A view that starts off a 16-byte boundary takes the scalar loop."""
    x = _rand(cuda, 4097, dtype=torch.bfloat16)
    r = _rand(cuda, 4097, dtype=torch.bfloat16)
    assert torch.equal(ops.add(x[1:], r[1:]), add_mod.add_plain(x[1:], r[1:]))


def _ssd_inputs(gen, b, s, h, p, n, dtype):
    x = _rand(gen, b, s, h, p, dtype=dtype)
    dt = 0.001 + 0.099 * torch.rand(b, s, h, generator=gen, device="cuda")
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device="cuda"))
    bb = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    cc = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 16, 32),
    (2, 256, 3, 64, 64, 64),
    (1, 256, 4, 64, 128, 128),
    (1, 2048, 24, 64, 128, 128),        # mamba2-130m at batch 1
    (1, 200, 2, 40, 16, 64),            # ragged S, P not a multiple of 16
    (2, 200, 3, 64, 128, 128),          # ragged S against the default chunk
    (4, 2048, 24, 64, 128, 128),        # calibration's largest point
    (1, 200, 2, 40, 16, 77),            # chunk 77: zero-filled to 80 rows
    (2, 256, 3, 64, 64, 77),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    args = _ssd_inputs(cuda, b, s, h, p, n, dtype)
    ops.reset_launches()
    y, st = ops.ssd_scan(*args, chunk=chunk)
    wy, wst = ssd_mod.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 1
    assert y.dtype == dtype and st.dtype == torch.float32
    bf16 = dtype == torch.bfloat16
    _close(y, wy, 4e-2 if bf16 else 1e-4)
    _close(st, wst, 1e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 16, 32),
    (2, 256, 3, 64, 64, 64),
    (1, 256, 4, 64, 128, 128),
    (1, 200, 2, 40, 16, 64),
    (2, 200, 3, 64, 128, 128),
    (1, 200, 2, 40, 16, 77),
    (2, 256, 3, 64, 64, 77),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_passes_match_their_plain_versions(cuda, b, s, h, p, n, chunk,
                                               dtype):
    """Each of the four passes alone, on the card, against its plain
    version fed the same inputs (the kernel's own outputs of the passes
    before it)."""
    x, dt, a, bb, cc = _ssd_inputs(cuda, b, s, h, p, n, dtype)
    bufs = ssd_mod.ssd_buffers(x, bb, chunk=chunk)
    ops.reset_launches()
    run = lambda which: ssd_mod.ssd_run_cuda(x, dt, a, bb, cc, bufs,
                                            chunk=chunk, which=which)
    run("cb")
    want = ssd_mod.ssd_cb_plain(bb, cc, chunk=chunk)
    low = torch.ones_like(want[0, 0], dtype=torch.bool).tril()
    _close(bufs["cb"][..., low], want[..., low], 1e-5 if
           dtype == torch.float32 else 1e-4)
    run("chunk_state")
    cum, local = ssd_mod.ssd_chunk_state_plain(x, dt, a, bb, chunk=chunk)
    _close(bufs["cum"], cum, 1e-5)
    _close(bufs["states"], local, 1e-4)
    local = bufs["states"].clone()
    run("state_pass")
    entering, final = ssd_mod.ssd_state_pass_plain(local, bufs["cum"])
    _close(bufs["states"], entering, 1e-5)
    _close(bufs["state"], final, 1e-5)
    run("chunk_scan")
    y = ssd_mod.ssd_chunk_scan_plain(x, dt, cc, bufs["cb"].tril(),
                                     bufs["cum"], bufs["states"], chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == 0      # direct launches count none
    _close(bufs["y"], y, 4e-2 if dtype == torch.bfloat16 else 1e-4)


# --- backward kernels and the train step -------------------------------------------

BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # times max |plain|


def _close_max(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol * top, (
        f"{what}: max |kernel - plain| {err:.3e} > {tol} * {top:.3e}")


def _attn_bwd_inputs(gen, b, sq, sk, h, kh, d, causal, dtype):
    q = _rand(gen, b, sq, h, d, dtype=dtype)
    k = _rand(gen, b, sk, kh, d, dtype=dtype)
    v = _rand(gen, b, sk, kh, d, dtype=dtype)
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    return q, k, v, _rand(gen, b, sq, h, d, dtype=dtype), lse


@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal", [
    (4, 1024, 1024, 15, 5, 64, True),   # the train path's shape
    (2, 1000, 1000, 4, 2, 64, False),   # S not a multiple of the tile
    (2, 77, 77, 4, 2, 16, True),        # the reduced configs' head dim
    (1, 200, 200, 6, 2, 128, True),
    (2, 130, 70, 4, 2, 48, False),      # unequal lengths
    (1, 70, 130, 4, 4, 32, True),       # causal, sk > sq
    (1, 128, 128, 15, 5, 64, True),     # the plan phase's fp32 fit shapes
    (4, 128, 128, 15, 5, 64, True),
])
@pytest.mark.parametrize("dtype,impl", [
    (torch.float32, None),                          # the CUDA-core kernels
    (torch.bfloat16, None),                         # the tensor-core kernels
    (torch.bfloat16, "cuda_core")])                 # CUDA-core, pinned
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, sq, sk, h, kh, d,
                                                  causal, dtype, impl):
    """The two backward kernels against the plain backward (with the same
    ``impl``, so the same roundings) on the same q, k, v, LSE (the kernel
    forward's) and dO; the wrapper counts the launch."""
    args = _attn_bwd_inputs(cuda, b, sq, sk, h, kh, d, causal, dtype)
    ops.reset_launches()
    got = (ops.flash_attention_bwd(*args, causal=causal) if impl is None
           else fa.flash_attention_bwd_cuda(*args, causal=causal, impl=impl))
    want = fa.flash_attention_bwd_plain(*args, causal=causal, impl=impl)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == (impl is None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close_max(g, w, BWD_TOL[dtype], name)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 128),
                                             (64, 128)])
def test_flash_attention_bwd_wgmma_every_head_dim_and_block(cuda, d, block_q,
                                                            block_k):
    """Every instantiation of the tensor-core kernels (eight head dims, one
    or two warpgroups a block) against the plain version, causal GQA 6/2
    with S a multiple of neither tile."""
    args = _attn_bwd_inputs(cuda, 2, 200, 200, 6, 2, d, True, torch.bfloat16)
    got = fa.flash_attention_bwd_cuda(*args, block_q=block_q, block_k=block_k)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_max(g, w, BWD_TOL[torch.bfloat16], name)


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("block_q,block_k", [(32, 32), (64, 64), (32, 64),
                                             (64, 32)])
def test_flash_attention_bwd_cuda_core_every_head_dim_and_block(cuda, d,
                                                                block_q,
                                                                block_k):
    """Every instantiation of the CUDA-core kernels (eight head dims, 32 or
    64 rows a block; at D > 64 the dK/dV kernel's 4 rows a thread) in fp32
    against the plain version, causal GQA 6/2 with S a multiple of no
    tile, and twice bit for bit."""
    args = _attn_bwd_inputs(cuda, 2, 200, 200, 6, 2, d, True, torch.float32)
    got = fa.flash_attention_bwd_cuda(*args, block_q=block_q, block_k=block_k)
    again = fa.flash_attention_bwd_cuda(*args, block_q=block_q,
                                        block_k=block_k)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_max(g, w, BWD_TOL[torch.float32], name)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape,causal", [((4, 1024, 1024, 15, 5, 64), True),
                                          ((2, 1000, 1000, 15, 5, 64), False)])
def test_flash_attention_bwd_fp32_bit_for_bit(cuda, shape, causal):
    """The fp32 backward at the train shape and at S 1000 non-causal: two
    runs agree bit for bit at every pair of blocks (the GQA group's shares
    are added in head order, no float atomics), and each pair agrees with
    the plain version."""
    args = _attn_bwd_inputs(cuda, *shape, causal, torch.float32)
    want = fa.flash_attention_bwd_plain(*args, causal=causal)
    for bq in fa.BWD_BLOCK_CHOICES["cuda_core"]:
        for bk in fa.BWD_BLOCK_CHOICES["cuda_core"]:
            first = fa.flash_attention_bwd_cuda(*args, causal=causal,
                                                block_q=bq, block_k=bk)
            again = fa.flash_attention_bwd_cuda(*args, causal=causal,
                                                block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, again))
            for name, g, w in zip(("dq", "dk", "dv"), first, want):
                _close_max(g, w, BWD_TOL[torch.float32], f"{name} {bq}x{bk}")


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("dtype,impl", [(torch.float32, None),
                                        (torch.bfloat16, "cuda_core")])
def test_flash_attention_bwd_cuda_core_refuses_unaligned_rows(cuda, which,
                                                              dtype, impl):
    """An input off a 16-byte boundary: the CUDA-core kernels' 16-byte
    copies cannot take it, and the wrapper raises rather than fall back."""
    args = list(_attn_bwd_inputs(cuda, 1, 64, 64, 2, 2, 64, True, dtype))
    i = ("q", "k", "v", "do").index(which)
    flat = torch.empty(args[i].numel() + 1, dtype=dtype, device="cuda")
    args[i] = flat[1:].view(args[i].shape).copy_(args[i])
    assert args[i].data_ptr() % 16 != 0
    ops.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        if impl is None:
            ops.flash_attention_bwd(*args)
        else:
            fa.flash_attention_bwd_cuda(*args, impl=impl)
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


def test_flash_attention_bwd_tickets_rearm_and_graph(cuda):
    """The fp32 dK/dV kernel's ticket counters: zero after every launch
    (shapes and blocks back to back, GQA groups 3 and 2, and on a side
    stream, which gets counters of its own); grown outside a capture only;
    and the fp32 backward captured in a CUDA graph on a stream whose
    counters were made first replays equal to eager, bit for bit."""
    dev = torch.device("cuda")
    main = torch.cuda.current_stream()
    for shape, bk in (((2, 300, 300, 15, 5, 64), 64), ((1, 200, 200, 6, 3, 32),
                      32), ((2, 77, 77, 4, 2, 16), 64)):
        args = _attn_bwd_inputs(cuda, *shape, True, torch.float32)
        fa.flash_attention_bwd_cuda(*args, block_k=bk)
        torch.cuda.synchronize()
        assert not fa.bwd_ticket_counters(dev, main).any()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fa.flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    counters = fa.bwd_ticket_counters(dev, side)
    assert counters.data_ptr() != fa.bwd_ticket_counters(dev, main).data_ptr()
    assert not counters.any()
    # a graph on a stream with its counters made first
    cap = torch.cuda.Stream()
    fa.bwd_ticket_counters(dev, cap)
    args = _attn_bwd_inputs(cuda, 2, 300, 300, 15, 5, 64, True, torch.float32)
    eager = fa.flash_attention_bwd_cuda(*args)
    graph = torch.cuda.CUDAGraph()
    cap.wait_stream(main)
    with torch.cuda.graph(graph, stream=cap):
        out = fa.flash_attention_bwd_cuda(*args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
        assert not fa.bwd_ticket_counters(dev, cap).any()
    # growing, or making, counters inside a capture raises
    big = fa.bwd_ticket_counters(dev, cap).numel() + 1
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=cap):
            fa.bwd_ticket_counters(dev, cap, big)
    other = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=other):
            fa.bwd_ticket_counters(dev, other)


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_flash_attention_bwd_wgmma_refuses_unaligned_rows(cuda, which):
    """A bf16 input two bytes off a 16-byte boundary: the tensor-core
    kernels' 16-byte copies cannot take it, and the wrapper raises rather
    than fall back to the CUDA-core kernels or the plain version."""
    args = list(_attn_bwd_inputs(cuda, 1, 64, 64, 2, 2, 64, True,
                                 torch.bfloat16))
    i = ("q", "k", "v", "do").index(which)
    flat = torch.empty(args[i].numel() + 1, dtype=torch.bfloat16,
                       device="cuda")
    args[i] = flat[1:].view(args[i].shape).copy_(args[i])
    assert args[i].data_ptr() % 16 == 2
    ops.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention_bwd(*args)
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, None),
                                        (torch.bfloat16, "cuda_core"),
                                        (torch.float32, None)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_leaves_o_bit_for_bit(cuda, dtype, impl, causal):
    """Asking for the LSE changes no bit of O, in either forward kernel,
    and the LSE matches the plain version's (fp32, atol 2e-4 at |LSE| ~ 5:
    the wgmma kernel's exponentials are ex2.approx)."""
    q = _rand(cuda, 2, 509, 15, 64, dtype=dtype)
    k = _rand(cuda, 2, 509, 5, 64, dtype=dtype)
    v = _rand(cuda, 2, 509, 5, 64, dtype=dtype)
    o1 = fa.flash_attention_cuda(q, k, v, causal=causal, impl=impl)
    o2, lse = fa.flash_attention_cuda(q, k, v, causal=causal, impl=impl,
                                      return_lse=True)
    _, want = fa.flash_attention_plain(q, k, v, causal=causal, impl=impl,
                                       return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    assert lse.shape == (2, 15, 509) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=2e-4)


def _norm_bwd_inputs(gen, rows, d, dtype):
    x, r, dh, dy = (_rand(gen, rows, d, dtype=dtype) for _ in range(4))
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    return dh, dy, x, r, sc


def _norm_bwd_close(got, args):
    want = fused_mod.fused_add_rmsnorm_bwd_plain(*args)
    torch.cuda.synchronize()
    dtype = args[2].dtype
    assert got[0].dtype == dtype and got[1].dtype == dtype
    _close(got[0], want[0], TOL[dtype])
    _close_max(got[1], want[1], BWD_TOL[dtype], "dscale")


@pytest.mark.parametrize("rows,d", [(4096, 960), (16384, 960), (4071, 960),
                                    (7, 64), (33, 1001), (64, 8192),
                                    (1, 960), (7, 960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_add_rmsnorm_bwd_kernel_matches_plain(cuda, rows, d, dtype):
    """The one-launch kernel against the plain backward (1 and 7 rows: one
    block, fewer rows than a step)."""
    args = _norm_bwd_inputs(cuda, rows, d, dtype)
    ops.reset_launches()
    got = ops.fused_add_rmsnorm_bwd(*args)
    assert ops.LAUNCHES["fused_add_rmsnorm_bwd"] == 1
    _norm_bwd_close(got, args)


@pytest.mark.parametrize("setting", [
    dict(BWD_STAGES=1), dict(BWD_STAGES=2), dict(BWD_STAGES=4),
    dict(BWD_ROWS_PER_STEP=4), dict(BWD_ROWS_PER_STEP=16),
    dict(BWD_ROWS_PER_STEP=3), dict(BWD_BLOCKS_PER_SM=2),
    dict(BWD_BLOCKS_PER_SM=2, BWD_ROWS_PER_STEP=4)])
@pytest.mark.parametrize("rows,dtype", [(4071, torch.bfloat16),
                                        (1000, torch.float32)])
def test_fused_add_rmsnorm_bwd_every_setting(cuda, monkeypatch, setting,
                                             rows, dtype):
    """Each ablation setting of ``bwd_plan``'s module constants (stages,
    rows a step, blocks an SM) against the plain backward at d 960."""
    for k, v in setting.items():
        monkeypatch.setattr(fused_mod, k, v)
    args = _norm_bwd_inputs(cuda, rows, 960, dtype)
    got = fused_mod.fused_add_rmsnorm_bwd_cuda(*args)
    _norm_bwd_close(got, args)


def test_fused_add_rmsnorm_bwd_counters_rearm(cuda):
    """The ticket counters are zeroed once a (device, stream) and every
    launch leaves them zero: calls back to back at different shapes on one
    stream, then on a side stream, each right."""
    cases = [(4096, 960, torch.bfloat16), (7, 960, torch.bfloat16),
             (16384, 960, torch.bfloat16), (33, 1001, torch.bfloat16),
             (1000, 960, torch.float32), (64, 8192, torch.bfloat16),
             (1, 960, torch.bfloat16)]
    inputs = [_norm_bwd_inputs(cuda, *c) for c in cases]
    outs = [ops.fused_add_rmsnorm_bwd(*args) for args in inputs]
    for got, args in zip(outs, inputs):
        _norm_bwd_close(got, args)
    main = torch.cuda.current_stream()
    assert not fused_mod.ticket_counters(main.device, main).any()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        got = [ops.fused_add_rmsnorm_bwd(*args) for args in inputs[:2]]
    side.synchronize()
    for g, args in zip(got, inputs[:2]):
        _norm_bwd_close(g, args)
    assert not fused_mod.ticket_counters(side.device, side).any()


def test_fused_add_rmsnorm_bwd_is_one_kernel(cuda, tmp_path):
    """A ``torch.profiler`` trace of one call (after a warm call, which
    allocates the stream's counters) holds one kernel, the backward's
    (read from the Chrome trace, which keeps kernels launched outside
    PyTorch's operators)."""
    from torch.profiler import ProfilerActivity, profile
    args = _norm_bwd_inputs(cuda, 4096, 960, torch.bfloat16)
    ops.fused_add_rmsnorm_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.fused_add_rmsnorm_bwd(*args)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kernels = [e["name"] for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    assert len(kernels) == 1 and "fused_add_rmsnorm_bwd" in kernels[0], (
        kernels)


@pytest.mark.parametrize("which", ["x", "dh", "scale"])
def test_fused_add_rmsnorm_bwd_takes_unaligned_views(cuda, which):
    """An input 2 bytes off a 16-byte boundary takes the scalar plan."""
    def make(name, *shape):
        n = 1 if name == which else 0
        flat = _rand(cuda, int(torch.tensor(shape).prod()) + n,
                     dtype=torch.bfloat16)
        return flat[n:].view(*shape)
    t = {name: make(name, 300, 960) for name in ("x", "res", "dh", "dy")}
    t["scale"] = make("scale", 960)
    got = ops.fused_add_rmsnorm_bwd(t["dh"], t["dy"], t["x"], t["res"],
                                    t["scale"])
    want = fused_mod.fused_add_rmsnorm_bwd_plain(t["dh"], t["dy"], t["x"],
                                                 t["res"], t["scale"])
    _close(got[0], want[0], TOL[torch.bfloat16])
    _close_max(got[1], want[1], BWD_TOL[torch.bfloat16], "dscale")


def test_backward_kernels_agree_bit_for_bit_across_runs(cuda):
    """No atomics on data (the fused norm's counters only choose which
    block adds the partial rows): two runs of each backward on the same
    inputs agree (attention: the tensor-core kernels at two shapes, the
    CUDA-core ones on bf16 at the first)."""
    for shape, impls in (((2, 300, 300, 15, 5, 64), (None, "cuda_core")),
                         ((1, 1000, 1000, 4, 2, 128), (None,))):
        args = _attn_bwd_inputs(cuda, *shape, True, torch.bfloat16)
        for impl in impls:
            first = fa.flash_attention_bwd_cuda(*args, impl=impl)
            again = fa.flash_attention_bwd_cuda(*args, impl=impl)
            assert all(torch.equal(a, b) for a, b in zip(first, again))
    x, r, dh, dy = (_rand(cuda, 4096, 960, dtype=torch.bfloat16)
                    for _ in range(4))
    sc = _rand(cuda, 960, dtype=torch.bfloat16)
    first = ops.fused_add_rmsnorm_bwd(dh, dy, x, r, sc)
    again = ops.fused_add_rmsnorm_bwd(dh, dy, x, r, sc)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_train_step_kernel_path_matches_plain_path(cuda):
    """fp32, 2 layers, head_dim 64, full remat: gradients through the
    kernels (forward and backward) against the plain path's on the card
    (1e-4 of max |g| a leaf), then one ``make_train_step`` step each from
    the same weights: loss and grad_norm at rtol 1e-4."""
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, remat="full")
    plain = dataclasses.replace(cfg, attn_impl="naive")
    batch = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=96, global_batch=4, num_microbatches=2)).batch(0)
    params = tm.init(cfg, 0)
    ops.reset_launches()
    loss, grads = tts.loss_and_grads(cfg, params, batch)
    n = cfg.n_layers * 2
    assert ops.LAUNCHES["flash_attention"] == 2 * n   # forward, recompute
    assert ops.LAUNCHES["flash_attention_bwd"] == n
    assert ops.LAUNCHES["fused_add_rmsnorm_bwd"] == n
    want_loss, want = tts.loss_and_grads(plain, params, batch)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for (k, g), (_, w) in zip(topt.tree_leaves(grads),
                              topt.tree_leaves(want)):
        _close_max(g, w, 1e-4, k)
    metrics = []
    for c in (cfg, plain):
        p = tm.init(cfg, 0)
        step = tts.make_train_step(c, topt.OptimizerConfig(lr=1e-3))
        metrics.append(step(p, topt.init_state(p), batch)[2])
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(metrics[0][key], metrics[1][key],
                                   rtol=1e-4, atol=0)


# --- the graphed train step ------------------------------------------------------
#
# 2 layers at smollm-360M's widths, bf16, full remat.  Graphed against eager
# at chip_smoke.py's ``[train]`` bounds: loss and grad_norm at 2e-2 of
# their size, each param leaf at 0.1 of its max |p| (both run the same
# kernels in the same order, so they should agree bit for bit; the tests
# print whether they do).

def _graph_setup(lr=1e-3):
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m"), n_layers=2,
                              remat="full")
    ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=256, global_batch=4, num_microbatches=2))
    return cfg, ds, topt.OptimizerConfig(lr=lr, warmup_steps=2)


def _fresh(cfg, seed=0):
    from repro_torch.train import optimizer as topt
    params = tm.init(cfg, seed)
    return params, topt.init_state(params)


def test_graphed_train_step_matches_eager(cuda):
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    (ep, es), (gp, gs) = _fresh(cfg), _fresh(cfg)
    eager = tts.make_train_step(cfg, ocfg)
    graphed = tts.make_graphed_train_step(cfg, ocfg, gp, gs, ds.batch(0))
    identical = True
    for i in range(3):
        b = ds.batch(i)
        _, _, em = eager(ep, es, b)
        gp2, gs2, gm = graphed(gp, gs, b)
        assert gp2 is gp and gs2 is gs
        for key in ("loss", "grad_norm", "lr"):
            err = (gm[key] - em[key]).abs().item()
            assert err <= 2e-2 * em[key].abs().item(), (key, i, err)
            identical &= torch.equal(gm[key], em[key])
        for (k, g), (_, e) in zip(topt.tree_leaves(gp),
                                  topt.tree_leaves(ep)):
            err = (g.float() - e.float()).abs().max().item()
            assert err <= 0.1 * e.float().abs().max().item(), (k, i, err)
            identical &= torch.equal(g, e)
    assert int(gs["step"]) == int(es["step"]) == 3
    print(f"graphed vs eager, 3 steps: bit-identical {identical}")


def test_graphed_replay_reads_each_batch(cuda):
    """lr 0 keeps the params: a replay on another batch (here given as
    CUDA tensors) gives another loss, and the first batch again gives its
    loss again, bit for bit."""
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup(lr=0.0)
    params, state = _fresh(cfg)
    a = ds.batch(0)
    b = {k: torch.from_numpy(v).cuda() for k, v in ds.batch(1).items()}
    step = tts.make_graphed_train_step(cfg, ocfg, params, state, a)
    losses = [step(params, state, x)[2]["loss"] for x in (a, a, b, a)]
    assert step.graph is not None and step.calls == 4
    assert not torch.equal(losses[2], losses[1])
    assert torch.equal(losses[3], losses[1])


def test_graphed_train_step_counts_the_eager_launches(cuda):
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    params, state = _fresh(cfg)
    ops.reset_launches()
    tts.make_train_step(cfg, ocfg)(params, state, ds.batch(0))
    eager = dict(ops.LAUNCHES)
    assert eager["flash_attention_bwd"] == cfg.n_layers * 2
    params, state = _fresh(cfg)
    step = tts.make_graphed_train_step(cfg, ocfg, params, state,
                                       ds.batch(0))
    ops.reset_launches()
    for i in range(3):     # eager on the side stream, capture + replay, replay
        step(params, state, ds.batch(i))
        assert ops.LAUNCHES == {k: (i + 1) * n for k, n in eager.items()}
    assert step.capture_launches == eager


def test_graphed_train_step_makes_the_counters_before_capture(cuda):
    """The side stream's ticket counters (the fused norm's, and the fp32
    attention backward's) exist after the first (eager) call, the capture
    adds none, and they read zero after 3
    replays; the capture stream's counters cannot be made inside one."""
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    params, state = _fresh(cfg)
    step = tts.make_graphed_train_step(cfg, ocfg, params, state,
                                       ds.batch(0))
    dev = params["embed"].device
    key = (dev.index, step.stream.cuda_stream)
    assert key not in fused_mod._COUNTERS
    step(params, state, ds.batch(0))
    counters = fused_mod._COUNTERS[key]
    assert not fa._TICKETS[key][-1].any()   # the fp32 backward's, made too
    keys = set(fused_mod._COUNTERS)
    for i in range(3):
        step(params, state, ds.batch(i + 1))
    torch.cuda.synchronize()
    assert set(fused_mod._COUNTERS) == keys
    assert fused_mod.ticket_counters(dev, step.stream) is counters
    assert not counters.any()
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(graph, stream=side):
            fused_mod.ticket_counters(dev, side)


def test_graphed_train_step_refuses_other_tensors_and_shapes(cuda):
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    params, state = _fresh(cfg)
    b = ds.batch(0)
    step = tts.make_graphed_train_step(cfg, ocfg, params, state, b)
    step(params, state, b)
    other, other_state = _fresh(cfg)
    with pytest.raises(ValueError, match="params"):
        step(other, state, b)
    with pytest.raises(ValueError, match="optimizer state"):
        step(params, other_state, b)
    short = {k: v[:, :, :128] for k, v in b.items()}
    with pytest.raises(ValueError, match="captured for"):
        step(params, state, short)
    with pytest.raises(ValueError, match="captured for"):
        step(params, state, {k: v.astype("int64") for k, v in b.items()})
    step(params, state, b)         # the graph still captures and replays
    assert step.graph is not None and int(state["step"]) == 2


def test_device_body_makes_no_host_sync_on_the_card(cuda):
    """``train_step_on_device`` on device batches under
    ``set_sync_debug_mode("error")`` (after one warm step, so the kernels
    are built and loaded)."""
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    params, state = _fresh(cfg)
    tts.make_train_step(cfg, ocfg)(params, state, ds.batch(0))
    db, w = tts.device_inputs(cfg, params, ds.batch(1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, metrics = tts.train_step_on_device(cfg, ocfg, params, state,
                                                 db, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(metrics["loss"])


def test_graphed_train_step_raises_on_a_failed_capture(cuda, monkeypatch):
    """A body that reads a value on the host (``.item()``) runs eagerly
    in the first call and fails the capture in the second: the step
    raises with CUDA's message, counts no launch for the capture, and
    raises again on a later call rather than run the eager step."""
    from repro_torch.train import train_step as tts
    cfg, ds, ocfg = _graph_setup()
    params, state = _fresh(cfg)
    real = tts.train_step_on_device

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        out[2]["loss"].item()
        return out
    monkeypatch.setattr(tts, "train_step_on_device", syncing)
    step = tts.make_graphed_train_step(cfg, ocfg, params, state,
                                       ds.batch(0))
    step(params, state, ds.batch(0))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="capture failed") as err:
        step(params, state, ds.batch(1))
    assert "captur" in str(err.value.__cause__).lower()
    assert not any(ops.LAUNCHES.values())
    assert step.graph is None and state["step"] is step._step
    with pytest.raises(RuntimeError, match="failed earlier"):
        step(params, state, ds.batch(1))
    torch.cuda.synchronize()
    assert int(state["step"]) == 1


# --- the sharded programs as CUDA graphs (jit_train_step(graphed=)) -------------
# A mesh whose positions are all ``cuda:0``: the captured sharded step runs
# the eager step's kernels and collectives in the same order on the same
# inputs, so it must agree bit for bit.  ``-k graphed_mesh`` runs these.

def _graphed_mesh_setup(policy, shape, lr=1e-3):
    """``_mesh_setup``'s reduced smollm on ``shape`` (fp32, the kernels),
    two copies of the same sharded weights, fresh AdamW states, the
    optimizer config and a batch maker."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.sharding import param_specs
    cfg, mesh, single, _, _, topt = _mesh_setup(policy, shape)
    specs = param_specs(tm.decls(cfg), policy, mesh)
    copies = [pm.shard_tree(single, specs, mesh) for _ in range(2)]
    states = [topt.init_sharded_state(p) for p in copies]

    def batch(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (2, 4, 65), generator=gen)
        return {"tokens": toks[..., :-1].to(torch.int32),
                "labels": toks[..., 1:].to(torch.int32)}
    ocfg = topt.OptimizerConfig(lr=lr, warmup_steps=1)
    return cfg, mesh, copies, states, ocfg, batch


def _assert_blocks_equal(a, b, what):
    from repro_torch.dist import placement as pm
    for (k, x), (_, y) in zip(pm.tree_items(a), pm.tree_items(b),
                              strict=True):
        assert all(torch.equal(u, v) for u, v in zip(x.blocks, y.blocks,
                                                     strict=True)), (what, k)


@pytest.mark.parametrize("policy,shape", [("fsdp_tp", (2, 2)),
                                          ("tp", (1, 2))])
def test_graphed_mesh_step_matches_eager(cuda, policy, shape):
    """3 steps of ``jit_train_step`` graphed (None on one card) and eager
    from the same weights on the same batches: loss, grad_norm, lr and
    every block of params, ``m``, ``v`` and the step bit for bit; the
    params and state stay the objects they were."""
    from repro_torch.train import train_step as tts
    cfg, mesh, (ep, gp), (es, gs), ocfg, batch = _graphed_mesh_setup(
        policy, shape)
    eager = tts.jit_train_step(cfg, ocfg, mesh, 2, 4, graphed=False)
    graphed = tts.jit_train_step(cfg, ocfg, mesh, 2, 4)
    assert graphed.graphed and not eager.graphed
    bound = gs["step"]
    for i in range(3):
        _, _, em = eager(ep, es, batch(i))
        gp2, gs2, gm = graphed(gp, gs, batch(i))
        assert gp2 is gp and gs2 is gs and gs["step"] is bound
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(gm[key], em[key]), (key, i)
        _assert_blocks_equal(gp, ep, "params")
        for key in ("m", "v"):
            _assert_blocks_equal(gs[key], es[key], key)
        _assert_blocks_equal({"s": gs["step"]}, {"s": es["step"]}, "step")
    assert graphed.graph_step.calls == 3
    assert graphed.graph_step.graph is not None
    assert graphed.capture_seconds > 0
    assert all(int(b) == 3 for b in gs["step"].blocks)


def test_graphed_mesh_replay_reads_each_batch(cuda):
    """lr 0 keeps the params: a replay on another batch (given as a
    ``Sharded`` on the card) gives another loss, and the first batch again
    gives its loss again, bit for bit."""
    from repro_torch.train import train_step as tts
    cfg, mesh, (params, _), (state, _), ocfg, batch = _graphed_mesh_setup(
        "fsdp_tp", (2, 2), lr=0.0)
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4, graphed=True)
    a, b = batch(0), tts.shard_batch(cfg, batch(1), mesh)
    losses = [step(params, state, x)[2]["loss"] for x in (a, a, b, a)]
    assert step.graph_step.graph is not None
    assert not torch.equal(losses[2], losses[1])
    assert torch.equal(losses[3], losses[1])


def test_graphed_mesh_step_refuses_other_tensors_and_shapes(cuda):
    from repro_torch.train import train_step as tts
    cfg, mesh, (params, other), (state, other_state), ocfg, batch = \
        _graphed_mesh_setup("tp", (1, 2))
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4)
    b = batch(0)
    step(params, state, b)
    with pytest.raises(ValueError, match="params"):
        step(other, state, b)
    with pytest.raises(ValueError, match="optimizer state"):
        step(params, other_state, b)
    with pytest.raises(ValueError, match="captured for"):
        step(params, state, {k: v[:, :, :32] for k, v in b.items()})
    with pytest.raises(ValueError, match="captured for"):
        step(params, state, {k: v.long() for k, v in b.items()})
    with pytest.raises(ValueError, match="made for"):
        step(params, state, {k: v[:1] for k, v in b.items()})
    step(params, state, b)         # the graph still captures and replays
    assert step.graph_step.graph is not None
    assert all(int(x) == 2 for x in state["step"].blocks)


def test_graphed_mesh_step_replays_the_eager_launches_and_record(cuda):
    """Every call of the graphed step (eager, capture + replay, replay)
    adds to ``ops.LAUNCHES`` and to an active collective record what an
    eager step does, entry for entry; the capture records apart."""
    from repro_torch.dist import placement as pm
    from repro_torch.train import train_step as tts
    cfg, mesh, (ep, gp), (es, gs), ocfg, batch = _graphed_mesh_setup(
        "fsdp_tp", (2, 2))
    eager = tts.jit_train_step(cfg, ocfg, mesh, 2, 4, graphed=False)
    ops.reset_launches()
    with pm.record_collectives() as want:
        eager(ep, es, batch(0))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention_bwd"] == cfg.n_layers * 2 * mesh.size
    assert want.entries
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4)
    for i in range(3):
        ops.reset_launches()
        with pm.record_collectives() as got:
            step(gp, gs, batch(i))
        assert ops.LAUNCHES == launches, i
        assert got.entries == want.entries, i
    assert step.graph_step.capture_launches == launches
    assert step.graph_step.capture_collectives == want.entries


def test_graphed_mesh_step_raises_on_a_failed_capture(cuda, monkeypatch):
    """A body that reads a value on the host runs eagerly in the first call
    and fails the capture in the second: the step raises with CUDA's
    message, counts no launch for the capture, and raises again on a
    later call rather than run the eager step."""
    from repro_torch.train import train_step as tts
    cfg, mesh, (params, _), (state, _), ocfg, batch = _graphed_mesh_setup(
        "fsdp_tp", (2, 2))
    real = tts.sharded_train_step_on_device

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        out[2]["loss"].item()
        return out
    monkeypatch.setattr(tts, "sharded_train_step_on_device", syncing)
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4, graphed=True)
    bound = state["step"]
    step(params, state, batch(0))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="capture failed") as err:
        step(params, state, batch(1))
    assert "captur" in str(err.value.__cause__).lower()
    assert not any(ops.LAUNCHES.values())
    assert step.graph_step.graph is None and state["step"] is bound
    with pytest.raises(RuntimeError, match="failed earlier"):
        step(params, state, batch(1))
    torch.cuda.synchronize()
    assert all(int(x) == 1 for x in state["step"].blocks)


def test_graphed_mesh_stage_pipeline_matches_eager(cuda):
    """``even_stages(cfg, [2, 1])`` on ``[cuda:0] * 3`` (stage 0 a (1, 2)
    mesh) with ``graphed=True`` against ``graphed=False`` from the same
    weights, 3 steps: losses, every stage's params and AdamW state bit
    for bit; every stage graphed, one graph a (program, input shape)."""
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import placement as pm
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, remat="full", attn_impl="kernel",
                              tie_embeddings=False)
    ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=64, global_batch=4, num_microbatches=2))
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1)
    full = tm.init(cfg, 0, device="cuda")
    stages = pl.even_stages(cfg, [2, 1])
    pipes = [pl.MPMDPipeline(cfg, stages, ocfg, graphed=g,
                             devices=["cuda:0"] * 3) for g in (True, False)]
    for p in pipes:
        p.full_params_like(full)
    graphed, eager = pipes
    assert all(g is not None for g in graphed.graphs)
    assert eager.graphs == [None, None]
    for i in range(3):
        assert graphed.train_step(ds.batch(i)) == eager.train_step(
            ds.batch(i)), i
    for a, b in zip(graphed.params + graphed.opt_states,
                    eager.params + eager.opt_states):
        for (k, x), (_, y) in zip(pm.tree_items(a), pm.tree_items(b),
                                  strict=True):
            xs = x.blocks if isinstance(x, pm.Sharded) else [x]
            ys = y.blocks if isinstance(y, pm.Sharded) else [y]
            assert all(torch.equal(u, v) for u, v in zip(xs, ys)), k
    assert sorted(k[0] for k in graphed.graphs[0].graphs) == [
        "bwd", "fwd", "update"]


def test_graphed_mesh_elastic_trainer_reshard(cuda, tmp_path, monkeypatch):
    """An ``ElasticTrainer`` on ``[cuda:0] * 4`` on the graphed step:
    (1, 1) for 3 steps, then a kill-free (2, 2) for 3, then a rollback to
    the step-4 checkpoint on (2, 2) for 3: the whole state after the
    reshard equals the state before it bit for bit, each new step
    captures anew, each reconfiguration's ``capture_s`` is its own new
    step's capture (the rollback's, not the reshard's at the step it
    resumes at), and the losses and final state equal a trainer on the
    eager step (``jit_train_step(..., graphed=False)``) bit for bit."""
    import functools
    from repro_torch.dist import placement as pm
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    from repro_torch.train.elastic import ElasticTrainer, RuntimePlan
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, sharding="fsdp_tp",
                              attn_impl="kernel")
    dc = tdata.DataConfig(seq_len=64, global_batch=4)
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)

    def whole(t):
        return {k: pm.unshard(x, "cuda") for k, x in pm.tree_items(
            {"p": t.params, "o": t.opt_state})}

    def run(name):
        shapes = iter([(1, 1), (2, 2), (2, 2)])
        t = ElasticTrainer(cfg, ocfg, dc, str(tmp_path / name),
                           checkpoint_every=4, devices=["cuda:0"] * 4,
                           plan_fn=lambda n: RuntimePlan(n, *next(shapes)))
        t.build(1)
        t.train(3)
        before = whole(t)
        t.on_availability_change(4)
        after = whole(t)
        assert all(torch.equal(after[k], before[k]) for k in before)
        t.train(3)
        t.on_availability_change(4, failure=True)
        t.train(3)
        return t

    with monkeypatch.context() as mp:
        mp.setattr(tts, "jit_train_step", functools.partial(
            tts.jit_train_step, graphed=False))
        ref = run("eager")
    assert not ref.step_fn.graphed and ref.captures == []
    tr = run("graphed")
    assert tr.step_fn.graphed
    assert [r["step"] for r in tr.captures] == [1, 4, 5]
    assert [r["n_devices"] for r in tr.captures] == [1, 4, 4]
    assert [(r["kind"], r["step"], r["resumed_at"]) for r in tr.reconfigs] \
        == [("kill-free", 3, 3), ("rollback", 6, 4)]
    assert [r["capture_s"] for r in tr.reconfigs] == \
        [r["capture_s"] for r in tr.captures[1:]]
    assert all(r["capture_s"] is None for r in ref.reconfigs)
    assert [r["loss"] for r in tr.log] == [r["loss"] for r in ref.log]
    got, want = whole(tr), whole(ref)
    assert all(torch.equal(got[k], want[k]) for k in want)


# --- the served decode step as CUDA graphs ---------------------------------------
# Graphed and eager decode run the same kernels in the same order on the
# same inputs, so they must agree bit for bit: tokens, logits and caches.

def _serve_setup(seed=0):
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64)
    return cfg, tm.init(cfg, seed)


def _requests(cfg, seed, lens, max_new):
    import numpy as np
    from repro_torch.serve.serve_step import Request
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype("int32"), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def test_graphed_batched_server_matches_eager(cuda):
    """Mixed lengths: the halving rule compacts 4 rows to 2 and to 1, so
    three row counts each run once eagerly, then capture and replay."""
    from repro_torch.serve.serve_step import BatchedServer
    cfg, params = _serve_setup()
    lens, max_new = [5, 9, 7, 3, 8, 6], [12, 3, 3, 6, 2, 9]
    got = _requests(cfg, 1, lens, max_new)
    want = _requests(cfg, 1, lens, max_new)
    graphed = BatchedServer(cfg, params, max_len=32, batch_size=4)
    eager = BatchedServer(cfg, params, max_len=32, batch_size=4,
                          graphed=False)
    assert graphed.graphed and graphed.decode_graph is not None
    ptrs = {k: v.data_ptr() for k, v in graphed.state.items()}
    graphed.run(got)
    eager.run(want)
    assert [r.output for r in got] == [r.output for r in want]
    assert [len(r.output) for r in got] == max_new
    assert (graphed.decode_steps, graphed.decode_row_steps) \
        == (eager.decode_steps, eager.decode_row_steps)
    assert sorted(graphed.decode_graph.graphs) == [1, 2, 4]
    assert graphed.prefill_graph.graphs == {}     # each shape seen once
    assert {k: v.data_ptr() for k, v in graphed.state.items()} == ptrs


def test_graphed_continuous_server_matches_eager(cuda):
    """Preemption on page exhaustion and prompts in several buckets: the
    graphed server's tokens and ``ServerStats`` equal the eager one's."""
    from repro_torch.serve.scheduler import ContinuousBatchingServer
    cfg, params = _serve_setup(1)
    lens, max_new = [8, 3, 8, 13, 5, 8, 2], [12, 5, 12, 4, 9, 7, 3]
    kw = dict(max_slots=4, max_ctx=32, page_size=4, total_pages=14)
    got = _requests(cfg, 2, lens, max_new)
    want = _requests(cfg, 2, lens, max_new)
    gs = ContinuousBatchingServer(cfg, params, **kw)
    es = ContinuousBatchingServer(cfg, params, graphed=False, **kw)
    gs.run(got)
    es.run(want)
    assert [r.output for r in got] == [r.output for r in want]
    assert [len(r.output) for r in got] == max_new
    assert dataclasses.asdict(gs.stats) == dataclasses.asdict(es.stats)
    assert gs.stats.n_preempted >= 1 and gs.alloc.used_pages == 0
    assert set(gs.decode_graph.graphs) <= {1, 2, 4}
    assert set(gs.prefill_graph.graphs) <= {2, 4, 8, 16}


def _decode_pair(cfg, params, per_row):
    """Two equal static states, 4 rows prefilled to different lengths."""
    import numpy as np
    from repro_torch.serve import serve_step as tss
    states = [tss.decode_state(cfg, 4, 32, per_row=per_row, device="cuda")
              for _ in range(2)]
    g = torch.Generator(device="cuda").manual_seed(3)
    for key in ("k", "v"):
        states[0][key].normal_(generator=g)
        states[1][key].copy_(states[0][key])
    lens = torch.tensor([9, 4, 12, 7] if per_row else 9, device="cuda")
    cur = torch.from_numpy(np.arange(4)[:, None] * 7 + 1).cuda()
    for s in states:
        s["len"].copy_(lens)
        s["cur"].copy_(cur)
    return states


@pytest.mark.parametrize("per_row", [False, True])
def test_graphed_decode_step_matches_eager_bit_for_bit(cuda, per_row):
    """Five steps at 4 rows then 2: the first call at each row count runs
    eagerly on the step's stream, the second captures; logits, caches,
    lengths and tokens equal the eager body's after every step, and the
    replay writes into the static state (its data pointers unchanged)."""
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(2)
    gst, est = _decode_pair(cfg, params, per_row)
    step = tss.GraphedDecodeStep(cfg, params, gst)
    ptrs = {k: v.data_ptr() for k, v in gst.items()}
    with torch.inference_mode():
        for rows in (4, 4, 4, 2, 2, 2):
            got = step(params, gst, rows).clone()
            want = tss.decode_on_device(cfg, params, tss.rows_of(est, rows))
            assert torch.equal(got, want), rows
            for key in gst:
                assert torch.equal(gst[key], est[key]), (rows, key)
    assert {k: v.data_ptr() for k, v in gst.items()} == ptrs
    assert sorted(step.graphs) == [2, 4]
    assert gst["len"].tolist() == ([15, 10, 15, 10] if per_row else 15)


def test_graphed_decode_step_captures_once_per_row_count(cuda):
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(3)
    state, _ = _decode_pair(cfg, params, True)
    step = tss.GraphedDecodeStep(cfg, params, state)
    with torch.inference_mode():
        step(params, state, 4)
        assert step.graphs == {}                  # eager on its stream
        step(params, state, 4)
        first = step.graphs[4]
        step(params, state, 2)
        step(params, state, 2)
        assert set(step.graphs) == {2, 4} and step.graphs[4] is first
        ops.reset_launches()
        step(params, state, 4)
        assert step.graphs[4] is first and len(step.capture_seconds) == 2
    assert step.capture_launches[4] == {k: 0 for k in ops.LAUNCHES}
    assert not any(ops.LAUNCHES.values())   # decode runs no port kernel


def test_graphed_decode_step_refuses_other_tensors(cuda):
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(4)
    state, other = _decode_pair(cfg, params, True)
    step = tss.GraphedDecodeStep(cfg, params, state)
    with torch.inference_mode():
        step(params, state, 2)
        with pytest.raises(ValueError, match="params"):
            step(tm.init(cfg, 4), state, 2)
        with pytest.raises(ValueError, match="decode state"):
            step(params, other, 2)
        with pytest.raises(ValueError, match="decode state"):
            step(params, dict(state, len=state["len"].clone()), 2)
        with pytest.raises(ValueError, match="rows"):
            step(params, state, 5)
        step(params, state, 2)            # the graph still captures
    assert sorted(step.graphs) == [2]


def test_graphed_decode_step_raises_on_a_failed_capture(cuda, monkeypatch):
    """A body that reads a value on the host (``.item()``) runs eagerly
    in the first call and fails the capture in the second: the step raises
    with CUDA's message, naming the row count, and every later call raises
    rather than run the body eagerly, at any row count (the allocator is
    left recording into the graphs' pool)."""
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(5)
    state, _ = _decode_pair(cfg, params, False)
    real = tss.decode_on_device

    def syncing(cfg, params, view):
        out = real(cfg, params, view)
        if view["cur"].shape[0] == 2:
            out.sum().item()
        return out
    monkeypatch.setattr(tss, "decode_on_device", syncing)
    step = tss.GraphedDecodeStep(cfg, params, state)
    with torch.inference_mode():
        step(params, state, 2)
        with pytest.raises(RuntimeError, match="failed at 2 rows") as err:
            step(params, state, 2)
        assert "captur" in str(err.value.__cause__).lower()
        for rows in (2, 4):
            with pytest.raises(RuntimeError, match="failed earlier"):
                step(params, state, rows)
    assert step.graphs == {}


# --- the served prefill as CUDA graphs -------------------------------------------
# Graphed and eager prefill run the same kernels in the same order on the
# same inputs, so they agree bit for bit: logits, K/V, lengths and tokens.

def _prefill_pair(cfg, per_row):
    """Two equal static states of 4 rows whose caches hold other values."""
    from repro_torch.serve import serve_step as tss
    states = [tss.decode_state(cfg, 4, 32, per_row=per_row, device="cuda")
              for _ in range(2)]
    g = torch.Generator(device="cuda").manual_seed(6)
    for key in ("k", "v"):
        states[0][key].normal_(generator=g)
        states[1][key].copy_(states[0][key])
    return states


def _prompts(cfg, seed, b, s):
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    toks[0, :s // 3] = 0                                  # left pad
    return toks


# (rows or row, bucket or length) of each call: a shape's first call runs
# eagerly, its second captures, later ones replay; a row index is a device
# value, so one bucket's graph writes every row
_PREFILL_CALLS = {False: [(4, 9), (4, 9), (4, 9), (2, 13), (2, 13), (4, 9),
                          (2, 13)],
                  True: [(1, 8), (3, 8), (0, 8), (2, 16), (2, 16), (3, 8),
                         (1, 16), (2, 4)]}


@pytest.mark.parametrize("by_row", [False, True])
def test_graphed_prefill_matches_eager_bit_for_bit(cuda, by_row):
    """Every call's logits and the whole state (K/V, lengths, tokens)
    equal the eager body's on a copy, and the replays write into the
    static state (its data pointers unchanged)."""
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(6)
    gst, est = _prefill_pair(cfg, by_row)
    step = tss.GraphedPrefill(cfg, params, gst, by_row=by_row)
    ptrs = {k: v.data_ptr() for k, v in gst.items()}
    with torch.inference_mode():
        for i, (a, s) in enumerate(_PREFILL_CALLS[by_row]):
            toks = _prompts(cfg, i, 1 if by_row else a, s)
            if by_row:
                got = step(params, gst, toks, row=a).clone()
                rows = torch.tensor([a], device="cuda")
            else:
                got = step(params, gst, toks).clone()
                rows = a
            want = tss.prefill_on_device(cfg, params, est,
                                         torch.from_numpy(toks).cuda(), rows)
            assert torch.equal(got, want), (i, a, s)
            for key in gst:
                assert torch.equal(gst[key], est[key]), (i, key)
    assert {k: v.data_ptr() for k, v in gst.items()} == ptrs
    assert sorted(step.graphs) == ([8, 16] if by_row else [(2, 13), (4, 9)])
    assert gst["len"].tolist() == ([8, 16, 4, 8] if by_row else 13)


def test_graphed_prefill_captures_once_per_shape(cuda):
    """One graph per bucket, made at the shape's second call; only the
    step's first call runs on its side stream; a replay adds the launches
    its capture recorded: the two prefill kernels once a layer each."""
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(7)
    state, _ = _prefill_pair(cfg, True)
    step = tss.GraphedPrefill(cfg, params, state, by_row=True)
    on_side, eager = [], step.eager
    step.eager = lambda body: on_side.append(1) or eager(body)
    toks8, toks4 = _prompts(cfg, 1, 1, 8), _prompts(cfg, 2, 1, 4)
    per = {k: cfg.n_layers if k in ("flash_attention", "fused_add_rmsnorm")
           else 0 for k in ops.LAUNCHES}
    with torch.inference_mode():
        ops.reset_launches()
        step(params, state, toks8, row=0)
        assert step.graphs == {} and dict(ops.LAUNCHES) == per
        step(params, state, toks8, row=1)
        first = step.graphs[8]
        step(params, state, toks4, row=2)
        step(params, state, toks4, row=2)
        assert set(step.graphs) == {4, 8} and step.graphs[8] is first
        ops.reset_launches()
        step(params, state, toks8, row=3)
        assert step.graphs[8] is first and len(step.capture_seconds) == 2
    assert on_side == [1]
    assert step.capture_launches[8] == per == step.capture_launches[4]
    assert dict(ops.LAUNCHES) == per


def test_graphed_prefill_refuses_other_tensors(cuda):
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(8)
    state, other = _prefill_pair(cfg, True)
    step = tss.GraphedPrefill(cfg, params, state, by_row=True)
    toks = _prompts(cfg, 3, 1, 8)
    with torch.inference_mode():
        step(params, state, toks, row=0)
        with pytest.raises(ValueError, match="params"):
            step(tm.init(cfg, 8), state, toks, row=0)
        with pytest.raises(ValueError, match="decode state"):
            step(params, other, toks, row=0)
        with pytest.raises(ValueError, match="decode state"):
            step(params, dict(state, cur=state["cur"].clone()), toks, row=0)
        for bad in (dict(row=4), dict(row=None), dict(row=-1)):
            with pytest.raises(ValueError, match="row"):
                step(params, state, toks, **bad)
        with pytest.raises(ValueError, match="2 prompts"):
            step(params, state, _prompts(cfg, 3, 2, 8), row=0)
        prefix = tss.GraphedPrefill(cfg, params, state)
        with pytest.raises(ValueError, match="5 prompts"):
            prefix(params, state, _prompts(cfg, 3, 5, 8))
        with pytest.raises(ValueError, match="row 1"):
            prefix(params, state, toks, row=1)
        step(params, state, toks, row=0)          # the graph still captures
    assert sorted(step.graphs) == [8]


def test_graphed_prefill_raises_on_a_failed_capture(cuda, monkeypatch):
    """A body that reads a value on the host fails the capture at its
    shape's second call: the step raises naming the shape, with CUDA's
    message as the cause, and every later call raises, at any shape,
    rather than run the prefill eagerly."""
    from repro_torch.serve import serve_step as tss
    cfg, params = _serve_setup(9)
    state, _ = _prefill_pair(cfg, False)
    real = tss.prefill_on_device

    def syncing(cfg, params, state, tokens, rows):
        out = real(cfg, params, state, tokens, rows)
        if tokens.shape[1] == 8:
            out.sum().item()
        return out
    monkeypatch.setattr(tss, "prefill_on_device", syncing)
    step = tss.GraphedPrefill(cfg, params, state)
    with torch.inference_mode():
        step(params, state, _prompts(cfg, 4, 2, 8))
        with pytest.raises(RuntimeError, match="failed at 2 x 8") as err:
            step(params, state, _prompts(cfg, 4, 2, 8))
        assert "captur" in str(err.value.__cause__).lower()
        for s in (8, 5):
            with pytest.raises(RuntimeError, match="failed earlier"):
                step(params, state, _prompts(cfg, 5, 2, s))
    assert step.graphs == {}


def test_graphed_batched_server_captures_a_prefill_per_shape(cuda):
    """The same two batches three times: the prefills run eagerly in the
    first run, are captured in the second and replayed in the third; every
    run's tokens and counters equal an eager server's."""
    from repro_torch.serve.serve_step import BatchedServer
    cfg, params = _serve_setup(10)
    lens, max_new = [5, 9, 7, 3, 8, 6], [4, 3, 6, 2, 5, 3]
    graphed = BatchedServer(cfg, params, max_len=32, batch_size=4)
    eager = BatchedServer(cfg, params, max_len=32, batch_size=4,
                          graphed=False)
    for run in range(3):
        got = graphed.run(_requests(cfg, 11, lens, max_new))
        want = eager.run(_requests(cfg, 11, lens, max_new))
        assert [r.output for r in got] == [r.output for r in want], run
        assert (graphed.decode_steps, graphed.decode_row_steps) \
            == (eager.decode_steps, eager.decode_row_steps)
        assert sorted(graphed.prefill_graph.graphs) \
            == ([] if run == 0 else [(2, 8), (4, 9)])
    assert eager.prefill_graph is None


def test_graphed_continuous_server_prefills_one_graph_per_bucket(cuda):
    """Two runs of the same requests (prompts in buckets 2, 4, 8 and 16,
    re-admissions after preemption): tokens and ``ServerStats`` equal the
    eager server's in each, and after the second run the prefill graphs
    are exactly the buckets the server used."""
    from repro_torch.serve.scheduler import ContinuousBatchingServer, \
        ServerStats, _next_pow2
    cfg, params = _serve_setup(12)
    lens, max_new = [8, 3, 8, 13, 5, 2, 7], [12, 5, 12, 4, 9, 3, 7]
    kw = dict(max_slots=4, max_ctx=32, page_size=4, total_pages=14)
    gs = ContinuousBatchingServer(cfg, params, **kw)
    es = ContinuousBatchingServer(cfg, params, graphed=False, **kw)
    for run in range(2):
        gs.stats, es.stats = ServerStats(), ServerStats()
        got = gs.run(_requests(cfg, 13, lens, max_new))
        want = es.run(_requests(cfg, 13, lens, max_new))
        assert [r.output for r in got] == [r.output for r in want], run
        assert dataclasses.asdict(gs.stats) == dataclasses.asdict(es.stats)
    assert gs.stats.n_preempted >= 1
    assert set(gs.prefill_graph.graphs) == {_next_pow2(n) for n in lens}
    assert torch.equal(gs.state["len"], es.state["len"])


# --- the block-time fit (measure_block, calibrate_cpu_host) ------------------------

def test_measure_block_graphs_match_eager_bit_for_bit(cuda):
    """measure_block's forward and gradient (bf16, mbs 2) as CUDA graphs:
    a replay equals the eager call bit for bit, and launches the attention
    and fused-norm kernels once (the gradient their backward kernels once
    too: one layer, no remat)."""
    from repro_torch import graphs
    from repro_torch.core.profiler import measured
    one = measured.one_layer(get_config("smollm_360m"), "bfloat16")
    params = tm.init(one, 0, device="cuda")
    fwd, grad = measured.block_programs(
        one, params, measured.block_batch(one, 2, 512, "cuda"))
    want_f, want_g = fwd(), grad()
    f_replay = measured.graphed_program(fwd, params)
    g_replay = measured.graphed_program(grad, params)
    ops.reset_launches()
    got_f = f_replay()
    torch.cuda.synchronize()
    fwd_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    got_g = g_replay()
    torch.cuda.synchronize()
    grad_launches = dict(ops.LAUNCHES)
    assert got_f.dtype == torch.float32 and torch.equal(got_f, want_f)
    assert len(got_g) == len(want_g) == len(graphs.tree_leaves(params))
    assert all(torch.equal(g, w) for g, w in zip(got_g, want_g))
    none = {k: 0 for k in ops.LAUNCHES}
    assert fwd_launches == none | dict(flash_attention=1,
                                       fused_add_rmsnorm=1)
    assert grad_launches == none | dict(
        flash_attention=1, fused_add_rmsnorm=1, flash_attention_bwd=1,
        fused_add_rmsnorm_bwd=1)


def test_calibrate_cpu_host_fits_the_h100_entry(cuda):
    """On an H100 the fit replaces the ``"H100"`` entry's rate (and nothing
    else of it) with the measured one, efficiency 1.0, below the datasheet
    peak; each measured row is positive.  A card without a catalog entry
    raises ``ValueError`` naming it."""
    from repro_torch.core.profiler import measured
    from repro_torch.core.profiler.hw_specs import get_accelerator
    from repro_torch.kernels import autotune as at
    cfg = get_config("smollm_360m")
    if at.default_chip() != "H100":
        with pytest.raises(ValueError, match=at.default_chip()):
            measured.calibrate_cpu_host(cfg)
        return
    rows = measured.measure_block(cfg, 128, (1, 2))
    assert [r[0] for r in rows] == [1, 2]
    assert all(t > 0 for r in rows for t in r[1:])
    spec = measured.calibrate_cpu_host(cfg)
    h100 = get_accelerator("H100")
    assert dataclasses.asdict(spec) == dataclasses.asdict(dataclasses.replace(
        h100, peak_flops=spec.peak_flops, efficiency=1.0))
    assert 0 < spec.peak_flops < h100.peak_flops


# --- the MPMD pipeline (dist/pipeline.py) and the memory truth ---------------------
#
# 2 layers at smollm-360M's widths, bf16, full remat, untied, two stages on
# the one card: graphed (one CUDA graph a stage, program and input shape)
# against eager from the same weights.

def _pipe_setup(graphed_too=True):
    from repro_torch.dist import pipeline as pl
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m"), n_layers=2,
                              remat="full", tie_embeddings=False)
    ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=256, global_batch=4, num_microbatches=2))
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
    full = tm.init(cfg, 0)

    def make(graphed):
        pipe = pl.MPMDPipeline(cfg, pl.even_stages(cfg, [1, 1]), ocfg,
                               devices=["cuda:0", "cuda:0"], graphed=graphed)
        pipe.full_params_like(full)
        return pipe

    return cfg, ds, make


def test_graphed_pipeline_matches_eager_bit_for_bit(cuda):
    """Two steps (the first captures each stage's forward and backward at
    its second microbatch, the second its update): losses and every
    stage's params equal bit for bit; each stage holds three graphs."""
    from repro_torch.train import optimizer as topt
    cfg, ds, make = _pipe_setup()
    g, e = make(None), make(False)
    assert e.graphs == [None, None] and all(x is not None for x in g.graphs)
    for i in range(2):
        b = ds.batch(i)
        assert g.train_step(b) == e.train_step(b), i
        for pg, pe in zip(g.params, e.params):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
                topt.tree_leaves(pg), topt.tree_leaves(pe))), i
    for st in g.graphs:
        assert sorted(k[0] for k in st.graphs) == ["bwd", "fwd", "update"]
    assert [int(o["step"]) for o in g.opt_states] == [2, 2]


def test_graphed_pipeline_counts_the_eager_launches(cuda):
    """A step launches the attention forward 3 x layers x microbatches
    times (forward, the backward's recompute, remat) and its backward
    layers x microbatches, no fused norm, graphed or eager; a replayed
    step adds what the captures recorded."""
    cfg, ds, make = _pipe_setup()
    e, g = make(False), make(None)
    b = ds.batch(0)
    ops.reset_launches()
    e.train_step(b)
    eager = dict(ops.LAUNCHES)
    none = {k: 0 for k in eager}
    assert eager == none | dict(flash_attention=3 * 2 * 2,
                                flash_attention_bwd=2 * 2)
    ops.reset_launches()
    for i in range(3):    # warm + capture + replay, then replays
        g.train_step(b)
        assert ops.LAUNCHES == {k: (i + 1) * n for k, n in eager.items()}
    recorded = dict(none)
    for st in g.graphs:
        for key, launches in st.capture_launches.items():
            calls = 1 if key[0] == "update" else 2    # microbatches
            for k, n in launches.items():
                recorded[k] += calls * n
    assert recorded == eager


def test_pipeline_keeps_its_stage_inputs_across_replays(cuda):
    """The stage inputs a forward keeps for the backward are copies: the
    next microbatch's replay of the same graphs leaves them as they were.
    ``_to_stage`` copies onto the device the tensor is on too."""
    cfg, ds, make = _pipe_setup()
    g = make(None)
    b = ds.batch(0)
    g.train_step(b)
    g.train_step(b)                  # every graph captured
    ctx0 = g._forward_micro(b["tokens"][0])
    kept = [t.clone() for t in ctx0["inputs"]]
    ctx1 = g._forward_micro(b["tokens"][1])
    assert all(torch.equal(a, k) for a, k in zip(ctx0["inputs"], kept))
    assert not torch.equal(ctx0["inputs"][1], ctx1["inputs"][1])
    x = torch.ones(3, device="cuda")
    y = g._to_stage(0, x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()


def test_program_peak_bytes_grows_with_mbs(cuda):
    """The allocator's peak over the graphed train step's capture and over
    a stage program's grows with the microbatch and lies above the
    params, AdamW state and gradient buffers it holds."""
    from repro_torch.core.profiler import measured
    from repro_torch.dist import pipeline as pl
    cfg, _, _ = _pipe_setup()
    from repro_torch.dist.sharding import iter_decls
    # bf16 params, fp32 AdamW m and v
    resident = sum(math.prod(d.shape) * (2 + 8)
                   for _, d in iter_decls(tm.decls(cfg)))
    train = [measured._train_peak(cfg, 256, mbs, 2, "cuda")
             for mbs in (1, 2, 4)]
    assert resident < train[0] < train[1] < train[2], (resident, train)
    for st in pl.even_stages(cfg, [1, 1]):
        stage = [measured._stage_peak(cfg, st, 256, mbs, "cuda")
                 for mbs in (1, 4)]
        assert 0 < stage[0] < stage[1], (st.index, stage)


# --- the mesh: the sharded train step on one card -----------------------------------

def _mesh_setup(policy, shape):
    """A reduced smollm (head_dim 64, fp32, full remat, the kernels) on a
    mesh of ``cuda:0`` repeated, and the same weights on one device."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.mesh import data_model_mesh
    from repro_torch.dist.sharding import param_specs
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, sharding=policy, remat="full",
                              attn_impl="kernel")
    n = shape[0] * shape[1]
    mesh = data_model_mesh(*shape, [torch.device("cuda", 0)] * n)
    single = tm.init(cfg, 0, device="cuda")
    sharded = pm.shard_tree(single, param_specs(tm.decls(cfg), policy, mesh),
                            mesh)
    gen = torch.Generator(device="cpu").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 4, 65), generator=gen)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return cfg, mesh, single, sharded, batch, topt


@pytest.mark.parametrize("policy,shape", [("fsdp_tp", (2, 2)),
                                          ("tp", (1, 4))])
def test_sharded_step_on_one_card_matches_single_device(cuda, policy, shape):
    """The sharded step through the kernels on a mesh of one card against
    the single-device step: loss rtol 1e-5, gradients 1e-4 of max |g|
    (fp32), every replica bit for bit equal after 2 steps; per step each
    position launches the attention forward and the fused norm 2 x layers
    x microbatches (remat) and each backward layers x microbatches."""
    from repro_torch.dist import placement as pm
    from repro_torch.train import train_step as tts
    cfg, mesh, single, sharded, batch, topt = _mesh_setup(policy, shape)
    wl, wg = tts.loss_and_grads(cfg, single, batch)
    ops.reset_launches()
    gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    torch.cuda.synchronize()
    per = cfg.n_layers * 2 * mesh.size
    assert ops.LAUNCHES == dict(
        {k: 0 for k in ops.LAUNCHES}, flash_attention=2 * per,
        fused_add_rmsnorm=2 * per, flash_attention_bwd=per,
        fused_add_rmsnorm_bwd=per)
    assert abs(gl.item() - wl.item()) <= 1e-5 * abs(wl.item())
    got = dict(topt.tree_leaves(pm.unshard_tree(gg, "cuda")))
    for k, w in topt.tree_leaves(wg):
        assert (got[k] - w).abs().max() <= 1e-4 * w.abs().max(), k
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1)
    step = tts.jit_train_step(cfg, ocfg, mesh, 2, 4)
    state = topt.init_sharded_state(sharded)
    for _ in range(2):
        sharded, state, m = step(sharded, state, batch)
    for tree in (sharded, state["m"], state["v"]):
        for _, x in pm.tree_items(tree):
            for group in mesh.groups(pm.replica_axes(x.spec, mesh)):
                assert all(torch.equal(x.blocks[p], x.blocks[group[0]])
                           for p in group)


def test_mesh_without_enough_cards_raises(cuda):
    from repro_torch.dist.mesh import data_model_mesh
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} devices"):
        data_model_mesh(n + 1, 1)
    assert data_model_mesh(1, 1).device_list == [torch.device("cuda", 0)]


@pytest.mark.parametrize("policy,shape", [("fsdp_tp", (2, 2)),
                                          ("tp", (1, 4))])
def test_dryrun_record_and_calls_match_the_card(cuda, policy, shape):
    """The dry run's fake trace of a sharded step (``launch/dryrun``) against
    the same step on a mesh of ``cuda:0`` repeated, through the kernels:
    the collective records equal entry for entry, the step's ``LAUNCHES``
    equal the trace's ``FAKE_CALLS``, and the record leaves the loss bit
    for bit."""
    from repro_torch.dist import placement as pm
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import train_step as tts
    cfg, mesh, _, sharded, batch, topt = _mesh_setup(policy, shape)
    cell = shapes_mod.build_cell(cfg, ShapeConfig("t", "train", 64, 8, 2),
                                 mesh)
    trace = dryrun.trace_cell(cell)
    step = tts.jit_train_step(cfg, topt.OptimizerConfig(), mesh, 2, 4)
    state = topt.init_sharded_state(sharded)
    loss_off, _ = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
    ops.reset_launches()
    with pm.record_collectives() as record:
        _, _, m = step(sharded, state, batch)
    torch.cuda.synchronize()
    assert record.entries == trace.record.entries
    assert ops.LAUNCHES == trace.kernel_calls
    assert torch.equal(m["loss"], loss_off)


@pytest.mark.parametrize("chunk", [0, 16])
def test_dryrun_replay_equals_the_full_trace_on_the_card(cuda, chunk):
    """The (2, 2) ``fsdp_tp`` cell traced in full and replayed (each loop
    one trip of its count, ``program_cost.replay``) is one program
    (``dryrun.trace_differences``), and the real step through the kernels
    records what the replayed trace records, entry for entry, and
    launches its ``FAKE_CALLS``; also with the chunked loss on the mesh
    (``logits_chunk`` 16)."""
    from repro_torch.dist import placement as pm
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import train_step as tts
    cfg, mesh, _, sharded, batch, topt = _mesh_setup("fsdp_tp", (2, 2))
    cfg = dataclasses.replace(cfg, logits_chunk=chunk)

    def cell():
        return shapes_mod.build_cell(cfg, ShapeConfig("t", "train", 64, 8, 2),
                                     mesh)
    full = dryrun.trace_cell(cell(), replay=False)
    trace = dryrun.trace_cell(cell())
    assert dryrun.trace_differences(full, trace) == []
    assert trace.trips["layers"] == cfg.n_layers
    assert trace.trips["microbatches"] == 2
    step = tts.jit_train_step(cfg, topt.OptimizerConfig(), mesh, 2, 4)
    ops.reset_launches()
    with pm.record_collectives() as record:
        step(sharded, topt.init_sharded_state(sharded), batch)
    torch.cuda.synchronize()
    assert record.entries == trace.record.entries
    assert ops.LAUNCHES == trace.kernel_calls


# --- the runtime: mesh stages, checkpoints, the elastic trainer ----------------------

def test_mesh_stage_pipeline_on_one_card(cuda):
    """``even_stages(cfg, [2, 1])`` on ``[cuda:0] * 3`` through the kernels
    (stage 0 a (1, 2) mesh): the first step's loss (rtol 1e-5) and every
    stage's gradients (1e-4 of max |g|, fp32) against the ``[1, 1]``
    pipeline on the same weights; per step each position launches the
    attention forward 3 x its layers x microbatches and its backward
    layers x microbatches, and no fused norm (the stages are unfused)."""
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist import placement as pm
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, remat="full", attn_impl="kernel",
                              tie_embeddings=False)
    ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=64, global_batch=4, num_microbatches=2))
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    full = tm.init(cfg, 0, device="cuda")
    pipes = {}
    for tps in ((2, 1), (1, 1)):
        stages = pl.even_stages(cfg, list(tps))
        pipes[tps] = pl.MPMDPipeline(
            cfg, stages, ocfg, graphed=None,
            devices=["cuda:0"] * sum(s.n_devices for s in stages))
        pipes[tps].full_params_like(full)
    mesh, one = pipes[(2, 1)], pipes[(1, 1)]
    # graphed=None graphs both stages: the mesh stage's positions share a card
    assert mesh.graphs[0] is not None and mesh.graphs[1] is not None
    b = ds.batch(0)
    ops.reset_launches()
    loss, grads = mesh.grad_step(b)
    torch.cuda.synchronize()
    want = {k: 0 for k in ops.LAUNCHES}
    for st in mesh.stages:
        n = st.n_layers * 2 * st.n_devices
        want["flash_attention"] += 3 * n
        want["flash_attention_bwd"] += n
    assert ops.LAUNCHES == want
    wl, wg = one.grad_step(b)
    assert abs(loss - wl) <= 1e-5 * abs(wl)
    for g, w in zip(grads, wg):
        got = dict(pm.tree_items(g))
        for k, t in topt.tree_leaves(w):
            x = pl._full(got[k]).to("cuda")
            assert (x - t).abs().max() <= 1e-4 * t.abs().max(), k
    mesh.apply_grads(grads)
    assert mesh.train_step(ds.batch(1)) < loss


def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """bf16 params and fp32 AdamW state on the card save (the snapshot a
    synchronous copy to the host) and restore onto the card bit for bit,
    also after an in-place step taken while the write was in flight."""
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(get_config("smollm_360m"), n_layers=2)
    params = tm.init(cfg, 3, device="cuda")
    state = topt.init_state(params)
    grads = topt.tree_unflatten((k, torch.randn_like(t, dtype=torch.float32))
                                for k, t in topt.tree_leaves(params))
    ocfg = topt.OptimizerConfig(lr=1e-2, warmup_steps=1)
    topt.apply_updates(params, grads, state, ocfg)
    tree = {"params": params, "opt": state}
    saved = {k: t.clone() for k, t in topt.tree_leaves(tree)}
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    topt.apply_updates(params, grads, state, ocfg)
    got, step = mgr.restore(tree)
    assert step == 1
    for k, t in topt.tree_leaves(got):
        assert t.device.type == "cuda" and t.dtype == saved[k].dtype, k
        assert torch.equal(t, saved[k]), k
    assert got["params"]["embed"].dtype == torch.bfloat16


def test_kill_free_reshard_on_one_card(cuda, tmp_path):
    """An ``ElasticTrainer`` on ``[cuda:0] * 4`` through the kernels:
    (1, 1) then a kill-free (2, 2): the unsharded state bit for bit, and
    the next step's loss within 1e-5 of a trainer that stayed on (1,
    1)."""
    from repro_torch.dist import placement as pm
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train.elastic import ElasticTrainer, RuntimePlan
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, sharding="fsdp_tp",
                              attn_impl="kernel")
    dc = tdata.DataConfig(seq_len=64, global_batch=4)
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
    shapes = iter([(1, 1), (2, 2)])
    tr = ElasticTrainer(cfg, ocfg, dc, str(tmp_path / "a"),
                        devices=["cuda:0"] * 4,
                        plan_fn=lambda n: RuntimePlan(n, *next(shapes)))
    stay = ElasticTrainer(cfg, ocfg, dc, str(tmp_path / "b"),
                          devices=["cuda:0"])
    for t in (tr, stay):
        t.build(1)
        t.train(2)

    def whole(t):
        return {k: pm.unshard(x, "cuda") for k, x in pm.tree_items(
            {"p": t.params, "o": t.opt_state})}

    before = whole(tr)
    tr.on_availability_change(4)
    assert dict(tr.mesh.shape) == {"data": 2, "model": 2}
    after = whole(tr)
    assert all(torch.equal(after[k], before[k]) for k in before)
    ops.reset_launches()
    tr.train(1)
    stay.train(1)
    assert ops.LAUNCHES["flash_attention_bwd"] > 0
    assert abs(tr.log[-1]["loss"] - stay.log[-1]["loss"]) <= \
        1e-5 * abs(stay.log[-1]["loss"])


def _controller_setup(workdir, devices, audit=None):
    """``manager.Controller`` over an ``ElasticTrainer`` (reduced smollm
    through the kernels, seq 64, global batch 4 in 2 microbatches) on
    ``devices``, its replanner pricing smollm-360M at seq 1024 on H100s:
    2 H100s, then 1 at t = 240 (a bulk preemption: rollback to the step-3
    checkpoint), 2 again at t = 300 (held through the 120 s hysteresis,
    then a kill-free reshard)."""
    from repro_torch.core.cluster import single_zone
    from repro_torch.core.planner.objectives import MAX_THROUGHPUT, Objective
    from repro_torch.core.profiler.analytic import TrainJob
    from repro_torch.manager import (AvailabilityMonitor, Controller,
                                     ControllerConfig, IncrementalReplanner,
                                     ListFeed, TransitionConfig,
                                     TransitionModel)
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train.elastic import ElasticTrainer
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              head_dim=64, attn_impl="kernel")
    tr = ElasticTrainer(cfg, topt.OptimizerConfig(lr=1e-3, warmup_steps=2),
                        tdata.DataConfig(seq_len=64, global_batch=4,
                                         num_microbatches=2),
                        str(workdir), checkpoint_every=3, devices=devices)
    h100 = lambda n: single_zone("H100", n)       # noqa: E731
    ctl = Controller(
        tr, AvailabilityMonitor(h100(2), [ListFeed([(240.0, h100(1)),
                                                    (300.0, h100(2))])]),
        IncrementalReplanner(TrainJob(cfg=get_config("smollm_360m"),
                                      seq_len=1024, global_batch=8),
                             Objective(MAX_THROUGHPUT)),
        transition=TransitionModel(TransitionConfig(hysteresis_s=120.0)),
        config=ControllerConfig(step_time_s=60.0, max_devices=2,
                                audit_path=audit))
    return tr, ctl


CONTROLLER_OUTCOMES = ["start", "rollback", "defer", "reshard"]
CONTROLLER_RECONFIGS = [("rollback", 1, 4, 3), ("kill-free", 2, 6, 6)]


def test_controller_drives_the_elastic_trainer_on_the_card(cuda, tmp_path):
    """The control loop on ``[cuda:0] * 2``: the decisions and the
    reconfigurations (kind, positions, step, resumed at), finite losses,
    the kernels launched on every step, a ``step_time`` a step on the
    controller's sim clock, and the audit file's records."""
    from repro_torch.telemetry import TelemetryBus, read_jsonl
    tr, ctl = _controller_setup(tmp_path / "ckpt", ["cuda:0"] * 2,
                                audit=str(tmp_path / "audit.jsonl"))
    bus = TelemetryBus()
    ctl.attach_telemetry(bus)
    ops.reset_launches()
    log = ctl.run(9)
    assert [d["action"] for d in ctl.decisions
            if not d.get("straggler")] == CONTROLLER_OUTCOMES
    assert [(r["kind"], r["n_devices"], r["step"], r["resumed_at"])
            for r in tr.reconfigs] == CONTROLLER_RECONFIGS
    assert all(math.isfinite(r["loss"]) for r in log) and len(log) == 9
    positions = sum(r["n_devices"] for r in log)
    assert ops.LAUNCHES["flash_attention_bwd"] == \
        tr.cfg.n_layers * 2 * positions
    assert ops.LAUNCHES["fused_add_rmsnorm_bwd"] == \
        tr.cfg.n_layers * 2 * positions
    assert [s.time_s for s in bus.series("step_time", ())] == \
        [60.0 * i for i in range(9)]
    recs = read_jsonl(str(tmp_path / "audit.jsonl"))
    assert [r["action"] for r in recs] == [d["action"]
                                           for d in ctl.decisions]


def test_graphed_pipeline_with_a_bus_matches_detached_bit_for_bit(cuda):
    """A bus attached to the graphed pipeline adds synchronizations and
    clock reads only: the same losses and params bit for bit as a
    detached one from the same weights, the same launches a step, the same
    graphs with the same captured launches; and the reference's sample
    counts."""
    from repro_torch.telemetry import TelemetryBus
    from repro_torch.train import optimizer as topt
    cfg, ds, make = _pipe_setup()
    off, on = make(None), make(None)
    bus = TelemetryBus()
    on.attach_telemetry(bus)
    for i in range(3):        # warm, capture, replay
        b = ds.batch(i)
        ops.reset_launches()
        lo = off.train_step(b)
        a = dict(ops.LAUNCHES)
        ops.reset_launches()
        ln = on.train_step(b)
        assert ln == lo and dict(ops.LAUNCHES) == a, i
    for pa, pb in zip(on.params, off.params):
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
            topt.tree_leaves(pa), topt.tree_leaves(pb)))
    assert [sorted(g.graphs) for g in on.graphs] == \
        [sorted(g.graphs) for g in off.graphs]
    assert [g.capture_launches for g in on.graphs] == \
        [g.capture_launches for g in off.graphs]
    for i in range(2):
        assert len(bus.values("fwd_time", (i, 0))) == 3 * 2
        assert len(bus.values("bwd_time", (i, 0))) == 3 * 2
    assert len(bus.values("step_time", ())) == 3
    assert all(v > 0 for v in bus.values("p2p_time", (0, 1, 0, 0)))


# --- the block autotuner and the MoE family --------------------------------------

def _moe_cfg(**kw):
    """dbrx's routing (16 experts, top-4) at a narrow width, bf16."""
    return dataclasses.replace(get_config("dbrx_132b"), n_layers=2,
                               d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=64, d_ff=512, vocab_size=512,
                               **kw)


@pytest.mark.parametrize("dispatch", ["global", "per_seq"])
def test_moe_ffn_graphed_equals_eager(cuda, dispatch):
    """The FFN's forward and backward captured in one CUDA graph replay
    bit for bit what the eager calls give (no atomics decide a value:
    ``models/moe.py``), capacity binding (cf 0.5)."""
    from repro_torch.models import moe as tmoe
    cfg = _moe_cfg(capacity_factor=0.5, moe_dispatch=dispatch)
    p = {k: v[0].detach().requires_grad_()
         for k, v in tm.init(cfg, 0)["layers"].items()
         if k in ("router", "we_gate", "we_up", "we_down")}
    x = _rand(cuda, 4, 128, cfg.d_model, dtype=torch.bfloat16)
    go = _rand(cuda, 4, 128, cfg.d_model, dtype=torch.bfloat16)
    names = sorted(p)

    def body():
        out = tmoe.moe_ffn(cfg, p, x)
        return (out,) + torch.autograd.grad(out, [p[k] for k in names], go)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = [t.clone() for t in body()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)
    assert torch.equal(want[0], tmoe.moe_ffn(cfg, p, x))


def test_tuning_under_a_capture_raises(cuda, tmp_path, monkeypatch):
    """A cache miss inside a capture raises (no timing in the capture); a
    cached winner is read there, and the captured call replays it."""
    from repro_torch.kernels import autotune as at
    monkeypatch.setenv("REPRO_KERNEL_CACHE_DIR", str(tmp_path))
    at._shared_cache.cache_clear()
    x = _rand(cuda, 512, 960, dtype=torch.bfloat16)
    sc = _rand(cuda, 960, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="capturing a graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            ops.rmsnorm(x, sc, block_rows="auto")
    torch.cuda.synchronize()
    want = ops.rmsnorm(x, sc, block_rows="auto")      # tunes, eagerly
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ops.rmsnorm(x, sc, block_rows="auto")    # a cache hit
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    at._shared_cache.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_blocks_match_the_fixed_tiles(cuda, dtype, tmp_path,
                                           monkeypatch):
    """``block="auto"`` on each tuned kernel equals its default tile's
    output within the kernel tolerances (the norms and the SSD chunks
    compute the same values at any tile: exactly, for the norms)."""
    from repro_torch.kernels import autotune as at
    monkeypatch.setenv("REPRO_KERNEL_CACHE_DIR", str(tmp_path))
    at._shared_cache.cache_clear()
    tol = TOL[dtype]
    q = _rand(cuda, 2, 300, 8, 64, dtype=dtype)
    k = _rand(cuda, 2, 300, 4, 64, dtype=dtype)
    torch.testing.assert_close(
        ops.flash_attention(q, k, k, block_q="auto", block_k="auto").float(),
        ops.flash_attention(q, k, k).float(), rtol=tol, atol=tol)
    x = _rand(cuda, 3000, 960, dtype=dtype)
    r = _rand(cuda, 3000, 960, dtype=dtype)
    sc = _rand(cuda, 960, dtype=dtype)
    assert torch.equal(ops.rmsnorm(x, sc, block_rows="auto"),
                       ops.rmsnorm(x, sc))
    for a, b in zip(ops.fused_add_rmsnorm(x, r, sc, block_rows="auto"),
                    ops.fused_add_rmsnorm(x, r, sc)):
        assert torch.equal(a, b)
    sx = _rand(cuda, 1, 512, 4, 32, dtype=dtype)
    dt = torch.rand(1, 512, 4, device="cuda", generator=cuda) * 0.1 + 1e-3
    a = -(torch.rand(4, device="cuda", generator=cuda) * 1.5 + 0.5)
    bb = _rand(cuda, 1, 512, 16, dtype=dtype)
    cc = _rand(cuda, 1, 512, 16, dtype=dtype)
    ya, sa = ops.ssd_scan(sx, dt, a, bb, cc, chunk="auto")
    yd, sd = ops.ssd_scan(sx, dt, a, bb, cc)
    ytol, stol = (4e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    torch.testing.assert_close(ya.float(), yd.float(), rtol=ytol, atol=ytol)
    torch.testing.assert_close(sa, sd, rtol=stol, atol=stol)
    assert len(json.loads((tmp_path / f"autotune-{at.default_chip()}.json")
                          .read_text())) == 4
    at._shared_cache.cache_clear()


def test_moe_servers_and_train_step_graphed_equal_eager(cuda):
    """Narrow dbrx and mixtral (a 64-token window, prompts past it):
    ``BatchedServer`` graphed and eager give the same tokens, and the
    graphed train step's losses equal the eager step's bit for bit."""
    from repro_torch.serve.serve_step import BatchedServer, Request
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    for cfg in (_moe_cfg(), _moe_cfg(window=64, n_experts=8, top_k=2)):
        params = tm.init(cfg, 0)
        gen = torch.Generator().manual_seed(1)
        outs = []
        for graphed in (None, False):
            reqs = [Request(rid=i, prompt=torch.randint(
                0, cfg.vocab_size, (n,), generator=gen).numpy(),
                max_new_tokens=8) for i, n in enumerate((20, 96, 130))]
            gen.manual_seed(1)
            BatchedServer(cfg, params, max_len=160, batch_size=2,
                          graphed=graphed).run(reqs)
            outs.append([r.output for r in reqs])
        assert outs[0] == outs[1], cfg.name
    cfg = _moe_cfg(remat="full")
    ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
        seq_len=128, global_batch=4, num_microbatches=2))
    ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
    ep = tm.init(cfg, 0)
    gp = tm.init(cfg, 0)
    es, gs = topt.init_state(ep), topt.init_state(gp)
    eager = tts.make_train_step(cfg, ocfg)
    graphed = tts.make_graphed_train_step(cfg, ocfg, gp, gs, ds.batch(0))
    for i in range(3):
        _, _, em = eager(ep, es, ds.batch(i))
        _, _, gm = graphed(gp, gs, ds.batch(i))
        assert torch.equal(gm["loss"], em["loss"]), i


# --- the state-space families (mamba2, the zamba2 hybrid) --------------------------

def _ssm_cfgs(dtype):
    """Reduced mamba2 and zamba2 (the hybrid at 2 and 4 layers: one and
    two applications of its shared block) in ``dtype``."""
    out = []
    for arch, layers in (("mamba2_130m", 2), ("zamba2_2_7b", 2),
                         ("zamba2_2_7b", 4)):
        out.append(dataclasses.replace(get_config(arch).reduced(),
                                       n_layers=layers, dtype=dtype,
                                       param_dtype=dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_servers_graphed_equal_eager(cuda, dtype):
    """``BatchedServer`` graphed and eager give the same tokens, and each
    prefill launches the SSD kernel once a layer (the hybrid's attention
    kernel once an application)."""
    from repro_torch.serve.serve_step import BatchedServer, Request
    for cfg in _ssm_cfgs(dtype):
        params = tm.init(cfg, 0)
        outs, counts = [], []
        for graphed in (None, False):
            gen = torch.Generator().manual_seed(2)
            reqs = [Request(rid=i, prompt=torch.randint(
                0, cfg.vocab_size, (n,), generator=gen).numpy(),
                max_new_tokens=m) for i, (n, m) in enumerate(
                    ((20, 8), (37, 3), (9, 6)))]
            ops.reset_launches()
            BatchedServer(cfg, params, max_len=64, batch_size=2,
                          graphed=graphed).run(reqs)
            outs.append([r.output for r in reqs])
            counts.append(dict(ops.LAUNCHES))
        assert outs[0] == outs[1], cfg.name
        groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        for c in counts:
            assert c["ssd_scan"] == 2 * cfg.n_layers, (cfg.name, c)
            assert c["flash_attention"] == 2 * groups, (cfg.name, c)


def test_ssd_routes_agree_on_the_card(cuda):
    """fp32 prefills through the SSD kernel and through ``ssd_chunked``:
    logits within 1e-3, final states within 1e-4 (mamba2-130m's SSD
    geometry at 2 layers and 512 tokens; the reduced hybrid at 4)."""
    from repro_torch.models import mamba2
    cfgs = [dataclasses.replace(get_config("mamba2_130m"), n_layers=2,
                                dtype="float32", param_dtype="float32"),
            _ssm_cfgs("float32")[2]]
    for cfg in cfgs:
        params = tm.init(cfg, 0)
        toks = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(3))
        mod = tm.get_module(cfg)
        with torch.no_grad():
            ops.reset_launches()
            lk, ck = mod.forward(cfg, params, {"tokens": toks},
                                 return_cache=True, ssd_impl="kernel")
            assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers
            lc, cc = mod.forward(cfg, params, {"tokens": toks},
                                 return_cache=True, ssd_impl="chunked")
            assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers
        assert (lk[:, -1] - lc[:, -1]).abs().max().item() <= 1e-3
        assert (ck["ssm"] - cc["ssm"]).abs().max().item() <= 1e-4
        assert mamba2.pick_ssd_impl(toks.device, prefill=True,
                                    grad=False) == "kernel"


@pytest.mark.parametrize("fn", ["ssd_scan", "rmsnorm", "add"])
def test_forward_only_wrappers_raise_under_autograd(cuda, fn):
    x = _rand(cuda, 2, 64, 3, 16, dtype=torch.float32)
    dt = 0.1 * torch.rand(2, 64, 3, generator=cuda, device="cuda")
    a = -0.5 - torch.rand(3, generator=cuda, device="cuda")
    b = _rand(cuda, 2, 64, 8, dtype=torch.float32)
    rows = _rand(cuda, 8, 64, dtype=torch.float32)
    sc = torch.ones(64, device="cuda")
    call = {"ssd_scan": lambda t: ops.ssd_scan(t, dt, a, b, b, chunk=32),
            "rmsnorm": lambda t: ops.rmsnorm(t, sc),
            "add": lambda t: ops.add(t, rows)}[fn]
    base = x if fn == "ssd_scan" else rows
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="has no backward"):
        call(base.clone().requires_grad_())
    assert ops.LAUNCHES[fn] == 0
    with torch.no_grad():
        call(base.clone().requires_grad_())
    assert ops.LAUNCHES[fn] == 1


def test_ssm_train_steps_graphed_equal_eager(cuda):
    """The graphed train step's losses equal the eager step's for both
    families (bf16); the train path takes the chunked SSD: no SSD kernel
    launch."""
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    for cfg in _ssm_cfgs("bfloat16")[::2]:
        cfg = dataclasses.replace(cfg, remat="full", attn_impl="auto")
        ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
            seq_len=64, global_batch=4, num_microbatches=2))
        ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
        ep, gp = tm.init(cfg, 0), tm.init(cfg, 0)
        es, gs = topt.init_state(ep), topt.init_state(gp)
        eager = tts.make_train_step(cfg, ocfg)
        graphed = tts.make_graphed_train_step(cfg, ocfg, gp, gs,
                                              ds.batch(0))
        ops.reset_launches()
        for i in range(3):
            _, _, em = eager(ep, es, ds.batch(i))
            _, _, gm = graphed(gp, gs, ds.batch(i))
            assert torch.equal(gm["loss"], em["loss"]), (cfg.name, i)
            assert torch.isfinite(gm["grad_norm"])
        assert ops.LAUNCHES["ssd_scan"] == 0


def test_ssm_mesh_forward_launches_the_ssd_kernel_on_every_position(cuda):
    """mamba2-130m at 2 layers, fp32, without a gradient on a (1, 4) ``tp``
    mesh of ``cuda:0``: every position launches ``ssd_scan`` on its 6 of
    the 24 heads once a layer (layers x 4 launches), and the logits are
    within 1e-3 of the one-device kernel route's."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist import spmd
    from repro_torch.dist.mesh import data_model_mesh
    from repro_torch.dist.sharding import P, param_specs
    cfg = dataclasses.replace(get_config("mamba2_130m"), n_layers=2,
                              dtype="float32", param_dtype="float32",
                              sharding="tp")
    params = tm.init(cfg, 0)
    mesh = data_model_mesh(1, 4, [torch.device("cuda", 0)] * 4)
    sharded = pm.shard_tree(params, param_specs(tm.decls(cfg), "tp", mesh),
                            mesh)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda",
                         generator=cuda)
    with torch.no_grad():
        ops.reset_launches()
        want = tm.forward(cfg, params, {"tokens": toks})
        assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers
        ops.reset_launches()
        blocks, lay = spmd.forward(cfg, sharded, {"tokens": toks}, mesh)
        assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers * mesh.size
    assert lay.ssm_heads
    spec = P(lay.batch or None, None, "model" if lay.vocab_logits else None)
    got = pm.unshard(pm.Sharded(tuple(want.shape), spec, mesh, blocks),
                     "cuda")
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("arch,policy,shape", [
    ("smollm_360m", "fsdp_tp", (2, 2)), ("smollm_360m", "tp", (1, 4)),
    ("mamba2_130m", "tp", (1, 4))])
def test_sharded_prefill_on_one_card_matches_the_dry_run(cuda, arch, policy,
                                                        shape):
    """A sharded prefill (``serve_step.make_prefill(cfg, mesh)``) at full
    width, 2 layers, fp32, on a mesh of ``cuda:0`` repeated, through the
    kernels: its ``LAUNCHES`` equal the dry run's ``FAKE_CALLS`` for the
    same cell (the attention and fused-norm kernels, or the SSD scan, once
    a layer a position), its collective record the fake one entry for
    entry, and its last-token logits and one decode step's are within 1e-3
    of the one-device ``make_prefill`` / ``make_decode``."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.mesh import data_model_mesh
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve import kv_cache, serve_step
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              param_dtype="float32", sharding=policy)
    mesh = data_model_mesh(*shape, [torch.device("cuda", 0)] * 4)
    params = tm.init(cfg, 0)
    sharded = pm.shard_tree(params, param_specs(tm.decls(cfg), policy, mesh),
                            mesh)
    b, s = 4, 256
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=cuda)
    trace = dryrun.trace_cell(shapes_mod.build_cell(
        cfg, ShapeConfig("t", "prefill", s, b), mesh))
    with torch.no_grad():
        want, c1 = serve_step.make_prefill(cfg)(params, {"tokens": toks})
        ops.reset_launches()
        with pm.record_collectives() as record:
            got, cm = serve_step.make_prefill(cfg, mesh)(sharded,
                                                         {"tokens": toks})
        torch.cuda.synchronize()
        assert ops.LAUNCHES == trace.kernel_calls
        kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
        assert ops.LAUNCHES[kernel] == cfg.n_layers * mesh.size
        assert record.entries == trace.record.entries
        assert (pm.unshard(got, "cuda") - want).abs().max().item() <= 1e-3
        c1 = kv_cache.grow_cache(c1, tm.init_cache(cfg, b, s + 8))
        cm = kv_cache.grow_cache(cm, tm.init_cache(cfg, b, s + 8, mesh=mesh))
        nxt = want.argmax(-1)[:, None]
        want, _ = serve_step.make_decode(cfg)(params, c1, nxt)
        got, _ = serve_step.make_decode(cfg, mesh)(sharded, cm, nxt)
        assert (pm.unshard(got, "cuda") - want).abs().max().item() <= 1e-3


# --- the stubbed-frontend families (whisper's encdec, internvl2's vlm) -------------

def _stub_cfgs(dtype):
    """Reduced whisper-tiny and internvl2-26b in ``dtype``, head dim 64."""
    return [dataclasses.replace(get_config(arch).reduced(), head_dim=64,
                                dtype=dtype, param_dtype=dtype)
            for arch in ("whisper_tiny", "internvl2_26b")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_kernel_path_matches_plain(cuda, dtype):
    """The reduced vlm's forward on the card: the kernel route (the
    attention kernel and the fused norm, once a layer each) against the
    plain path (naive attention, unfused norm) on the same weights,
    patches and tokens; logits 1e-4 (fp32) or 5e-2 (bf16)."""
    cfg = _stub_cfgs(dtype)[1]
    params = tm.init(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     device="cuda", generator=gen),
             "patches": torch.randn(2, cfg.n_patches, cfg.d_model,
                                    device="cuda", generator=gen)}
    with torch.no_grad():
        ops.reset_launches()
        got = tm.forward(cfg, params, batch)
        assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
        assert ops.LAUNCHES["fused_add_rmsnorm"] == cfg.n_layers
        want = tm.forward(cfg, params, batch, attn_impl="naive")
    assert got.shape == (2, cfg.n_patches + 40, cfg.vocab_size)
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stub_families_serve_graphed_equal_eager(cuda, dtype):
    """``BatchedServer`` graphed and eager give the same tokens (mixed
    lengths: compaction), and ``GraphedPrefill`` / ``GraphedDecodeStep``
    equal the eager bodies bit for bit on a copy of the state; whisper
    launches no kernel, the vlm's prefill its two once a layer."""
    from repro_torch.serve import serve_step as tss
    for cfg in _stub_cfgs(dtype):
        params = tm.init(cfg, 0)
        outs, counts = [], []
        for graphed in (None, False):
            gen = torch.Generator().manual_seed(2)
            reqs = [tss.Request(rid=i, prompt=torch.randint(
                0, cfg.vocab_size, (n,), generator=gen).numpy(),
                max_new_tokens=m) for i, (n, m) in enumerate(
                    ((20, 8), (37, 3), (9, 6)))]
            ops.reset_launches()
            tss.BatchedServer(cfg, params, max_len=64, batch_size=2,
                              graphed=graphed).run(reqs)
            outs.append([r.output for r in reqs])
            counts.append(dict(ops.LAUNCHES))
        assert outs[0] == outs[1], cfg.name
        per = cfg.n_layers if cfg.family == "vlm" else 0
        for c in counts:
            assert c["flash_attention"] == 2 * per, (cfg.name, c)
            assert c["fused_add_rmsnorm"] == 2 * per, (cfg.name, c)
            assert sum(c.values()) == 4 * per, (cfg.name, c)
        gst = tss.decode_state(cfg, 2, 48, per_row=False, device="cuda")
        est = {k: v.clone() for k, v in gst.items()}
        pre = tss.GraphedPrefill(cfg, params, gst)
        dec = tss.GraphedDecodeStep(cfg, params, gst)
        toks = torch.randint(0, cfg.vocab_size, (2, 13),
                             generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            for _ in range(3):
                got = pre(params, gst, toks.numpy()).clone()
                want = tss.prefill_on_device(cfg, params, est, toks.cuda(), 2)
                assert torch.equal(got, want), cfg.name
            for _ in range(4):
                got = dec(params, gst, 2).clone()
                want = tss.decode_on_device(cfg, params,
                                            tss.rows_of(est, 2))
                assert torch.equal(got, want), cfg.name
        assert (2, 13) in pre.graphs and 2 in dec.graphs
        for key in gst:
            assert torch.equal(gst[key], est[key]), (cfg.name, key)


def test_stub_families_train_steps_graphed_equal_eager(cuda):
    """``make_graphed_train_step`` binds ``frames`` or ``patches`` among its
    static inputs: its losses equal the eager step's bit for bit over 3
    batches (bf16, full remat); whisper launches no kernel, the vlm its
    forward and backward kernels."""
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    for cfg in _stub_cfgs("bfloat16"):
        cfg = dataclasses.replace(cfg, remat="full")
        ds = tdata.SyntheticDataset(cfg, tdata.DataConfig(
            seq_len=64, global_batch=4, num_microbatches=2))
        ocfg = topt.OptimizerConfig(lr=1e-3, warmup_steps=2)
        ep, gp = tm.init(cfg, 0), tm.init(cfg, 0)
        es, gs = topt.init_state(ep), topt.init_state(gp)
        eager = tts.make_train_step(cfg, ocfg)
        graphed = tts.make_graphed_train_step(cfg, ocfg, gp, gs,
                                              ds.batch(0))
        stub = "frames" if cfg.family == "encdec" else "patches"
        assert stub in graphed._static
        ops.reset_launches()
        for i in range(3):
            _, _, em = eager(ep, es, ds.batch(i))
            _, _, gm = graphed(gp, gs, ds.batch(i))
            assert torch.equal(gm["loss"], em["loss"]), (cfg.name, i)
            assert torch.isfinite(gm["grad_norm"])
        n = sum(ops.LAUNCHES.values())
        if cfg.family == "encdec":
            assert n == 0, ops.LAUNCHES
        else:
            assert ops.LAUNCHES["flash_attention_bwd"] > 0
            assert ops.LAUNCHES["fused_add_rmsnorm_bwd"] > 0


@pytest.mark.parametrize("policy,shape", [("fsdp_tp", (2, 2)),
                                          ("tp", (1, 4))])
def test_stub_families_on_a_mesh_of_one_card(cuda, policy, shape):
    """The reduced vlm and whisper (fp32, head dim 64) on a mesh of
    ``cuda:0`` repeated (``dist/spmd_encdec.py``, the patches in
    ``spmd.forward``): the sharded loss and gradients through the kernels
    against the one-device step on the plain path (naive attention,
    unfused norm), loss rtol 1e-5 and gradients 1e-4 of max |g|, the vlm
    launching the attention forward and the fused norm 2 x layers x
    microbatches a position (full remat) and each backward layers x
    microbatches, whisper nothing; then a sharded prefill, whose launches
    equal the dry run's ``FAKE_CALLS`` (the vlm's two kernels once a layer
    a position), and a decode step, logits within 1e-3 of one device's."""
    from repro_torch.dist import placement as pm
    from repro_torch.dist.mesh import data_model_mesh
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch import shapes as shapes_mod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve import kv_cache, serve_step
    from repro_torch.train import data as tdata
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    mesh = data_model_mesh(*shape, [torch.device("cuda", 0)] * 4)
    for cfg in _stub_cfgs("float32"):
        cfg = dataclasses.replace(cfg, sharding=policy, remat="full")
        plain = dataclasses.replace(cfg, attn_impl="naive")
        single = tm.init(cfg, 0)
        sharded = pm.shard_tree(single, param_specs(tm.decls(cfg), policy,
                                                    mesh), mesh)
        batch = tdata.SyntheticDataset(cfg, tdata.DataConfig(
            seq_len=64, global_batch=8, num_microbatches=2)).batch(0)
        wl, wg = tts.loss_and_grads(plain, single, batch)
        ops.reset_launches()
        gl, gg = tts.loss_and_grads(cfg, sharded, batch, mesh=mesh)
        torch.cuda.synchronize()
        per = cfg.n_layers * 2 * mesh.size if cfg.family == "vlm" else 0
        assert ops.LAUNCHES == dict(
            {k: 0 for k in ops.LAUNCHES}, flash_attention=2 * per,
            fused_add_rmsnorm=2 * per, flash_attention_bwd=per,
            fused_add_rmsnorm_bwd=per), cfg.name
        assert abs(gl.item() - wl.item()) <= 1e-5 * abs(wl.item())
        got = dict(topt.tree_leaves(pm.unshard_tree(gg, "cuda")))
        for k, w in topt.tree_leaves(wg):
            assert (got[k] - w).abs().max() <= 1e-4 * w.abs().max(), \
                (cfg.name, k)
        b, s = 4, 48
        infer = {k: torch.as_tensor(v[0], device="cuda")
                 for k, v in batch.items() if k != "labels"}
        infer["tokens"] = infer["tokens"][:, :s]
        trace = dryrun.trace_cell(shapes_mod.build_cell(
            cfg, ShapeConfig("t", "prefill", s + (cfg.n_patches if cfg.family
                                                  == "vlm" else 0), b),
            mesh))
        with torch.no_grad():
            want, c1 = serve_step.make_prefill(plain)(single, infer)
            ops.reset_launches()
            got, cm = serve_step.make_prefill(cfg, mesh)(sharded, infer)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == trace.kernel_calls, cfg.name
            assert ops.LAUNCHES["flash_attention"] == per // 2
            assert (pm.unshard(got, "cuda") - want).abs().max() <= 1e-3
            n = c1["len"] + 8
            c1 = kv_cache.grow_cache(c1, tm.init_cache(cfg, b, n))
            cm = kv_cache.grow_cache(cm, tm.init_cache(cfg, b, n, mesh=mesh))
            nxt = want.argmax(-1)[:, None]
            want, _ = serve_step.make_decode(cfg)(single, c1, nxt)
            got, _ = serve_step.make_decode(cfg, mesh)(sharded, cm, nxt)
            assert (pm.unshard(got, "cuda") - want).abs().max() <= 1e-3


def test_quickstart_reduced_graphed_equals_eager(cuda):
    """``repro_torch.examples.quickstart`` with ``--reduced`` on the card:
    the plan's 2 stages at tp [4, 2] on ``[cuda:0] * 8``, both graphed;
    the three losses falling and equal, bit for bit, to those of its
    ``execute`` run eagerly from the same weights."""
    from repro_torch.examples import quickstart
    from repro_torch.examples.common import positions
    out = quickstart.main(["--reduced"])
    ex = out["execute"]
    assert ex["tps"] == [4, 2] and ex["graphed_stages"] == [True, True]
    cfg = quickstart.execute_config(True)
    eager = quickstart.execute(
        cfg, ex["tps"], positions("cuda", quickstart.POSITIONS),
        quickstart.tokens(cfg, quickstart.REDUCED_BATCH), graphed=False)
    assert eager["graphed_stages"] == [False, False]
    assert ex["losses"] == eager["losses"]
    assert ex["losses"][-1] < ex["losses"][0]
