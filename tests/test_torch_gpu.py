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
    (torch.float32, 16), (torch.float32, 32),       # the CUDA-core kernel
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


def test_flash_attention_cuda_core_kernel_takes_bf16(cuda):
    """``impl="cuda_core"`` runs the fp32 CUDA-core kernel on bf16 inputs
    (keeping P in fp32), against the plain version of that arithmetic; a
    direct launch counts no wrapper launch."""
    q = _rand(cuda, 2, 509, 15, 64, dtype=torch.bfloat16)
    k = _rand(cuda, 2, 509, 5, 64, dtype=torch.bfloat16)
    v = _rand(cuda, 2, 509, 5, 64, dtype=torch.bfloat16)
    ops.reset_launches()
    got = fa.flash_attention_cuda(q, k, v, impl="cuda_core")
    want = fa.flash_attention_plain(q, k, v, impl="cuda_core")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 0
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(RuntimeError, match="block_q"):
        fa.flash_attention_cuda(q, k, v, impl="cuda_core", block_q=64)


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
    assert not fused_mod._counter(main.device, main).any()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        got = [ops.fused_add_rmsnorm_bwd(*args) for args in inputs[:2]]
    side.synchronize()
    for g, args in zip(got, inputs[:2]):
        _norm_bwd_close(g, args)
    assert not fused_mod._counter(side.device, side).any()


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
