"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test asks for a CUDA device through the ``cuda``
fixture and skips without one.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2, fp32 2e-5; SSD y 4e-2 / 1e-4 and state 1e-2 / 1e-4
(the reference's kernel tolerances, ``tests/test_kernels.py``).
"""
import dataclasses

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
