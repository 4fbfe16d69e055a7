"""The port's block autotuner (``repro_torch/kernels/autotune.py``) against
the reference's (``repro/kernels/autotune.py``), on the CPU.

The reference's own autotuner tests (``tests/test_kernels.py:200-249``)
run here on the port, then what the two packages share: the cache key
(for the same op, shape, dtype name, chip and grid), the cache file
(either package reads the other's), the grids (the port's built tiles
only), ``block="auto"`` and ``REPRO_KERNEL_AUTOTUNE`` through every
tuned wrapper on the plain versions (the tuned tile gives the default's
output: the plain versions compute the same function at every tile, to
the kernels' fp32 tolerance 2e-5), and ``calibrate_kernels(
autotune_blocks=True)`` against the reference's op and shape keys.

Every test gives the tuner a cache under ``tmp_path`` (an explicit
``AutotuneCache`` or ``REPRO_KERNEL_CACHE_DIR``), never the user's.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.profiler import measured as jmeasured
from repro.kernels import autotune as jat
from repro_torch.bench import kernels_bench
from repro_torch.core.profiler import measured as tmeasured
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_mod

TOL = dict(rtol=2e-5, atol=2e-5)
RNG = np.random.default_rng(0)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """A fresh default cache directory, and no shared cache left over."""
    monkeypatch.setenv("REPRO_KERNEL_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_KERNEL_AUTOTUNE", raising=False)
    tat._shared_cache.cache_clear()
    yield tmp_path
    tat._shared_cache.cache_clear()


def _t(*shape, dtype=torch.float32):
    return torch.from_numpy(RNG.standard_normal(shape).astype(
        np.float32)).to(dtype)


# --- the reference's autotuner tests, on the port ----------------------------

def test_autotune_deterministic_and_persistent(tmp_path):
    calls = []
    times = {16: 3e-3, 32: 1e-3, 64: 2e-3}

    def bench(c):
        calls.append(c["block"])
        return times[c["block"]]

    cands = [{"block": b} for b in (16, 32, 64)]
    cache = tat.AutotuneCache(tmp_path / "tune.json")
    win = tat.autotune("op", (128,), "float32", cands, bench,
                       chip="testchip", cache=cache)
    assert win == {"block": 32}
    assert calls == [16, 32, 64]
    win2 = tat.autotune("op", (128,), "float32", cands, bench,
                        chip="testchip", cache=cache)
    assert win2 == win and calls == [16, 32, 64]
    cache2 = tat.AutotuneCache(tmp_path / "tune.json")
    win3 = tat.autotune("op", (128,), "float32", cands,
                        lambda c: 1 / 0, chip="testchip", cache=cache2)
    assert win3 == win
    with pytest.raises(RuntimeError, match="no feasible"):
        tat.autotune("op", (128,), "float32", cands[:2],
                     lambda c: 1 / 0, chip="testchip", cache=cache2)
    with pytest.raises(ValueError, match="empty candidate grid"):
        tat.autotune("op", (128,), "float32", [], bench, chip="testchip",
                     cache=cache2)


def test_autotune_skips_infeasible_and_breaks_ties(tmp_path):
    cache = tat.AutotuneCache(tmp_path / "tune.json")

    def bench(c):
        if c["block"] == 16:
            raise ValueError("infeasible tiling")
        return 1e-3                      # tie between 32 and 64

    cands = [{"block": b} for b in (16, 32, 64)]
    win = tat.autotune("op", (64,), "float32", cands, bench,
                       chip="testchip", cache=cache)
    assert win == {"block": 32}          # first of the tied candidates
    entry = json.loads((tmp_path / "tune.json").read_text())
    (ent,) = entry.values()
    assert ent["config"] == {"block": 32} and ent["time_s"] == 1e-3
    assert ent["tuned"] == [[{"block": 32}, 1e-3], [{"block": 64}, 1e-3]]


def test_autotune_tuned_blocks_match_defaults(cache_dir):
    """``block_rows="auto"`` gives the default tile's output."""
    x, sc = _t(4, 100, 128), _t(128)
    out = ops.rmsnorm(x, sc, block_rows="auto")
    torch.testing.assert_close(out, ops.rmsnorm(x, sc), **TOL)
    assert list(cache_dir.glob("autotune-cpu-host.json"))


def test_a_corrupt_cache_file_retunes(tmp_path):
    p = tmp_path / "tune.json"
    p.write_text("{not json")
    cache = tat.AutotuneCache(p)
    assert cache.get("anything") is None
    assert tat.autotune("op", (1,), "float32", [{"block": 8}],
                        lambda c: 1.0, chip="x", cache=cache) == {"block": 8}
    assert json.loads(p.read_text())


# --- what the two packages share -----------------------------------------------

@pytest.mark.parametrize("op,shape,dtype,chip,cands", [
    ("flash_attention", (8, 128, 128, 64, 1), "float32", "cpu-host",
     [{"block_q": 64, "block_k": 64}, {"block_q": 128, "block_k": 64}]),
    ("rmsnorm", (3000, 256), "bfloat16", "H100",
     [{"block_rows": None}, {"block_rows": 32}]),
    ("ssd_scan", (1, 512, 2, 32, 16), "float32", "tpu-v5e",
     [{"chunk": 64}, {"chunk": 128}]),
])
def test_cache_key_is_the_references(op, shape, dtype, chip, cands):
    assert tat.cache_key(op, shape, dtype, chip, cands) == \
        jat.cache_key(op, shape, dtype, chip, cands)
    assert tat._grid_fingerprint(cands) == jat._grid_fingerprint(cands)


def test_dtype_names_are_the_references():
    from repro_torch.device import dtype_name, torch_dtype
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                  jnp.bfloat16)):
        assert dtype_name(t) == str(jnp.dtype(j))
        assert torch_dtype(dtype_name(t)) is t
    assert dtype_name("float32") == "float32"


def test_cache_files_cross_both_ways(tmp_path):
    cands = [{"block_rows": None}, {"block_rows": 32}]
    key = tat.cache_key("rmsnorm", (64, 64), "float32", "cpu-host", cands)
    tat.AutotuneCache(tmp_path / "t.json").put(
        key, {"block_rows": 32}, 1e-3, [({"block_rows": None}, 2e-3),
                                        ({"block_rows": 32}, 1e-3)])
    assert jat.AutotuneCache(tmp_path / "t.json").get(key) == \
        {"block_rows": 32}
    jkey = jat.cache_key("rmsnorm", (3000, 256), "float32", "cpu-host",
                         jat.rows_candidates(3000))
    jat.AutotuneCache(tmp_path / "j.json").put(
        jkey, {"block_rows": 128}, 5e-4, [({"block_rows": 128}, 5e-4)])
    assert tat.AutotuneCache(tmp_path / "j.json").get(jkey) == \
        {"block_rows": 128}
    # the same file through both: neither reads the other's winner, since
    # the grids (so the keys) differ
    assert tat.cache_key("rmsnorm", (3000, 256), "float32", "cpu-host",
                         tat.rows_candidates(3000)) != jkey


def test_default_cache_path_and_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_CACHE_DIR", str(tmp_path))
    assert tat.default_cache_path() == tmp_path / "autotune-cpu-host.json"
    assert tat.default_cache_path("H100") == tmp_path / "autotune-H100.json"
    assert tat.default_cache_path("H100") == \
        jat.default_cache_path("H100")
    for value, on in (("", False), ("0", False), ("1", True),
                      ("yes", True)):
        monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", value)
        assert tat.enabled() is on is jat.enabled()


def test_grids_hold_only_built_tiles():
    for dtype in (torch.float32, torch.bfloat16):
        grid = tat.flash_candidates(dtype)
        kern = fa.kernel_for(dtype)
        assert {c["block_q"] for c in grid} == set(fa.BLOCK_Q_CHOICES[kern])
        assert {c["block_k"] for c in grid} == set(fa.BLOCK_K_CHOICES)
    for rows in (1, 7, 100, 3000):
        grid = tat.rows_candidates(rows)
        assert grid[0] == {"block_rows": None}
        assert all(1 <= c["block_rows"] <= rows for c in grid[1:])
    for s in (1, 50, 512):
        grid = tat.chunk_candidates(s)
        assert all(1 <= c["chunk"] <= min(s, ssd_mod.MAX_CHUNK)
                   for c in grid)


def test_tuning_under_a_capture_raises(tmp_path, monkeypatch):
    """A cache miss while the stream captures raises; a hit does not
    (``torch.cuda.is_current_stream_capturing`` patched: the CPU has no
    capture)."""
    cache = tat.AutotuneCache(tmp_path / "t.json")
    cands = [{"block": 1}]
    tat.autotune("op", (1,), "float32", cands, lambda c: 1.0, chip="x",
                 cache=cache)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert tat.autotune("op", (1,), "float32", cands, lambda c: 1 / 0,
                        chip="x", cache=cache) == {"block": 1}
    with pytest.raises(RuntimeError, match="capturing a graph"):
        tat.autotune("op", (2,), "float32", cands, lambda c: 1.0, chip="x",
                     cache=cache)


# --- the wrappers ---------------------------------------------------------------

def _calls():
    q, k, v = _t(2, 40, 4, 32), _t(2, 40, 2, 32), _t(2, 40, 2, 32)
    x, r, sc = _t(3, 50, 64), _t(3, 50, 64), _t(64)
    sx = _t(1, 50, 2, 16)
    dt = torch.from_numpy(RNG.uniform(0.001, 0.1, (1, 50, 2)).astype(
        np.float32))
    a = -torch.from_numpy(RNG.uniform(0.5, 2.0, (2,)).astype(np.float32))
    b, c = _t(1, 50, 16), _t(1, 50, 16)
    return {
        "flash_attention": lambda blk: ops.flash_attention(
            q, k, v, causal=True, block_q=blk, block_k=blk),
        "rmsnorm": lambda blk: ops.rmsnorm(x, sc, block_rows=blk),
        "fused_add_rmsnorm": lambda blk: ops.fused_add_rmsnorm(
            x, r, sc, block_rows=blk),
        "ssd_scan": lambda blk: ops.ssd_scan(sx, dt, a, b, c, chunk=blk),
    }


@pytest.mark.parametrize("op", ["flash_attention", "rmsnorm",
                                "fused_add_rmsnorm", "ssd_scan"])
@pytest.mark.parametrize("how", ["auto", "env"])
def test_tuned_wrappers_give_the_default_output(op, how, cache_dir,
                                                monkeypatch):
    """``block="auto"`` (or None with ``REPRO_KERNEL_AUTOTUNE=1``) tunes
    into the default cache once, then reads it; the output equals the
    default tile's to 2e-5 (the same function at another tile)."""
    call = _calls()[op]
    want = call(None)
    if how == "env":
        monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "1")
    blk = "auto" if how == "auto" else None
    got = call(blk)
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        torch.testing.assert_close(g, w, **TOL)
    data = json.loads((cache_dir / "autotune-cpu-host.json").read_text())
    (key,) = data
    assert key.startswith(f"{op}|float32|cpu-host|s")
    entry = data[key]
    assert entry["config"] in [c for c, _ in entry["tuned"]]
    mtime = (cache_dir / "autotune-cpu-host.json").stat().st_mtime_ns
    call(blk)                           # a hit: nothing rewritten
    assert (cache_dir / "autotune-cpu-host.json").stat().st_mtime_ns == mtime


@pytest.mark.parametrize("kv_heads,shape", [
    (4, (8, 40, 40, 32, 1)), (2, (8, 40, 40, 32, 1, 2))])
def test_flash_attention_keys_as_the_reference(cache_dir, kv_heads, shape):
    """(B, S, H, D) inputs key as the reference's (B*H, S, D) call; a
    grouped call (KH < H, which the port's kernel reads in place) appends
    KH, so it keeps a winner of its own."""
    q, kv = _t(2, 40, 4, 32), _t(2, 40, kv_heads, 32)
    tat.tune_flash_attention(q, kv, kv, causal=True)
    (key,) = json.loads((cache_dir / "autotune-cpu-host.json").read_text())
    assert key == tat.cache_key("flash_attention", shape,
                                "float32", "cpu-host",
                                tat.flash_candidates(torch.float32))


def test_a_tuner_propagates_a_failing_candidate(cache_dir, monkeypatch):
    """The port's grids hold only built tiles, so its tuners skip nothing:
    a candidate that fails (a kernel that did not build or launch) raises
    out of the tune, and nothing is cached; ``autotune`` itself still
    skips what its ``skip`` names."""
    real = ops._rmsnorm

    def broken(x, scale, eps, block_rows):
        if block_rows == 32:
            raise RuntimeError("rmsnorm: kernel launch failed")
        return real(x, scale, eps, block_rows)

    monkeypatch.setattr(ops, "_rmsnorm", broken)
    x, sc = _t(300, 64), _t(64)
    with pytest.raises(RuntimeError, match="launch failed"):
        tat.tune_rmsnorm(x, sc, eps=1e-5)
    assert not list(cache_dir.iterdir())
    cands = [{"block": b} for b in (1, 2)]
    with pytest.raises(ZeroDivisionError):
        tat.autotune("op", (1,), "float32", cands, lambda c: 1 / 0,
                     chip="x", cache=tat.AutotuneCache(cache_dir / "t.json"),
                     skip=(ValueError,))


def test_decode_auto_takes_the_default_tile(cache_dir):
    q, kc = _t(2, 1, 4, 32), _t(2, 64, 2, 32)
    out = ops.flash_attention_decode(q, kc, kc, cache_len=40)
    torch.testing.assert_close(out, ops.flash_attention_decode(
        q, kc, kc, cache_len=40, block_k=fa.BLOCK_K), rtol=0, atol=0)
    assert not list(cache_dir.iterdir())


def test_a_wrapper_with_bad_arguments_raises_before_tuning(cache_dir):
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(_t(1, 8, 2, 20), _t(1, 8, 2, 20),
                            _t(1, 8, 2, 20), block_q="auto")
    assert not list(cache_dir.iterdir())


# --- calibration and the bench ---------------------------------------------------

_GRID = dict(attn_shapes=((2, 64, 32),), decode_shapes=((2, 64, 32),),
             norm_shapes=((64, 64), (256, 64)),
             ssd_shapes=((1, 64, 1, 32, 16),))


def test_calibrate_kernels_autotuned_keys_match_reference(cache_dir):
    cal = tmeasured.calibrate_kernels("cpu-host", iters=1, register=False,
                                      device="cpu", autotune_blocks=True,
                                      **_GRID)
    ref = jmeasured.calibrate_kernels("cpu-host", iters=1, register=False,
                                      **_GRID)
    assert {(op, dt, sh) for (op, dt), rows in cal.table.entries.items()
            for sh, _ in rows} == \
        {(op, dt, sh) for (op, dt), rows in ref.table.entries.items()
         for sh, _ in rows}
    assert [(r["op"], r["shape"]) for r in cal.points] == \
        [(r["op"], r["shape"]) for r in ref.points]
    keys = json.loads((cache_dir / "autotune-cpu-host.json").read_text())
    assert sorted(k.split("|")[0] for k in keys) == sorted(
        ["flash_attention", "rmsnorm", "rmsnorm", "fused_add_rmsnorm",
         "fused_add_rmsnorm", "ssd_scan"])


@pytest.mark.parametrize("op,shape", [
    ("rmsnorm", (300, 64)), ("fused_add_rmsnorm", (300, 64)),
    ("flash_attention", (4, 96, 96, 32, 1)),
    ("ssd_scan", (1, 96, 2, 16, 16))])
def test_kernels_bench_autotuned_checks_the_winner(op, shape, tmp_path):
    """``autotuned``'s check sees the winning tile's output beside its
    plain version's at that tile (the same function: 2e-5)."""
    seen = []

    def check(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        seen.append(len(got))

    res = kernels_bench.autotuned(op, shape, "float32",
                                  cache_dir=str(tmp_path), iters=1,
                                  device="cpu", check=check)
    assert seen == [2 if op in ("fused_add_rmsnorm", "ssd_scan") else 1]
    assert res["same_winner"] in (True, False)


def test_kernels_bench_autotuned_on_the_cpu(tmp_path):
    res = kernels_bench.autotuned("rmsnorm", (300, 64), "float32",
                                  cache_dir=str(tmp_path), iters=1,
                                  device="cpu")
    assert res["config"] in [c["config"] for c in res["candidates"]]
    assert [c["config"] for c in res["candidates"]] == \
        tat.rows_candidates(300)
    assert res["default"] == {"block_rows": None}
    assert res["vs_default"] > 0 and isinstance(res["same_winner"], bool)
    with pytest.raises(ValueError, match="no tuner"):
        kernels_bench.autotuned("flash_decode", (4, 64, 32), "float32",
                                cache_dir=str(tmp_path), device="cpu")
