#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. card    the card's name and power limit (nvidia-smi); TF32 off for
           matmuls and cuDNN, so float32 is float32.
2. build   compile every CUDA source of the port with nvcc, timed.
3. kernels hold each kernel against its plain PyTorch version on the card
           (bf16 2e-2, fp32 2e-5) at the serving shapes and the edge cases,
           and time kernel, plain version and, where one exists, the
           PyTorch library call computing the same function.
4. serve   smollm-360M at its published widths (32 layers, bf16, seeded
           random weights) through ``BatchedServer``: 16 requests, prompts
           of 256-509 tokens, 32 new tokens each, batch 8.  Both kernels
           must show 32 launches per prefill; the prefill's last-token
           logits are held against the port's plain path.  Prefill and
           decode are timed, then profiled (device time by kernel group,
           and the device's busy share of the wall time).
5. result  one JSON line of kernel figures, the card line, then
           ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or run outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused as fused_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.serve_step import BatchedServer, Request  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor-core
# rate, float32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py
SOURCES = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:51"),
    "fused_add_rmsnorm": dict(
        source="src/repro_torch/csrc/fused_add_rmsnorm.cu",
        replaces="src/repro/kernels/fused.py:31"),
}
# serve phase (smollm-360M, published widths)
ARCH = "smollm_360m"
N_REQUESTS, BATCH, MAX_NEW = 16, 8, 32
PROMPT_MIN, PROMPT_MAX = 256, 509
# Last-token logits, kernel path vs plain path (naive attention + unfused
# norm), bf16 through 32 layers.  The two paths round at different places
# (the kernel keeps P in fp32 for P V and normalises the fp32 sum; the
# plain path casts P and y to bf16 first), each a relative 2^-9 per
# rounding, compounding through the residual stream.  Logits of these
# random weights have a spread of ~0.6; 0.1 allows ~1/6 of that and is
# what a real indexing or masking fault (O(1) errors) cannot pass.
LOGITS_TOL = 0.1
SMALL_FP32_TOL = 1e-4   # fp32, 2 layers: kernel path vs plain path


def log(msg: str) -> None:
    print(msg, flush=True)


# --- timing ------------------------------------------------------------------------

def time_ms(fn, reps: int = 5, n: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``n`` back-to-back
    calls, from CUDA events.  A sleep kernel queued first keeps the device
    busy while the host enqueues the calls, so short kernels are timed
    without the host's launch gaps (where the host is slower than the
    device, as for the plain versions, the gaps count)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                dtype: torch.dtype) -> float:
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        raise AssertionError(f"{name}: max |kernel - plain| "
                             f"{err.max().item():.3e} exceeds {tol}")
    return err.max().item()


# --- phases ------------------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] nvidia-smi name, power.limit:")
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.FLAGS[1]}, one process per source)")
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.1f}s -> {info['path']}")
        for line in info["log"].splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _attn_inputs(gen, b, sq, sk, h, kh, d, dtype):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(b, sq, h, d), rnd(b, sk, kh, d), rnd(b, sk, kh, d)


def _sdpa(q, k, v, causal):
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True)


def attention_case(gen, label, b, sq, sk, h, kh, d, causal, dtype,
                   block_q=None, timed=False):
    q, k, v = _attn_inputs(gen, b, sq, sk, h, kh, d, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=block_q)
    want = fa.flash_attention_plain(q, k, v, causal=causal,
                                    block_q=block_q or fa.BLOCK_Q)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {label}", got, want, dtype)
    row = dict(label=label, shape=[b, sq, sk, h, kh, d], causal=causal,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err)
    if timed:
        es = q.element_size()
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = es * (2 * b * sq * h * d + 2 * b * sk * kh * d)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4.0 * d * pairs * b * h, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, block_q=block_q or fa.BLOCK_Q))
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), reps=3, n=2)
        row["library_ms"] = time_ms(lambda: _sdpa(q, k, v, causal))
    log(f"[kernels] flash_attention {json.dumps(row)}")
    return row


def fused_case(gen, label, rows, d, dtype, timed=False):
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    r = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    sc = torch.randn(d, generator=gen, device="cuda").to(dtype)
    h, y = ops.fused_add_rmsnorm(x, r, sc)
    wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    err = max(check_close(f"fused_add_rmsnorm {label} h", h, wh, dtype),
              check_close(f"fused_add_rmsnorm {label} y", y, wy, dtype))
    row = dict(label=label, shape=[rows, d],
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err)
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (4 * rows * d + d), 6.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_cuda(
            x, r, sc))
        row["plain_ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_plain(
            x, r, sc))
        row["library_ms"] = None    # no single PyTorch call returns (h, y)
    log(f"[kernels] fused_add_rmsnorm {json.dumps(row)}")
    return row


def serve_requests(cfg, seed: int, n: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=n)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(s),
                                               dtype=np.int32),
                    max_new_tokens=MAX_NEW) for i, s in enumerate(lens)]


def batch_lengths(reqs):
    """Padded prompt length of each batch the server will prefill."""
    return [max(len(r.prompt) for r in reqs[i:i + BATCH])
            for i in range(0, len(reqs), BATCH)]


def phase_kernels(main_lens):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config(ARCH)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    attn = [attention_case(gen, "prefill_s512", BATCH, 512, 512, h, kh, d,
                           True, bf16, timed=True)]
    for s in sorted(set(main_lens)):          # the serve phase's own shapes
        attn.append(attention_case(gen, f"serve_s{s}", BATCH, s, s, h, kh, d,
                                   True, bf16))
    attn += [
        attention_case(gen, "ragged_s509", BATCH, 509, 509, h, kh, d, True,
                       bf16),
        attention_case(gen, "block_q16", BATCH, 509, 509, h, kh, d, True,
                       bf16, block_q=16),
        attention_case(gen, "noncausal_130x70", 2, 130, 70, h, kh, d, False,
                       bf16),
        attention_case(gen, "d128_f32", 2, 256, 256, 4, 2, 128, True, f32),
        attention_case(gen, "d80", 2, 200, 200, 6, 2, 80, True, bf16),
        attention_case(gen, "noncausal_257x300_f32", 2, 257, 300, 4, 2, 64,
                       False, f32),
    ]
    dm = cfg.d_model
    norm = [fused_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True)]
    for s in sorted(set(main_lens)):
        norm.append(fused_case(gen, f"serve_rows{BATCH * s}", BATCH * s, dm,
                               bf16))
    norm += [fused_case(gen, "ragged_rows4071", 4071, dm, bf16),
             fused_case(gen, "f32_rows1000", 1000, dm, f32),
             fused_case(gen, "d8192", 64, 8192, bf16)]
    return attn[0], norm[0]


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_small_reference() -> None:
    """fp32, 2 layers, head_dim 64: the kernel path against the plain path
    on the card (TF32 is off, so both are float32 throughout)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), head_dim=64)
    params = model_lib.init(cfg, 1, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 77))).cuda()
    got = model_lib.forward(cfg, params, {"tokens": toks}, attn_impl="kernel")
    want = model_lib.forward(cfg, params, {"tokens": toks},
                             attn_impl="naive")
    err = (got - want).abs().max().item()
    if not err <= SMALL_FP32_TOL:
        raise AssertionError(f"small fp32 model: kernel vs plain path "
                             f"{err:.3e} > {SMALL_FP32_TOL}")
    log(f"[serve] small fp32 model, kernel vs plain path: max |dlogit| "
        f"{err:.3e} (tol {SMALL_FP32_TOL})")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention kernel"
    if "fused_add_rmsnorm" in name:
        return "fused_add_rmsnorm kernel"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "splitk",
                              "nvjet")):    # nvjet: cuBLAS's sm90 GEMMs
        return "matmul (cuBLAS)"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    return "elementwise/other"


def profile_window(label: str, fn, wall_ms: float, per: int) -> None:
    """Device time by kernel group over one run of ``fn`` (torch.profiler,
    read from its Chrome trace so kernels launched outside PyTorch's own
    operators count too).  ``busy`` is that device time over ``wall_ms``,
    the same work's wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", f"chip_smoke_trace_{label}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    groups: dict = {}
    names: dict = {}
    n_kernels = 0
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            ms = ev.get("dur", 0.0) / 1e3 / per
            g = _kernel_group(ev.get("name", ""))
            groups[g] = groups.get(g, 0.0) + ms
            short = ev.get("name", "")[:60]
            names[short] = names.get(short, 0.0) + ms
            n_kernels += 1
    if not n_kernels:
        log(f"[profile] {label}: the trace holds no device kernels; "
            "device time not measured")
        return
    device_ms = sum(groups.values())
    log(f"[profile] {label} (per {'step' if per > 1 else 'call'}): "
        + json.dumps(dict(
            wall_ms=wall_ms / per, device_ms=device_ms,
            busy=device_ms / (wall_ms / per), kernels=n_kernels / per,
            by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            top=sorted(names.items(), key=lambda kv: -kv[1])[:5])))


def phase_serve(reqs, warm):
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = model_lib.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) \
        + params["embed"].numel() + params["ln_f"].numel()
    log(f"[serve] {cfg.name}: {n_params / 1e6:.1f}M params "
        f"({cfg.param_dtype}) initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    max_len = PROMPT_MAX + MAX_NEW + 8
    server = BatchedServer(cfg, params, max_len=max_len, batch_size=BATCH)

    t_warm = _timed(lambda: server.run(warm))
    log(f"[serve] warmup batch ({len(warm)} requests): {t_warm:.0f} ms")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_run = _timed(lambda: server.run(reqs))
    launches = dict(ops.LAUNCHES)
    n_prefill = len(batch_lengths(reqs))
    for name, n in launches.items():
        if n != cfg.n_layers * n_prefill:
            raise AssertionError(
                f"{name}: {n} launches in the serve run, expected "
                f"{cfg.n_layers} per prefill x {n_prefill} prefills")
    if not all(r.done and len(r.output) == MAX_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("a generated token is outside the vocabulary")
    n_tok = sum(len(r.output) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] launches in the serve run: {json.dumps(launches)} "
        f"({n_prefill} prefills x {cfg.n_layers} layers)")

    # prefill / decode step times on the first batch
    first = reqs[:BATCH]
    plen = max(len(r.prompt) for r in first)
    toks = np.zeros((len(first), plen), np.int64)
    for i, r in enumerate(first):
        toks[i, plen - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    with torch.inference_mode():
        prefill_ms = statistics.median(
            _timed(lambda: server._prefill(params, batch)) for _ in range(3))
        logits, cache = server._prefill(params, batch)
        plain = model_lib.forward(cfg, params, batch, attn_impl="naive")[:, -1]
        full = model_lib.init_cache(cfg, len(first), max_len, device="cuda")
        cache = kv_cache.grow_cache(cache, full)
        cur = torch.argmax(logits, dim=-1)[:, None]

        def decode_steps(steps):
            nonlocal cache, cur
            for _ in range(steps):
                lg, cache = server._decode(params, cache, cur)
                cur = torch.argmax(lg, dim=-1)[:, None]
        decode_ms = statistics.median(
            _timed(lambda: decode_steps(1)) for _ in range(16))
        profile_window("prefill", lambda: server._prefill(params, batch),
                       prefill_ms, 1)
        profile_window("decode", lambda: decode_steps(8), decode_ms * 8, 8)
    if logits.shape != (len(first), cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    dlogit = (logits - plain).abs().max().item()
    if not dlogit <= LOGITS_TOL:
        raise AssertionError(f"prefill last-token logits: kernel vs plain "
                             f"path {dlogit:.3e} > {LOGITS_TOL}")
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    stats = dict(prefill_ms=prefill_ms, prefill_batch=[len(first), plen],
                 decode_ms_per_step=decode_ms, decode_batch=len(first),
                 steady_tok_s=n_tok / (t_run / 1e3), steady_tokens=n_tok,
                 steady_s=t_run / 1e3, warmup_s=t_warm / 1e3,
                 peak_mem_gib=peak / 2**30, logits_max_abs_diff=dlogit,
                 logits_std=logits.std().item(), argmax_agree=agree,
                 decode_steps=server.decode_steps,
                 decode_row_steps=server.decode_row_steps)
    log(f"[serve] {json.dumps(stats)}")
    return launches


def main() -> int:
    smi = phase_card()
    phase_build()
    cfg = get_config(ARCH)
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    warm = serve_requests(cfg, 1, BATCH)
    attn, norm = phase_kernels(batch_lengths(reqs))
    phase_small_reference()
    launches = phase_serve(reqs, warm)
    kernels = []
    for name, row in (("flash_attention", attn), ("fused_add_rmsnorm", norm)):
        kernels.append(dict(
            name=name, route="cuda", **SOURCES[name],
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
