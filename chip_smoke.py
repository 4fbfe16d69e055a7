#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi); TF32 off for
             matmuls and cuDNN, so float32 is float32.
2. build     compile every CUDA source of the port with nvcc, in parallel;
             registers, spills and shared memory of every instantiation of
             the decode kernel, the bf16 (wgmma) attention kernels, forward
             and backward, the RMSNorm and fused add + RMSNorm kernels and
             the SSD scan's passes.
3. kernels   hold each of the six kernels against its plain PyTorch version
             on the card (bf16 2e-2, fp32 2e-5; SSD y 4e-2 / 1e-4 and state
             1e-2 / 1e-4) at the main paths' shapes and the edge cases, and
             time kernel, plain version and, where one exists, the PyTorch
             library call computing the same function.  RMSNorm is timed
             at 4096 and 16384 x 960 bf16 beside ``F.rms_norm``, the fused
             add + RMSNorm at the same shapes, and each case of both checks
             which instantiation ran (16-byte or scalar loads, on widths
             and views that are not 16-byte multiples); the fused
             kernel's y must be its plain version's bit for bit.  The SSD
             scan is held against the composition of its four passes' plain
             versions, and each pass is timed alone (``passes_ms``).  Decode also runs
             at forced split counts (one split, one tile a split) and is
             timed at the serve shape beside the kernel line's case.
             Prefill attention is timed at the serve shape and at the
             calibrate path's (1, 2048, 120/120, 64), each beside the
             CUDA-core kernel run on the same bf16 inputs
             (``impl="cuda_core"``).
4. models    a 2-layer fp32 model, kernel path vs plain path; the reduced
             smollm config (head_dim 16, ``attn_impl="auto"``) prefills
             through the attention kernel.
5. serve     smollm-360M at its published widths (32 layers, bf16, seeded
             random weights) through ``BatchedServer``: 16 requests, prompts
             of 256-509 tokens, 32 new tokens each, batch 8.  The two
             prefill kernels must show 32 launches per prefill and the
             other four none; the prefill's last-token logits are held
             against the port's plain path.  Prefill and decode are timed,
             then profiled (device time by kernel group, busy share).
6. calibrate ``calibrate_kernels("H100", bf16 and fp32)`` at smollm-360M's
             widths, the table scored on held-out shapes against the
             roofline (``bench.kernels_bench.cost_table_accuracy``), and
             ``JobProfile`` prices of one smollm-360M layer with and
             without the table beside the serve phase's device time.
7. fused     ``bench.kernels_bench.fused_vs_unfused``: the fused kernel
             against the add kernel + the RMSNorm kernel.
8. train     smollm-360M at its published widths and 32 layers, bf16,
             ``remat="full"``, through ``train_step.make_train_step`` on
             ``SyntheticDataset`` batches (seq 1024, global batch 8, 2
             microbatches): 8 AdamW steps on one repeated batch (the loss
             must fall), then 3 timed steps on fresh batches (device ms a
             step by CUDA events, host wall ms, tokens/s, peak memory) and
             one profiled.  Per step the attention forward must launch
             2 x 32 x 2 times (the forward runs again under remat) and each
             backward kernel 32 x 2 times.  Then one microbatch's loss and
             gradients through the kernels against the plain path
             (``attn_impl="naive"``), at full width in bf16 and on a
             2-layer fp32 model (1e-4 of max |g|).
9. result    one JSON line of kernel figures, the card line, then
             ``{"ok": true, "device": {...}}`` as the last line.  The
             attention entry also carries its share of the bound, its
             TFLOP/s, the CUDA-core kernel's time on the same inputs
             (``earlier_ms``) and the same four figures at the calibrate
             shape (``calibrate``); the norm entries their plan, share of
             the bound and the 16384-row case (``rows16384``).

Each of phases 5-8 is a main path: the launch counts are set to 0 just
before it and read just after, and each kernel must have launched on the
path that runs it.  Phase 3 also holds the two backward kernels
(attention, fused add + RMSNorm) against their plain versions on the
train path's shapes and edge cases, each run twice and compared bit for
bit, timed beside the backward of ``F.scaled_dot_product_attention`` for
attention.  The bf16 attention backward runs the tensor-core kernels and
is timed beside the CUDA-core ones on the same inputs (``earlier_ms``,
also held against their plain version) and at each pair of blocks
(``blocks_ms``).

Without a CUDA device, or run outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.bench import kernels_bench  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import kernel_costs  # noqa: E402
from repro_torch.core.profiler import measured  # noqa: E402
from repro_torch.core.profiler.analytic import (JobProfile, ServeJob,  # noqa: E402
                                                TrainJob)
from repro_torch.core.profiler.hw_specs import get_accelerator  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import add as add_mod  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused as fused_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.serve.serve_step import BatchedServer, Request  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as train_lib  # noqa: E402

# the card's HBM rate and dense bf16 tensor-core rate from the port's
# catalog; float32 outside the tensor cores from the H100 SXM data sheet
H100 = get_accelerator("H100")
PEAK_FLOPS = {torch.bfloat16: H100.peak_flops, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py
SOURCES = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:51"),
    "fused_add_rmsnorm": dict(
        source="src/repro_torch/csrc/fused_add_rmsnorm.cu",
        replaces="src/repro/kernels/fused.py:31"),
    "flash_attention_decode": dict(
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:164"),
    "rmsnorm": dict(
        source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:34"),
    "ssd_scan": dict(
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd.py:33"),
    "add": dict(
        source="src/repro_torch/csrc/add.cu",
        replaces="benchmarks/kernels_bench.py:116"),
    # the backward of the Pallas kernel named (the reference has none)
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:51"),
    "fused_add_rmsnorm_bwd": dict(
        source="src/repro_torch/csrc/fused_add_rmsnorm_bwd.cu",
        replaces="src/repro/kernels/fused.py:31"),
}
SERVE_KERNELS = ("flash_attention", "fused_add_rmsnorm")
CALIBRATE_KERNELS = ("flash_attention", "fused_add_rmsnorm",
                     "flash_attention_decode", "rmsnorm", "ssd_scan")
FUSED_KERNELS = ("fused_add_rmsnorm", "rmsnorm", "add")
SSD_TOL = {torch.bfloat16: (4e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
# backward kernels vs their plain versions: max |kernel - plain| over max
# |plain| (both sum in fp32 in other orders; bf16 outputs round once)
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
TRAIN_KERNELS = ("flash_attention", "fused_add_rmsnorm",
                 "flash_attention_bwd", "fused_add_rmsnorm_bwd")
# calibration grids at smollm-360M's widths: 120 = 8 rows x 15 heads,
# d_model 960; SSD at mamba2-130m's (24 heads, P 64, N 128)
CAL_GRID = dict(
    attn_shapes=((120, 256, 64), (120, 512, 64), (120, 1024, 64),
                 (120, 2048, 64)),
    decode_shapes=((120, 256, 64), (120, 1024, 64), (120, 4096, 64)),
    norm_shapes=((8, 960), (512, 960), (4096, 960), (16384, 960)),
    ssd_shapes=((1, 512, 24, 64, 128), (4, 2048, 24, 64, 128)))
HELD_OUT = [("flash_attention", (120, 384, 384, 64, 1)),
            ("flash_attention", (120, 768, 768, 64, 1)),
            ("flash_decode", (120, 549, 64)), ("flash_decode", (120, 2048, 64)),
            ("rmsnorm", (1024, 960)), ("rmsnorm", (8192, 960)),
            ("ssd_scan", (2, 1024, 24, 64, 128))]
# serve phase (smollm-360M, published widths)
ARCH = "smollm_360m"
N_REQUESTS, BATCH, MAX_NEW = 16, 8, 32
PROMPT_MIN, PROMPT_MAX = 256, 509
# Last-token logits, kernel path vs plain path (naive attention + unfused
# norm), bf16 through 32 layers.  The two paths round at different places
# (the kernel keeps P to ~16 bits, two bf16 parts, for P V and normalises
# the fp32 sum; the plain path casts P and y to bf16 first), each a
# relative 2^-9 per rounding, compounding through the residual stream.  Logits of these
# random weights have a spread of ~0.6; 0.1 allows ~1/6 of that and is
# what a real indexing or masking fault (O(1) errors) cannot pass.
LOGITS_TOL = 0.1
SMALL_FP32_TOL = 1e-4   # fp32, 2 layers: kernel path vs plain path
# train phase (smollm-360M, published widths and depth, bf16)
TRAIN_DATA = dict(seq_len=1024, global_batch=8, num_microbatches=2)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)
TRAIN_STEPS, TRAIN_TIMED = 8, 3
# One microbatch's loss and gradients, kernel path vs plain path, full width
# in bf16 through 32 layers.  The paths round at different places (the
# kernels keep P to ~16 bits and take every backward sum in fp32 with one
# cast; the plain path's autograd rounds each op's output to bf16), a
# relative 2^-9 a rounding, compounding through 32 layers of the backward.
# A gradient leaf must agree to 10% of its max |g| and in direction
# (cosine >= 0.99): a wrong index, mask or missing term gives O(1) errors
# and cosines far below that.  The fp32 2-layer check holds 1e-4 of max |g|.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_COSINE = 2e-2, 0.1, 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


# --- timing ------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Median device ms of one call, each from a cold L2: the timer the
    cost table is built with (``kernels.autotune.bench_time``), so the
    kernel line and the table read the same clock."""
    return at.bench_time(fn, iters=iters, device="cuda") * 1e3


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / H100.mem_bw
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                dtype: torch.dtype, tol: float = None) -> float:
    tol = TOL[dtype] if tol is None else tol
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


def ptxas_report(log: str):
    """(entry function, registers, spill store bytes, spill load bytes) of
    each kernel in an ``nvcc -Xptxas -v`` log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def _wgmma_kernel_name(mangled: str):
    """(D, block_q) of a flash_fwd_wgmma<D, warpgroups> instantiation, or
    None for another kernel."""
    m = re.search(r"flash_fwd_wgmmaILi(\d+)ELi(\d+)E", mangled)
    return (int(m.group(1)), 64 * int(m.group(2))) if m else None


def _cuda_core_kernel_name(mangled: str) -> str:
    """flash_fwd<f32, D 64, block_q 32> from its mangled name (ROWS a warp,
    4 warps a block)."""
    m = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
    if not m:
        return mangled
    dt = "f32" if m.group(1) == "f" else "bf16"
    return (f"flash_fwd<{dt}, D {m.group(2)}, block_q "
            f"{4 * int(m.group(3))}>")


def _decode_kernel_name(mangled: str) -> str:
    """decode_split<bf16, D 64, heads 1> from its mangled name."""
    dt = "bf16" if "__nv_bfloat16" in mangled else "f32"
    m = re.search(r"decode_split.*?Li(\d+)ELi(\d+)E", mangled)
    if m:
        return f"decode_split<{dt}, D {m.group(1)}, heads {m.group(2)}>"
    return f"decode_merge<{dt}>" if "decode_merge" in mangled else mangled


def _bwd_wgmma_name(mangled: str):
    """(kernel, D, block) of a bwd_dq_wgmma / bwd_dkdv_wgmma<D, warpgroups>
    instantiation, or None for another kernel."""
    m = re.search(r"(bwd_dq_wgmma|bwd_dkdv_wgmma)ILi(\d+)ELi(\d+)E", mangled)
    return (m.group(1), int(m.group(2)), 64 * int(m.group(3))) if m else None


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


_BWD_NORM = re.compile(r"fused_add_rmsnorm_bwdI(f|13__nv_bfloat16)Li(\d+)ELb([01])"
                       r"ELb([01])E")


def _bwd_kernel_name(mangled: str) -> str:
    """bwd_dkdv<bf16, D 64> (or fused_add_rmsnorm_bwd<bf16, 4 values a
    lane, bulk copies>) from its mangled name."""
    dt = "bf16" if "__nv_bfloat16" in mangled else "f32"
    wg = _bwd_wgmma_name(mangled)
    if wg:
        return (f"{wg[0]}<D {wg[1]}, "
                f"block_{'q' if wg[0] == 'bwd_dq_wgmma' else 'k'} {wg[2]}>")
    m = re.search(r"(bwd_dkdv|bwd_dq)I(?:f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m:
        return f"{m.group(1)}<{dt}, D {m.group(2)}>"
    m = _BWD_NORM.search(mangled)
    if m:
        how = ("bulk copies" if m.group(4) == "1" else "16-byte loads"
               if m.group(3) == "1" else "scalar loads")
        return f"fused_add_rmsnorm_bwd<{dt}, {m.group(2)} values a lane, {how}>"
    return mangled


def _bwd_norm_smem(mangled: str) -> str:
    """The dynamic shared memory (the source's own count) of
    ``fused.bwd_plan``'s launch of an instantiation of the fused-norm
    backward at the widest row it takes with one warp (8 warps past
    ``BWD_WARP_VALS`` values a lane), 16384 rows."""
    m = _BWD_NORM.search(mangled)
    es = 4 if m.group(1) == "f" else 2
    vals, vec = int(m.group(2)), m.group(3) == "1"
    wpr = 1 if vals <= fused_mod.BWD_WARP_VALS else rn.WARPS
    d = 32 * vals * (16 // es) * wpr
    bp = fused_mod.bwd_plan(16384, d, es, rn.Plan(vec, vals, wpr), _sms())
    smem = _build.load("fused_add_rmsnorm_bwd").repro_fused_add_rmsnorm_bwd_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 7, ctypes.c_longlong
    dyn = smem(int(vec), es, d, wpr, bp.rows_per_step, bp.stages, bp.blocks)
    ring = (f"a ring of {bp.stages} stages of {bp.rows_per_step} rows"
            if bp.stages else "register loads")
    return f"{dyn} B dynamic shared memory at d {d} ({ring}), "


def _norm_kernel_name(mangled: str, kernel: str) -> str:
    """rmsnorm<bf16, 4 values a lane, 16-byte loads> (or the same of
    fused_add_rmsnorm) from its mangled name."""
    m = re.search(rf"(?<![a-z_]){kernel}I(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                  mangled)
    if not m:
        return mangled
    return (f"{kernel}<{'f32' if m.group(1) == 'f' else 'bf16'}, "
            f"{m.group(2)} values a lane, "
            f"{'16-byte' if m.group(3) == '1' else 'scalar'} loads>")


SSD_PASSES = ("ssd_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")


def _ssd_build_rows(info) -> None:
    """Registers, dynamic shared memory (at chunk 128, N 128) and spills of
    each pass's kernels."""
    smem = _build.load("ssd_scan").repro_ssd_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    for fn, regs, st, ld in ptxas_report(info["log"]):
        name = next((k for k in SSD_PASSES if k in fn), fn)
        kind = "mma" if "_mma" in fn else "fma" if "_fma" in fn else ""
        which = SSD_PASSES.index(name) + 1 if name in SSD_PASSES else 0
        dyn = smem(which, 1 if kind == "mma" else 0, 128, 128)
        log(f"[build]   {name}{'_' + kind if kind else ''}: {regs} registers, "
            f"{dyn} B dynamic shared memory, spill stores {st} B, spill loads "
            f"{ld} B")


def _norm_build_rows(info, kernel: str, warp_vals: int) -> None:
    """Registers and spills of each instantiation of a norm kernel, and
    the width up to which one warp holds a row (``warp_vals`` 16-byte
    values a lane: ``rmsnorm.WARP_VALS``, ``fused.WARP_VALS``)."""
    rows = ptxas_report(info["log"])
    for fn, regs, st, ld in rows:
        log(f"[build]   {_norm_kernel_name(fn, kernel)}: {regs} registers, "
            f"spill stores {st} B, spill loads {ld} B")
    one = [r for r in rows if f"Li{warp_vals}ELb1E" in r[0]]
    log(f"[build]   {kernel}: one warp a row up to {32 * warp_vals} 16-byte "
        f"values (d <= {256 * warp_vals} bf16, {128 * warp_vals} fp32),"
        f" wider rows 2-{rn.WARPS} warps; the 16-byte instantiations at "
        f"{warp_vals} values a lane: {[r[1] for r in one]} registers, "
        f"{sum(r[2] + r[3] for r in rows)} B spilled in all")


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.FLAGS[1]}, one process per source)")
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.1f}s -> {info['path']}")
        if name == "flash_decode":     # registers and spills of each kernel
            for fn, regs, st, ld in ptxas_report(info["log"]):
                log(f"[build]   {_decode_kernel_name(fn)}: {regs} registers,"
                    f" spill stores {st} B, spill loads {ld} B")
            continue
        if name == "flash_attention":  # and of each wgmma instantiation
            smem = _build.load(name).repro_flash_attention_wgmma_smem
            smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_longlong
            for fn, regs, st, ld in ptxas_report(info["log"]):
                shape = _wgmma_kernel_name(fn)
                if shape is None:
                    log(f"[build]   {_cuda_core_kernel_name(fn)}: {regs} "
                        f"registers, spill stores {st} B, spill loads {ld} B")
                    continue
                log(f"[build]   flash_fwd_wgmma<D {shape[0]}, block_q "
                    f"{shape[1]}>: {regs} registers, {smem(*shape)} B "
                    f"dynamic shared memory, spill stores {st} B, spill "
                    f"loads {ld} B")
            continue
        if name == "ssd_scan":
            _ssd_build_rows(info)
            continue
        if name == "rmsnorm":
            _norm_build_rows(info, name, rn.WARP_VALS)
            continue
        if name == "fused_add_rmsnorm":
            _norm_build_rows(info, name, fused_mod.WARP_VALS)
            continue
        if name in ("flash_attention_bwd", "fused_add_rmsnorm_bwd"):
            smem = None
            if name == "flash_attention_bwd":   # and of each wgmma kernel
                smem = _build.load(name).repro_flash_attention_bwd_wgmma_smem
                smem.argtypes = [ctypes.c_int] * 3
                smem.restype = ctypes.c_longlong
            for fn, regs, st, ld in ptxas_report(info["log"]):
                wg = _bwd_wgmma_name(fn)
                dyn = (f"{smem(int(wg[0] == 'bwd_dkdv_wgmma'), wg[1], wg[2])}"
                       f" B dynamic shared memory, " if wg
                       else _bwd_norm_smem(fn) if _BWD_NORM.search(fn)
                       else "")
                log(f"[build]   {_bwd_kernel_name(fn)}: {regs} registers, "
                    f"{dyn}spill stores {st} B, spill loads {ld} B")
            continue
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
                   block_q=None, timed=False, impl=None):
    """One attention case against the plain version of the kernel it runs
    (q's dtype's, or with ``impl="cuda_core"`` the CUDA-core kernel, called
    directly so it counts no wrapper launch)."""
    q, k, v = _attn_inputs(gen, b, sq, sk, h, kh, d, dtype)
    bq = block_q or fa.default_block_q(dtype, impl)
    if impl is None:
        got = ops.flash_attention(q, k, v, causal=causal, block_q=block_q)
    else:
        got = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                      impl=impl)
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                    impl=impl)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {label}", got, want, dtype)
    row = dict(label=label, shape=[b, sq, sk, h, kh, d], causal=causal,
               dtype=str(dtype).replace("torch.", ""),
               kernel=fa.kernel_for(dtype, impl), block_q=bq,
               max_abs_err=err)
    if timed:
        es = q.element_size()
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = es * (2 * b * sq * h * d + 2 * b * sk * kh * d)
        flops = 4.0 * d * pairs * b * h
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, block_q=bq, impl=impl))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, block_q=bq, impl=impl), iters=3)
        row["library_ms"] = time_ms(lambda: _sdpa(q, k, v, causal))
    log(f"[kernels] flash_attention {json.dumps(row)}")
    return row


def fused_case(gen, label, rows, d, dtype, timed=False, offset=None,
               want_vector=None):
    """``offset`` = (input, elements): that input ("x", "res" or "scale")
    starts so many elements into a flat buffer; an offset that is not a
    whole 16 bytes takes the scalar instantiation.  y must be the plain
    version's bit for bit (one fp32 add, one rounding)."""
    which, k = offset or (None, 0)

    def rnd(name, *shape):
        n = k if name == which else 0
        flat = torch.randn(int(np.prod(shape)) + n, generator=gen,
                           device="cuda").to(dtype)
        return flat[n:].view(*shape)
    x, r, sc = rnd("x", rows, d), rnd("res", rows, d), rnd("scale", d)
    h, y = ops.fused_add_rmsnorm(x, r, sc)
    wh, wy = fused_mod.fused_add_rmsnorm_plain(x, r, sc)
    torch.cuda.synchronize()
    err = check_close(f"fused_add_rmsnorm {label} h", h, wh, dtype)
    if not torch.equal(y, wy):
        raise AssertionError(f"fused_add_rmsnorm {label}: y is not the "
                             "plain version's bit for bit")
    plan = fused_mod.LAST_PLAN
    want_plan = fused_mod.plan(x, r, sc)
    if plan != want_plan or (want_vector is not None
                             and plan.vector != want_vector):
        raise AssertionError(f"fused_add_rmsnorm {label}: ran {plan}, "
                             f"expected {want_plan} (16-byte loads: "
                             f"{want_vector})")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=plan._asdict(), max_abs_err=err)
    if offset:
        row["offset"] = [which, k * x.element_size()]
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (4 * rows * d + d), 6.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_cuda(
            x, r, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_plain(
            x, r, sc))
        row["library_ms"] = None    # no single PyTorch call returns (h, y)
    log(f"[kernels] fused_add_rmsnorm {json.dumps(row)}")
    return row


def _dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_max(name: str, got: torch.Tensor, want: torch.Tensor,
              tol: float) -> float:
    """A gradient against its plain version: max |got - want| at most
    ``tol`` times max |want| (elementwise relative bounds mean nothing for
    the gradients' many near-zero entries)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err, top = (g - w).abs().max().item(), w.abs().max().item()
    if not err <= tol * top:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} "
                             f"exceeds {tol} x {top:.3e}")
    return err


def attention_bwd_case(gen, label, b, sq, sk, h, kh, d, causal, dtype,
                       timed=False, impl=None):
    """The backward kernels (q's dtype's, or with ``impl="cuda_core"`` the
    CUDA-core ones, called directly so they count no wrapper launch)
    against the plain backward with the same ``impl`` on the same q, k, v,
    dO and the kernel forward's LSE, run twice and compared bit for bit.
    Timed: beside the backward of ``F.scaled_dot_product_attention``
    (enable_gqa) on the same q, k, v and dO; the tensor-core kernels also
    beside the CUDA-core ones on the same inputs (``earlier_ms``) and at
    each pair of blocks (``blocks_ms``, "block_q x block_k")."""
    q, k, v = _attn_inputs(gen, b, sq, sk, h, kh, d, dtype)
    do = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    _, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    kernel = fa.kernel_for(dtype, impl)
    if impl is None:
        got = ops.flash_attention_bwd(q, k, v, do, lse, causal=causal)
    else:
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal,
                                          impl=impl)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, causal=causal,
                                        impl=impl)
    torch.cuda.synchronize()
    err = max(check_max(f"flash_attention_bwd {label} {n}", g, w,
                        BWD_TOL[dtype])
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    again = fa.flash_attention_bwd_cuda(q, k, v, do, lse, causal=causal,
                                        impl=impl)
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        raise AssertionError(f"flash_attention_bwd {label}: two runs differ")
    row = dict(label=label, shape=[b, sq, sk, h, kh, d], causal=causal,
               dtype=_dname(dtype), kernel=kernel,
               blocks=list(fa.BWD_BLOCKS[kernel]), max_abs_err=err)
    if timed:
        es = q.element_size()
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = (es * (3 * b * sq * h * d + 4 * b * sk * kh * d)
                  + 4 * b * h * sq)           # q, dO, dQ; k, v, dK, dV; LSE
        flops = 10.0 * d * pairs * b * h          # S, dP, dV, dK, dQ
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, do, lse, causal=causal, impl=impl))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        if kernel == "wgmma":
            row["earlier_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, do, lse, causal=causal, impl="cuda_core"))
            row["blocks_ms"] = {
                f"{bq}x{bk}": time_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, do, lse, causal=causal, block_q=bq, block_k=bk))
                for bq in fa.BWD_BLOCK_CHOICES[kernel]
                for bk in fa.BWD_BLOCK_CHOICES[kernel]}
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, causal=causal, impl=impl), iters=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    log(f"[kernels] flash_attention_bwd {json.dumps(row)}")
    return row


def fused_bwd_case(gen, label, rows, d, dtype, timed=False):
    """The backward kernel against its plain version; dsum at the
    forward's elementwise tolerance, dscale (a sum over every row) at
    BWD_TOL of its max.  The launch must leave the stream's ticket
    counters zero; the row carries ``bwd_plan``'s plan for these inputs."""
    x, r, dh, dy = (torch.randn(rows, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(4))
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    dsum, dscale = ops.fused_add_rmsnorm_bwd(dh, dy, x, r, sc)
    wsum, wscale = fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, r, sc)
    torch.cuda.synchronize()
    pl = rn.plan(x, r, sc, dh, dy, warp_vals=fused_mod.BWD_WARP_VALS)
    bp = fused_mod.bwd_plan(rows, d, x.element_size(), pl, _sms())
    stream = torch.cuda.current_stream()
    if fused_mod._counter(stream.device, stream).any():
        raise AssertionError(f"fused_add_rmsnorm_bwd {label}: left its "
                             "ticket counters set")
    err = max(check_close(f"fused_add_rmsnorm_bwd {label} dsum", dsum, wsum,
                          dtype),
              check_max(f"fused_add_rmsnorm_bwd {label} dscale", dscale,
                        wscale, BWD_TOL[dtype]))
    again = fused_mod.fused_add_rmsnorm_bwd_cuda(dh, dy, x, r, sc)
    if not (torch.equal(again[0], dsum) and torch.equal(again[1], dscale)):
        raise AssertionError(f"fused_add_rmsnorm_bwd {label}: two runs "
                             "differ")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=bp._asdict(), blocks=bp.blocks, max_abs_err=err)
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (5 * rows * d + 2 * d), 12.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: fused_mod.fused_add_rmsnorm_bwd_cuda(
            dh, dy, x, r, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(
            lambda: fused_mod.fused_add_rmsnorm_bwd_plain(dh, dy, x, r, sc))
        row["library_ms"] = None    # no single PyTorch call computes it
    log(f"[kernels] fused_add_rmsnorm_bwd {json.dumps(row)}")
    return row


def decode_case(gen, label, b, s, h, kh, d, n, dtype, timed=False,
                n_splits=None):
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    n_dev = torch.tensor(n, dtype=torch.int32, device="cuda")
    got = ops.flash_attention_decode(q, k, v, cache_len=n_dev,
                                     n_splits=n_splits)
    want = fa.flash_attention_decode_plain(q, k, v, cache_len=n,
                                           n_splits=n_splits)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention_decode {label}", got, want, dtype)
    if n == 0 and got.float().abs().max().item() != 0.0:
        raise AssertionError("flash_attention_decode: cache_len 0 must "
                             "give zeros")
    ns, _, nh = fa.decode_plan(b, s, h, kh, n_splits)
    row = dict(label=label, shape=[b, s, h, kh, d], cache_len=n,
               dtype=_dname(dtype), n_splits=ns,
               blocks=b * kh * -(-(h // kh) // nh) * ns, max_abs_err=err)
    if timed:
        es = q.element_size()
        nv = min(n, s)
        nbytes = es * (2 * b * h * d + 2 * b * nv * kh * d)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 4.0 * b * h * nv * d, dtype)
        row["ms"] = time_ms(lambda: fa.flash_attention_decode_cuda(
            q, k, v, cache_len=n_dev, n_splits=n_splits))
        row["gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_decode_plain(
            q, k, v, cache_len=n_dev, n_splits=n_splits), iters=3)
        qt = q.transpose(1, 2)
        kt, vt = k[:, :nv].transpose(1, 2), v[:, :nv].transpose(1, 2)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True))
    log(f"[kernels] flash_attention_decode {json.dumps(row)}")
    return row


def rmsnorm_case(gen, label, rows, d, dtype, timed=False, offset=0,
                 want_vector=None):
    """``offset`` elements into a flat buffer: an offset that is not a
    whole 16 bytes takes the scalar instantiation."""
    flat = torch.randn(rows * d + offset, generator=gen,
                       device="cuda").to(dtype)
    x = flat[offset:].view(rows, d)
    sc = torch.randn(d, generator=gen, device="cuda").to(dtype)
    got = ops.rmsnorm(x, sc)
    want = rn.rmsnorm_plain(x, sc)
    torch.cuda.synchronize()
    err = check_close(f"rmsnorm {label}", got, want, dtype)
    plan = rn.LAST_PLAN
    if plan != rn.plan(x, sc) or (want_vector is not None
                                  and plan.vector != want_vector):
        raise AssertionError(f"rmsnorm {label}: ran {plan}, expected "
                             f"{rn.plan(x, sc)} (16-byte loads: "
                             f"{want_vector})")
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               plan=plan._asdict(), max_abs_err=err)
    if timed:
        es = x.element_size()
        row["bound_ms"], row["bound_by"] = bound(
            es * (2 * rows * d + d), 4.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: rn.rmsnorm_cuda(x, sc))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: rn.rmsnorm_plain(x, sc))
        row["library_ms"] = time_ms(lambda: F.rms_norm(x, (d,), sc, 1e-5))
    log(f"[kernels] rmsnorm {json.dumps(row)}")
    return row


def add_case(gen, label, rows, d, dtype, timed=False):
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    r = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    got = ops.add(x, r)
    want = add_mod.add_plain(x, r)
    torch.cuda.synchronize()
    err = check_close(f"add {label}", got, want, dtype)
    row = dict(label=label, shape=[rows, d], dtype=_dname(dtype),
               max_abs_err=err)
    if timed:
        row["bound_ms"], row["bound_by"] = bound(
            x.element_size() * 3 * rows * d, 1.0 * rows * d, dtype)
        row["ms"] = time_ms(lambda: add_mod.add_cuda(x, r))
        row["plain_ms"] = time_ms(lambda: add_mod.add_plain(x, r))
        row["library_ms"] = time_ms(lambda: torch.add(x, r))
    log(f"[kernels] add {json.dumps(row)}")
    return row


def ssd_case(gen, label, b, s, h, p, n, dtype, chunk=None, timed=False):
    """The kernel (four passes) against ``ssd_scan_passes_plain``; timed,
    also each pass alone (``passes_ms``), on buffers of its own."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dt = 0.001 + 0.099 * torch.rand(b, s, h, generator=gen, device="cuda")
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device="cuda"))
    bb = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    cc = (0.5 * torch.randn(b, s, n, generator=gen, device="cuda")).to(dtype)
    ck = chunk or ssd_mod.CHUNK
    y, st = ops.ssd_scan(x, dt, a, bb, cc, chunk=ck)
    wy, wst = ssd_mod.ssd_scan_passes_plain(x, dt, a, bb, cc, chunk=ck)
    torch.cuda.synchronize()
    ytol, stol = SSD_TOL[dtype]
    err = max(check_close(f"ssd_scan {label} y", y, wy, dtype, ytol),
              check_close(f"ssd_scan {label} state", st, wst, dtype, stol))
    row = dict(label=label, shape=[b, s, h, p, n], chunk=ck,
               dtype=_dname(dtype), max_abs_err=err)
    if timed:
        es = x.element_size()
        nbytes = (2 * es * b * s * h * p + 4 * b * s * h + 4 * h
                  + 2 * es * b * s * n + 4 * b * h * p * n)
        flops, _ = kernel_costs.op_flops_bytes(
            "ssd_scan", (b, s, h, p, n), _dname(dtype))
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dtype)
        row["ms"] = time_ms(lambda: ssd_mod.ssd_scan_cuda(
            x, dt, a, bb, cc, chunk=ck))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: ssd_mod.ssd_scan_passes_plain(
            x, dt, a, bb, cc, chunk=ck))
        row["sequential_plain_ms"] = time_ms(lambda: ssd_mod.ssd_scan_plain(
            x, dt, a, bb, cc, chunk=ck))
        row["library_ms"] = None    # no PyTorch call computes the scan
        bufs = ssd_mod.ssd_buffers(x, bb, chunk=ck)
        row["passes_ms"] = {
            name: time_ms(lambda w=name: ssd_mod.ssd_run_cuda(
                x, dt, a, bb, cc, bufs, chunk=ck, which=w))
            for name in ("cb", "chunk_state", "state_pass", "chunk_scan")}
    log(f"[kernels] ssd_scan {json.dumps(row)}")
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
    """Every kernel against its plain version at the shapes of the main
    paths that run it (serve, calibrate, fused) and at the edge cases;
    returns, per kernel, the timed case, at a shape of the path whose
    launches the kernel line reports."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config(ARCH)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    # the serve shape, timed for the wgmma kernel and for the CUDA-core
    # kernel on the same bf16 inputs (the kernel line's "earlier_ms")
    attn = [attention_case(gen, "prefill_s512", BATCH, 512, 512, h, kh, d,
                           True, bf16, timed=True)]
    gen_again = torch.Generator(device="cuda").manual_seed(0)
    attn.append(attention_case(gen_again, "prefill_s512_cuda_core", BATCH,
                               512, 512, h, kh, d, True, bf16, timed=True,
                               impl="cuda_core"))
    for s in sorted(set(main_lens)):          # the serve phase's own shapes
        attn.append(attention_case(gen, f"serve_s{s}", BATCH, s, s, h, kh, d,
                                   True, bf16))
    attn += [
        attention_case(gen, "ragged_s509", BATCH, 509, 509, h, kh, d, True,
                       bf16),
        attention_case(gen, "block_q64", BATCH, 509, 509, h, kh, d, True,
                       bf16, block_q=64),
        attention_case(gen, "block_q16_f32", 2, 509, 509, h, kh, d, True,
                       f32, block_q=16),
        attention_case(gen, "noncausal_130x70", 2, 130, 70, h, kh, d, False,
                       bf16),
        attention_case(gen, "d128_f32", 2, 256, 256, 4, 2, 128, True, f32),
        attention_case(gen, "d128", 2, 256, 256, 4, 2, 128, True, bf16),
        attention_case(gen, "d80", 2, 200, 200, 6, 2, 80, True, bf16),
        attention_case(gen, "d48_noncausal", 2, 130, 70, 6, 2, 48, False,
                       bf16),
        attention_case(gen, "d112", 2, 200, 200, 6, 2, 112, True, bf16,
                       block_q=64),
        attention_case(gen, "noncausal_257x300_f32", 2, 257, 300, 4, 2, 64,
                       False, f32),
        attention_case(gen, "d16_reduced", 2, 77, 77, 4, 2, 16, True, bf16),
        attention_case(gen, "d32_f32", 2, 150, 150, 4, 2, 32, False, f32),
    ]
    # the calibrate path's attention: q (1, s, 120, 64), one KV head a head;
    # bf16 timed beside the CUDA-core kernel on the same inputs
    bh = CAL_GRID["attn_shapes"][-1][0]
    cal_row = attention_case(gen, "calibrate_s2048_bfloat16", 1, 2048, 2048,
                             bh, bh, d, True, bf16, timed=True)
    gen_again = torch.Generator(device="cuda").manual_seed(1)
    cal = attention_case(gen_again, "calibrate_s2048_bfloat16_cuda_core", 1,
                         2048, 2048, bh, bh, d, True, bf16, timed=True,
                         impl="cuda_core")
    attn += [cal_row, cal,
             attention_case(gen, "calibrate_s2048_float32", 1, 2048, 2048,
                            bh, bh, d, True, f32, timed=True)]
    serve_row = attn[0]
    serve_row["earlier_ms"] = attn[1]["ms"]
    serve_row["calibrate"] = {key: cal_row[key] for key in (
        "shape", "ms", "bound_ms", "bound_by", "share_of_bound", "tflops",
        "library_ms", "max_abs_err")}
    serve_row["calibrate"]["earlier_ms"] = cal["ms"]
    serve_row["calibrate_f32"] = {key: attn[-1][key] for key in (
        "shape", "kernel", "ms", "bound_ms", "bound_by", "share_of_bound",
        "tflops", "plain_ms", "library_ms", "max_abs_err")}
    for row, old in ((serve_row, attn[1]), (cal_row, cal)):
        if not row["ms"] * 4 <= old["ms"]:
            raise AssertionError(
                f"flash_attention {row['label']}: the wgmma kernel "
                f"({row['ms']:.4f} ms) is not 4x the CUDA-core kernel "
                f"({old['ms']:.4f} ms) on the same inputs")
    dm = cfg.d_model
    norm = [fused_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True,
                       want_vector=True),
            fused_case(gen, "rows16384", 16384, dm, bf16, timed=True)]
    for s in sorted(set(main_lens)):
        norm.append(fused_case(gen, f"serve_rows{BATCH * s}", BATCH * s, dm,
                               bf16))
    norm += [fused_case(gen, "ragged_rows4071", 4071, dm, bf16),
             fused_case(gen, "f32_rows1000", 1000, dm, f32),
             fused_case(gen, "f32_4096x512", 4096, 512, f32),
             fused_case(gen, "d2048", 64, 2048, bf16),
             fused_case(gen, "d8192", 64, 8192, bf16),
             fused_case(gen, "d8192_f32", 33, 8192, f32),
             fused_case(gen, "d1001_scalar", 16, 1001, bf16,
                        want_vector=False),
             fused_case(gen, "offset_2B_x_scalar", 300, dm, bf16,
                        offset=("x", 1), want_vector=False),
             fused_case(gen, "offset_2B_res_scalar", 300, dm, bf16,
                        offset=("res", 1), want_vector=False),
             fused_case(gen, "offset_16B_res", 300, dm, bf16,
                        offset=("res", 8), want_vector=True)]
    norm[0]["rows16384"] = {key: norm[1][key] for key in (
        "shape", "plan", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "max_abs_err")}
    # decode on the calibrate path: q (1, 1, 120, 64) against a (1, sk, 120,
    # 64) cache (one KV head a head), at the grid's and held-out lengths;
    # the timed case is the grid's longest cache
    dec = [decode_case(gen, "calibrate_sk4096", 1, 4096, bh, bh, d, 4096,
                       bf16, timed=True),
           decode_case(gen, "calibrate_sk4096_f32", 1, 4096, bh, bh, d,
                       4096, f32, timed=True)]
    dec[0]["f32"] = {key: dec[1][key] for key in (
        "shape", "n_splits", "ms", "bound_ms", "bound_by", "share_of_bound",
        "gb_s", "plain_ms", "library_ms", "max_abs_err")}
    dec += [decode_case(gen, f"calibrate_sk{sk}_{_dname(dt)}", 1, sk, bh, bh,
                        d, sk, dt)
            for sk in (256, 549, 1024, 2048) for dt in (bf16, f32)]
    # the serve phase's decode shape: 8 rows, a 549-slot cache, GQA 15/5
    smax = PROMPT_MAX + MAX_NEW + 8
    # (the full cache is timed too, for PERF.md; the kernel line stays the
    # calibrate case above)
    dec += [decode_case(gen, f"serve_len{n}", BATCH, smax, h, kh, d, n, bf16,
                        timed=n == smax)
            for n in (0, 1, 300, smax)]
    dec += [decode_case(gen, "f32", BATCH, smax, h, kh, d, 300, f32),
            decode_case(gen, "d128", 2, 300, 4, 2, 128, 137, bf16),
            decode_case(gen, "d16_mqa", 2, 130, 15, 1, 16, 77, f32)]
    # forced split counts: one split (the split kernel writes the output, no
    # merge) and one tile a split (the maximum), with lengths that leave the
    # last splits empty; the two calibrate-shape cases are timed beside the
    # helper's own count
    tiles4096, tiles_serve = 4096 // fa.BLOCK_K, -(-smax // fa.BLOCK_K)
    dec += [decode_case(gen, "calibrate_sk4096_splits1", 1, 4096, bh, bh, d,
                        4096, bf16, timed=True, n_splits=1),
            decode_case(gen, "calibrate_sk4096_splits64", 1, 4096, bh, bh, d,
                        4096, bf16, timed=True, n_splits=tiles4096),
            decode_case(gen, "calibrate_len2000_splits64_f32", 1, 4096, bh,
                        bh, d, 2000, f32, n_splits=tiles4096),
            decode_case(gen, "serve_len300_splits1", BATCH, smax, h, kh, d,
                        300, bf16, n_splits=1),
            decode_case(gen, f"serve_len100_splits{tiles_serve}", BATCH, smax,
                        h, kh, d, 100, bf16, n_splits=tiles_serve),
            decode_case(gen, "serve_len0_splits1", BATCH, smax, h, kh, d, 0,
                        bf16, n_splits=1),
            decode_case(gen, "d16_mqa_splits1_f32", 2, 130, 15, 1, 16, 77,
                        f32, n_splits=1),
            decode_case(gen, "d16_mqa_splits3_f32", 2, 130, 15, 1, 16, 60,
                        f32, n_splits=3)]
    rms = [rmsnorm_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True,
                        want_vector=True),
           rmsnorm_case(gen, "rows16384", 16384, dm, bf16, timed=True),
           rmsnorm_case(gen, "rows16384_f32", 16384, dm, f32),
           rmsnorm_case(gen, "rows8", 8, dm, bf16),
           rmsnorm_case(gen, "ragged_rows4071", 4071, dm, bf16),
           rmsnorm_case(gen, "f32_rows1000", 1000, dm, f32),
           rmsnorm_case(gen, "d8192", 64, 8192, bf16),
           rmsnorm_case(gen, "d8192_f32", 33, 8192, f32),
           rmsnorm_case(gen, "d1000", 16, 1000, bf16),
           rmsnorm_case(gen, "d1001_scalar", 16, 1001, bf16,
                        want_vector=False),
           rmsnorm_case(gen, "offset_2B_scalar", 300, dm, bf16, offset=1,
                        want_vector=False)]
    rms[0]["rows16384"] = {key: rms[1][key] for key in (
        "shape", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "library_ms", "max_abs_err")}
    # SSD at mamba2-130m's geometry (H=24, P=64, N=128): the calibrate
    # grid's (4, 2048) and (1, 512), the held-out (2, 1024), and batch 1
    ssd = [ssd_case(gen, "calibrate_b4_s2048", 4, 2048, 24, 64, 128, bf16,
                    timed=True),
           ssd_case(gen, "calibrate_b1_s512", 1, 512, 24, 64, 128, f32),
           ssd_case(gen, "held_out_b2_s1024", 2, 1024, 24, 64, 128, bf16),
           ssd_case(gen, "mamba2_130m_f32", 1, 2048, 24, 64, 128, f32),
           ssd_case(gen, "ragged_s200", 1, 200, 24, 64, 128, bf16),
           ssd_case(gen, "sweep_2x256x3", 2, 256, 3, 64, 64, f32, chunk=64),
           ssd_case(gen, "chunk77_p40", 1, 200, 2, 40, 16, bf16, chunk=77),
           ssd_case(gen, "chunk77_p40_f32", 1, 200, 2, 40, 16, f32,
                    chunk=77),
           ssd_case(gen, "chunk77", 2, 256, 3, 64, 64, bf16, chunk=77),
           ssd_case(gen, "chunk32", 1, 128, 2, 32, 16, bf16, chunk=32)]
    # mamba2-130m at batch 1 and the fp32 calibrate point, timed for PERF.md
    for extra in (ssd_case(gen, "mamba2_130m_timed", 1, 2048, 24, 64, 128,
                           bf16, timed=True),
                  ssd_case(gen, "calibrate_b4_s2048_f32_timed", 4, 2048, 24,
                           64, 128, f32, timed=True)):
        ssd[0].setdefault("more", []).append({key: extra[key] for key in (
            "label", "shape", "dtype", "ms", "bound_ms", "share_of_bound",
            "plain_ms", "passes_ms")})
    adds = [add_case(gen, "rows4096", BATCH * 512, dm, bf16, timed=True),
            add_case(gen, "f32_4096x512", 4096, 512, f32)]
    # the backward kernels at the train path's shapes (micro batch 4 x 1024
    # tokens: attention (4, 1024, 15/5, 64) causal, the norm 4096 x 960)
    mb, sl = (TRAIN_DATA["global_batch"] // TRAIN_DATA["num_microbatches"],
              TRAIN_DATA["seq_len"])
    abwd = [attention_bwd_case(gen, "train_s1024", mb, sl, sl, h, kh, d,
                               True, bf16, timed=True),
            attention_bwd_case(gen, "train_s1024_f32", mb, sl, sl, h, kh, d,
                               True, f32, timed=True),
            attention_bwd_case(gen, "train_s1024_cuda_core", mb, sl, sl, h,
                               kh, d, True, bf16, impl="cuda_core"),
            attention_bwd_case(gen, "noncausal_s1000", 2, 1000, 1000, h, kh,
                               d, False, bf16),
            attention_bwd_case(gen, "noncausal_s1000_f32", 2, 1000, 1000, h,
                               kh, d, False, f32),
            attention_bwd_case(gen, "noncausal_s1000_cuda_core", 2, 1000,
                               1000, h, kh, d, False, bf16,
                               impl="cuda_core"),
            attention_bwd_case(gen, "d16_reduced", 2, 77, 77, 4, 2, 16, True,
                               bf16),
            attention_bwd_case(gen, "d16_f32", 2, 77, 77, 4, 2, 16, True,
                               f32),
            # the rest of the GPU tests' shapes: head dim 128, and unequal
            # lengths, where the dK/dV kernel's transposed mask shows
            attention_bwd_case(gen, "d128_s1000", 1, 1000, 1000, 4, 2, 128,
                               True, bf16),
            attention_bwd_case(gen, "d128_s200", 1, 200, 200, 6, 2, 128,
                               True, bf16),
            attention_bwd_case(gen, "sq130_sk70_d48", 2, 130, 70, 4, 2, 48,
                               False, bf16),
            attention_bwd_case(gen, "sq70_sk130_d32", 1, 70, 130, 4, 4, 32,
                               True, bf16)]
    abwd[0]["f32"] = {key: abwd[1][key] for key in (
        "ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms",
        "library_ms", "max_abs_err")}
    nbwd = [fused_bwd_case(gen, "train_rows4096", mb * sl, dm, bf16,
                           timed=True),
            fused_bwd_case(gen, "rows16384", 16384, dm, bf16, timed=True),
            fused_bwd_case(gen, "rows4096_f32", mb * sl, dm, f32),
            fused_bwd_case(gen, "rows16384_f32", 16384, dm, f32),
            fused_bwd_case(gen, "d1001_scalar", 37, 1001, bf16),
            fused_bwd_case(gen, "d1001_f32", 37, 1001, f32),
            fused_bwd_case(gen, "d8192", 64, 8192, bf16),
            fused_bwd_case(gen, "d8192_f32", 33, 8192, f32),
            fused_bwd_case(gen, "rows1", 1, dm, bf16),
            fused_bwd_case(gen, "rows7", 7, dm, bf16)]
    nbwd[0]["rows16384"] = {key: nbwd[1][key] for key in (
        "shape", "plan", "ms", "bound_ms", "share_of_bound", "plain_ms",
        "max_abs_err")}
    return {"flash_attention": attn[0], "fused_add_rmsnorm": norm[0],
            "flash_attention_decode": dec[0], "rmsnorm": rms[0],
            "ssd_scan": ssd[0], "add": adds[0],
            "flash_attention_bwd": abwd[0], "fused_add_rmsnorm_bwd": nbwd[0]}


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


def phase_reduced() -> None:
    """The reduced smollm config as it is (head_dim 16, attn_impl "auto"):
    one prefill through the attention kernel on the card."""
    cfg = get_config(ARCH).reduced()
    if cfg.hd != 16 or cfg.attn_impl != "auto":
        raise AssertionError(f"reduced {ARCH}: head_dim {cfg.hd}, "
                             f"attn_impl {cfg.attn_impl!r}")
    params = model_lib.init(cfg, 2, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 100))).cuda()
    ops.reset_launches()
    got = model_lib.forward(cfg, params, {"tokens": toks})
    launched = ops.LAUNCHES["flash_attention"]
    want = model_lib.forward(cfg, params, {"tokens": toks},
                             attn_impl="naive")
    err = (got - want).abs().max().item()
    if launched != cfg.n_layers or not err <= SMALL_FP32_TOL:
        raise AssertionError(f"reduced model (head_dim 16): {launched} "
                             f"attention launches, max |dlogit| {err:.3e}")
    log(f"[reduced] {cfg.name}, head_dim {cfg.hd}, attn_impl auto: "
        f"{launched} attention kernel launches, kernel vs plain path max "
        f"|dlogit| {err:.3e} (tol {SMALL_FP32_TOL})")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention kernel"
    if "bwd_dkdv" in name or "bwd_dq" in name:
        return "flash_attention_bwd kernel"
    if "fused_add_rmsnorm_bwd" in name:
        return "fused_add_rmsnorm_bwd kernel"
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
    counts: dict = {}     # kernels by group
    names: dict = {}
    ported: dict = {}     # the port's own kernels by entry function
    n_kernels = 0
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            ms = ev.get("dur", 0.0) / 1e3 / per
            g = _kernel_group(ev.get("name", ""))
            groups[g] = groups.get(g, 0.0) + ms
            counts[g] = counts.get(g, 0) + 1 / per
            short = ev.get("name", "")[:60]
            names[short] = names.get(short, 0.0) + ms
            if g.endswith(" kernel"):
                fn = re.sub(r"^.*?(\w+)(<|\().*$", r"\1", ev.get("name", ""))
                ported[fn] = ported.get(fn, 0.0) + ms
            n_kernels += 1
    if not n_kernels:
        log(f"[profile] {label}: the trace holds no device kernels; "
            "device time not measured")
        return None
    device_ms = sum(groups.values())
    log(f"[profile] {label} (per {'step' if per > 1 else 'call'}): "
        + json.dumps(dict(
            wall_ms=wall_ms / per, device_ms=device_ms,
            busy=device_ms / (wall_ms / per), kernels=n_kernels / per,
            by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            kernels_by_group=dict(sorted(counts.items(),
                                         key=lambda kv: -kv[1])),
            port_kernels=dict(sorted(ported.items(), key=lambda kv: -kv[1])),
            top=sorted(names.items(), key=lambda kv: -kv[1])[:5])))
    return device_ms


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
        want = cfg.n_layers * n_prefill if name in SERVE_KERNELS else 0
        if n != want:
            raise AssertionError(
                f"{name}: {n} launches in the serve run, expected {want} "
                f"({cfg.n_layers} per prefill x {n_prefill} prefills for "
                f"{', '.join(SERVE_KERNELS)}, none for the others)")
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
        dev_prefill = profile_window(
            "prefill", lambda: server._prefill(params, batch), prefill_ms, 1)
        dev_decode = profile_window("decode", lambda: decode_steps(8),
                                    decode_ms * 8, 8)
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
    return launches, dict(prefill_len=plen, prefill_device_ms=dev_prefill,
                          decode_device_ms=dev_decode)


def _path_launches(label: str, names) -> dict:
    launches = dict(ops.LAUNCHES)
    missing = [n for n in names if not launches[n]]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing} on the path "
                             f"({json.dumps(launches)})")
    log(f"[{label}] launches on the path: {json.dumps(launches)}")
    return launches


def phase_calibrate(serve_dev: dict) -> dict:
    """Kernel calibration at full width, the table's held-out accuracy,
    and what it does to the analytic price of a smollm-360M layer."""
    cfg = get_config(ARCH)
    path = os.path.join(ROOT, "build", "kernel-costs-H100.json")
    ops.reset_launches()
    t0 = time.perf_counter()
    cal = measured.calibrate_kernels("H100", dtypes=("bfloat16", "float32"),
                                     iters=10, path=path, **CAL_GRID)
    t_cal = time.perf_counter() - t0
    acc = kernels_bench.cost_table_accuracy(
        cal.table, HELD_OUT, dtypes=("bfloat16", "float32"), iters=10)
    launches = _path_launches("calibrate", CALIBRATE_KERNELS)
    log(f"[calibrate] {cal.table.n_points()} points in {t_cal:.1f}s -> "
        f"{path}")
    for r in cal.points:
        log(f"[calibrate] {json.dumps(r)}")
    for dtype, res in acc.items():
        for r in res["rows"]:
            log(f"[accuracy] {dtype} {json.dumps(r)}")
        log(f"[accuracy] {dtype} " + json.dumps(
            {k: v for k, v in res.items() if k != "rows"}))

    table = cal.table
    train = JobProfile(TrainJob(cfg, seq_len=512, global_batch=8))
    like = JobProfile(TrainJob(cfg, seq_len=serve_dev["prefill_len"],
                               global_batch=BATCH))
    serve = JobProfile(ServeJob(cfg, prompt_len=512, decode_batch=BATCH))
    smax = PROMPT_MAX + MAX_NEW + 8

    def prices():
        return dict(
            prefill_block_ms_s512=train.cost("block", "H100", 1, 8).fwd * 1e3,
            prefill_block_ms_serve=like.cost("block", "H100", 1, BATCH).fwd
            * 1e3,
            decode_block_ms=serve.decode_cost("block", "H100", 1, BATCH,
                                              smax) * 1e3)
    kernel_costs.clear_kernel_tables()
    roofline = prices()
    kernel_costs.register_kernel_table(table)
    with_table = prices()
    per_layer = {k: (v / cfg.n_layers if v is not None else None)
                 for k, v in (("prefill", serve_dev["prefill_device_ms"]),
                              ("decode", serve_dev["decode_device_ms"]))}
    log("[analytic] one smollm-360M block on 'H100' (ms): " + json.dumps(dict(
        roofline=roofline, with_table=with_table,
        serve_device_ms_per_layer=dict(
            prefill=per_layer["prefill"], decode=per_layer["decode"],
            prefill_batch=[BATCH, serve_dev["prefill_len"]],
            decode_batch=BATCH, decode_cache=smax))))
    kernel_costs.clear_kernel_tables()
    return launches


def phase_fused() -> dict:
    """The reference's fused-vs-unfused benchmark, on the port's kernels."""
    ops.reset_launches()
    out = {}
    for rows, d, dtype in ((4096, 512, "float32"), (4096, 960, "bfloat16")):
        res = kernels_bench.fused_vs_unfused(rows, d, dtype, iters=20)
        out[f"{rows}x{d}_{dtype}"] = res
        log(f"[fused] {rows}x{d} {dtype}: {json.dumps(res)}")
    return _path_launches("fused", FUSED_KERNELS)


def _flat_grads(cfg, params, mb):
    """Loss and fp32 gradient leaves of one microbatch (``loss_and_grads``
    over a batch of one microbatch)."""
    batch = {k: v[None] for k, v in mb.items()}
    loss, grads = train_lib.loss_and_grads(cfg, params, batch)
    return loss.item(), dict(opt_lib.tree_leaves(grads))


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two gradient leaves, summed in float64 (an fp32 sum over
    millions of elements is itself off in the fourth digit)."""
    return F.cosine_similarity(a.double().flatten(), b.double().flatten(),
                               dim=0).item()


def _grad_agreement(label, cfg, params, mb, tol, cosine=None):
    """One microbatch through the kernel path and the plain path
    (``attn_impl="naive"``: naive attention and the unfused norm seam):
    the losses and every gradient leaf, errors printed.  A bf16 model is
    also run as fp32 on the plain path, and each bf16 path's cosine to
    those gradients is printed (``cos_fp32``, ``plain_cos_fp32``): it says
    which path the kernel-vs-plain difference comes from."""
    kl, kg = _flat_grads(cfg, params, mb)
    pl, pg = _flat_grads(dataclasses.replace(cfg, attn_impl="naive"),
                         params, mb)
    ref = None
    if cfg.dtype != "float32":
        f32 = dataclasses.replace(cfg, attn_impl="naive", dtype="float32",
                                  param_dtype="float32")
        up = opt_lib.tree_unflatten(
            (k, p.float()) for k, p in opt_lib.tree_leaves(params))
        ref = _flat_grads(f32, up, mb)[1]
        del up
    worst, rows = 0.0, {}
    for name in kg:
        g, w = kg[name], pg[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"[train] {label}: non-finite grad {name}")
        rel = ((g - w).abs().max() / w.abs().max()).item()
        cos = _cosine(g, w)
        rows[name] = dict(rel=rel, cos=cos)
        if ref is not None:
            rows[name].update(cos_fp32=_cosine(g, ref[name]),
                              plain_cos_fp32=_cosine(w, ref[name]))
        worst = max(worst, rel)
        if not rel <= tol or (cosine is not None and not cos >= cosine):
            raise AssertionError(
                f"[train] {label}: grad {name} kernel vs plain path max "
                f"|dg| / max|g| {rel:.3e} (tol {tol}), cosine {cos:.6f}"
                f" (min {cosine})")
    if not abs(kl - pl) <= TRAIN_LOSS_TOL * abs(pl):
        raise AssertionError(f"[train] {label}: loss {kl} vs plain {pl}")
    log(f"[train] {label}: kernel vs plain path: " + json.dumps(dict(
        loss=kl, plain_loss=pl, max_rel_grad_err=worst,
        min_cosine=min(r["cos"] for r in rows.values()), tol=tol,
        cosine_min=cosine, leaves=rows)))
    return worst


def phase_train():
    """smollm-360M, 32 layers, bf16, ``remat="full"``: training steps
    through ``make_train_step``, a main path for the two forward kernels
    and both backward kernels."""
    cfg = dataclasses.replace(get_config(ARCH), remat="full")
    dc = data_lib.DataConfig(**TRAIN_DATA)
    ds = data_lib.SyntheticDataset(cfg, dc)
    batches = [ds.batch(i) for i in range(1 + TRAIN_TIMED + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init(cfg, 0, device="cuda")
    state = opt_lib.init_state(params)
    step = train_lib.make_train_step(cfg, opt_lib.OptimizerConfig(
        **TRAIN_OPT))
    ops.reset_launches()
    # (a) one repeated batch: the loss must fall
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, m = step(params, state, batches[0])
        losses.append(m["loss"].item())
    first_s = time.perf_counter() - t0
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] losses {losses}: not finite, or the "
                             "last is not below the first")
    # (b) fresh batches, timed: CUDA events around each step, host clock
    dev_ms, wall_ms, timed_losses = [], [], []
    for i in range(TRAIN_TIMED):
        b = batches[1 + i]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, state, m = step(params, state, b)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        timed_losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated()
    # (c) launches over (a) and (b), per step
    launches = dict(ops.LAUNCHES)
    n_steps = TRAIN_STEPS + TRAIN_TIMED
    per_step = cfg.n_layers * dc.num_microbatches
    want = {name: 0 for name in launches}
    want.update(flash_attention=2 * per_step, fused_add_rmsnorm=2 * per_step,
                flash_attention_bwd=per_step, fused_add_rmsnorm_bwd=per_step)
    for name, n in launches.items():
        if n != want[name] * n_steps:
            raise AssertionError(
                f"[train] {name}: {n} launches in {n_steps} steps, expected "
                f"{want[name]} a step ({cfg.n_layers} layers x "
                f"{dc.num_microbatches} microbatches; the forward kernels "
                f"run again under remat)")
    log(f"[train] launches in {n_steps} steps: {json.dumps(launches)} "
        f"(per step {json.dumps({k: v for k, v in want.items() if v})})")
    tokens = dc.global_batch * dc.seq_len
    stats = dict(
        arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, remat=cfg.remat,
        data=TRAIN_DATA, opt=TRAIN_OPT, losses=losses,
        timed_losses=timed_losses, first_steps_s=first_s,
        step_device_ms=statistics.median(dev_ms), step_device_ms_all=dev_ms,
        step_wall_ms=statistics.median(wall_ms), step_wall_ms_all=wall_ms,
        tokens_per_step=tokens,
        tokens_per_s=tokens / (statistics.median(wall_ms) / 1e3),
        peak_mem_gib=peak / 2**30)
    log(f"[train] {json.dumps(stats)}")
    profile_window("train_step", lambda: step(params, state, batches[-1]),
                   statistics.median(wall_ms), 1)
    # (d) kernel path vs plain path on one microbatch, on the card
    mb = {k: v[0] for k, v in batches[0].items()}
    _grad_agreement(f"{cfg.name} bf16, {cfg.n_layers} layers", cfg, params,
                    mb,
                    TRAIN_GRAD_TOL, TRAIN_COSINE)
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param_dtype="float32")
    _grad_agreement(f"{cfg.name} widths fp32, 2 layers", small,
                    model_lib.init(small, 1, device="cuda"), mb,
                    SMALL_FP32_TOL)
    return launches


def main() -> int:
    smi = phase_card()
    phase_build()
    cfg = get_config(ARCH)
    reqs = serve_requests(cfg, 0, N_REQUESTS)
    warm = serve_requests(cfg, 1, BATCH)
    rows = phase_kernels(batch_lengths(reqs))
    phase_small_reference()
    phase_reduced()
    serve_launches, serve_dev = phase_serve(reqs, warm)
    cal_launches = phase_calibrate(serve_dev)
    fused_launches = phase_fused()
    train_launches = phase_train()
    # launches: each kernel's count on the main path that runs it, which
    # also runs the timed case's shape
    path_of = {"flash_attention": "serve", "fused_add_rmsnorm": "serve",
               "flash_attention_decode": "calibrate", "rmsnorm": "calibrate",
               "ssd_scan": "calibrate", "add": "fused",
               "flash_attention_bwd": "train",
               "fused_add_rmsnorm_bwd": "train"}
    counts = {"serve": serve_launches, "calibrate": cal_launches,
              "fused": fused_launches, "train": train_launches}
    kernels = []
    for name, row in rows.items():
        kernels.append(dict(
            name=name, route="cuda", **SOURCES[name], path=path_of[name],
            launches=counts[path_of[name]][name],
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"],
            **{key: row[key] for key in ("share_of_bound", "tflops",
                                         "earlier_ms", "calibrate",
                                         "passes_ms", "sequential_plain_ms",
                                         "blocks_ms",
                                         "calibrate_f32", "rows16384",
                                         "more", "plan", "f32", "blocks")
               if key in row}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
