"""Where the fused add + RMSNorm backward's time goes, at the train path's
shapes.

    python3 -m repro_torch.bench.fused_bwd_plans     # from src/, on a GPU

For 4096 and 16384 x 960 bf16 it launches the backward once per setting
of ``fused.bwd_plan``'s module constants (``SETTINGS``: ring stages; rows
a step; two blocks an SM), holds each against the plain version (dsum at
2e-2, dscale at 2e-2 of its max |value|) and times it with
``autotune.bench_time`` (cold L2, median of 20): ``ms``.  Then, at the
default settings (``VARIANT_SETTINGS`` aside), variants of
``csrc/fused_add_rmsnorm_bwd.cu`` with one piece changed by a text
substitution (anchors checked), built into ``build/fused_bwd_ablations/``
and run in the wrapper's place (``variants_ms``).  Those in ``EXACT``
keep the result and are held against the plain version like the
settings: register loads in place of bulk copies (``kBulk``); dscale's
sum across blocks in strict block order, by one block, or both; other
group and reducer counts (``kGroupBlocks``, ``kReducers``); 16 partial
rows in flight instead of 8.  The rest compute wrong values on purpose
and are only timed: an empty kernel (launch and timer), the copies
alone, no dsum stores, no fold and no sum across blocks, no sum across
blocks, x/res/dh held in registers between the passes, registers capped
for two blocks an SM.  The ``timeline*`` variants are run once and print
SM clocks (``clock64``, cycles from the block's start): warp 0's events
in blocks 0, 64, the last and every reducer (each stage landed, each
step done, partial row written, ticket drawn, exit); every warp's in
block 0; and the inside of reducer 0's sums.  One JSON line a shape: the
card, the byte bound, the plans and the times.

    python3 src/repro_torch/bench/fused_bwd_plans.py --default-only

times only the wrapper's own launch (``fused_add_rmsnorm_bwd_cuda`` as the
train path calls it), with whatever ``repro_torch`` ``PYTHONPATH`` finds
first: run it with an older tree's ``src`` to time that tree's kernel on
the same card in the same call.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fused as fused_mod

SHAPES = ((4096, 960), (16384, 960))
TOL = 2e-2                       # bf16: dsum elementwise, dscale of its max
HBM_BYTES_S = 3.35e12            # H100 SXM device memory rate
SETTINGS = {
    "base": {},
    "stages1": dict(BWD_STAGES=1), "stages2": dict(BWD_STAGES=2),
    "stages3": dict(BWD_STAGES=3),
    "rows4": dict(BWD_ROWS_PER_STEP=4), "rows16": dict(BWD_ROWS_PER_STEP=16),
    "blocks_per_sm2": dict(BWD_BLOCKS_PER_SM=2),
    "blocks_per_sm2_rows4": dict(BWD_BLOCKS_PER_SM=2, BWD_ROWS_PER_STEP=4),
}
_TAIL = "  // the sum across blocks: every block takes a ticket"
_FOLD = "  // the block's partial row of dscale"
# (anchor, replacement) pairs of each source variant
VARIANTS = {
    "empty": (("  static_assert(VEC || !BULK",
               "  if (rows > 0) return;\n  static_assert(VEC || !BULK"),),
    "copies_only": (("      for (int p = 0; p < passes; ++p, parity ^= 1) {",
                     "      for (int p = 0; p < 0; ++p, parity ^= 1) {"),),
    "no_dsum_stores": (("          store_value<T, VALS, VEC>(orow, out",
                        "          if (rstd < 0.f) store_value<T, VALS, "
                        "VEC>(orow, out"),),
    "no_fold_no_tail": ((_FOLD, "  return;\n" + _FOLD),),
    "no_tail": ((_TAIL, "  return;\n" + _TAIL),),
    # not timed: SM clock at each event of warp 0 of blocks 0, 64 and the
    # last, printed by the kernel (entry, each stage landed, each step done,
    # partial row written, each ticket won, exit)
    "timeline": (
        ("  T* ring = reinterpret_cast<T*>(smem);",
         "  T* ring = reinterpret_cast<T*>(smem);\n"
         "  long long tl[16]; int ntl = 0; tl[ntl++] = clock64();\n"
         "#define MARK if (threadIdx.x == 0 && ntl < 16) tl[ntl++] = clock64()\n"
         "#define DONE { MARK; if (threadIdx.x == 0 && (blockIdx.x == 0 || "
         "blockIdx.x == 64 || blockIdx.x == gridDim.x - 1 || slot >= 0)) "
         "for (int k = 1; k < ntl; ++k) printf(\"timeline block %d slot %d "
         "event %d +%lld cycles\\n\", blockIdx.x, slot, k, tl[k] - tl[0]); "
         "return; }"),
        ("        xs = ring + s * kSpans * span;",
         "        MARK;\n        xs = ring + s * kSpans * span;"),
        ("      if (BULK) {   // this warp is done with the stage",
         "      MARK;\n      if (BULK) {   // this warp is done with the stage"),
        ("  __syncthreads();                       // the block's partial row",
         "  MARK;\n  __syncthreads();                       // the block's "
         "partial row"),
        ("  if (slot < 0) return;", "  if (slot < 0) DONE\n  MARK;"),
        ("    add_slice<T, 1>(partial, dscale, d, slot, reducers, sums);\n}",
         "    add_slice<T, 1>(partial, dscale, d, slot, reducers, sums);\n"
         "  DONE\n}"),
        ("#include <stdint.h>", "#include <stdint.h>\n#include <cstdio>"),
    ),
    # not timed: every warp's clock when each of its first steps landed and
    # was done, and when it left the loop (block 0), printed after the fold
    "timeline_warps": (
        ("  T* ring = reinterpret_cast<T*>(smem);",
         "  T* ring = reinterpret_cast<T*>(smem);\n"
         "  __shared__ long long tw[kWarps + 1][18];\n"
         "  const long long t0 = clock64();\n"
         "  if ((threadIdx.x & 31) == 0) for (int k = 0; k < 18; ++k) "
         "tw[threadIdx.x >> 5][k] = -1;"),
        ("        xs = ring + s * kSpans * span;",
         "        if (lane == 0 && i < 8) tw[warp][2 * i] = clock64() - t0;\n"
         "        xs = ring + s * kSpans * span;"),
        ("      if (BULK) {   // this warp is done with the stage",
         "      if (lane == 0 && i < 8) tw[warp][2 * i + 1] = clock64() - t0;\n"
         "      if (BULK) {   // this warp is done with the stage"),
        ("  // the block's partial row of dscale",
         "  if ((threadIdx.x & 31) == 0) tw[threadIdx.x >> 5][16] = "
         "clock64() - t0;\n  // the block's partial row of dscale"),
        ("  float* prow = partial",
         "  if (blockIdx.x == 0 && threadIdx.x == 0) for (int w = 0; w <= "
         "kWarps; ++w) { printf(\"warps block 0 warp %d:\", w); for (int k = 0;"
         " k < 17; ++k) printf(\" %lld\", tw[w][k]); printf(\"\\n\"); }\n"
         "  float* prow = partial"),
        ("#include <stdint.h>", "#include <stdint.h>\n#include <cstdio>"),
    ),
}
VARIANTS["timeline_slice"] = (   # not timed: inside reducer 0's sums
    ("  const int n_groups = (blocks + kGroupBlocks - 1) / kGroupBlocks;\n",
     "  const int n_groups = (blocks + kGroupBlocks - 1) / kGroupBlocks;\n"
     "  const long long c0 = clock64();\n"),
    ("  __syncthreads();\n  for (int u = threadIdx.x; u < nu;",
     "  const long long c1 = clock64();\n  __syncthreads();\n"
     "  const long long c2 = clock64();\n  for (int u = threadIdx.x; u < nu;"),
    ("    for (int w = 0; w < W; ++w) dscale[(u0 + u) * W + w] = "
     "from_f32<T>(t[w]);\n  }\n}",
     "    for (int w = 0; w < W; ++w) dscale[(u0 + u) * W + w] = "
     "from_f32<T>(t[w]);\n  }\n  if (slot == 0 && threadIdx.x == 0) "
     "printf(\"slice 0: sums %lld, barrier %lld, groups %lld cycles\\n\", "
     "c1 - c0, c2 - c1, clock64() - c2);\n}"),
    ("#include <stdint.h>", "#include <stdint.h>\n#include <cstdio>"),
)
_UNTIMED = ("timeline", "timeline_warps", "timeline_slice")
_BOUNDS = ("__launch_bounds__((kWarps + (BULK ? 1 : 0)) * 32)",
           "__launch_bounds__((kWarps + (BULK ? 1 : 0)) * 32, 2)")
_REGISTERS = ("constexpr bool kBulk = true;", "constexpr bool kBulk = false;")
_BLOCK_ORDER = ("constexpr int kGroupBlocks = 16;",
                "constexpr int kGroupBlocks = 1 << 30;")
_ONE_REDUCER = ("constexpr int kReducers = 16;", "constexpr int kReducers = 1;")
VARIANTS.update({
    # 16-byte register loads from global memory in place of the ring
    "registers": (_REGISTERS,),
    "registers_blocks_per_sm2": (_REGISTERS,),
    # the sum across blocks: strict block order, one block, both
    "block_order": (_BLOCK_ORDER,),
    "one_reducer": (_ONE_REDUCER,),
    "one_reducer_block_order": (_ONE_REDUCER, _BLOCK_ORDER),
    "group_blocks8": (("constexpr int kGroupBlocks = 16;",
                       "constexpr int kGroupBlocks = 8;"),),
    "group_blocks4": (("constexpr int kGroupBlocks = 16;",
                       "constexpr int kGroupBlocks = 4;"),),
    "reducers8": (("constexpr int kReducers = 16;",
                   "constexpr int kReducers = 8;"),),
    "reducers32": (("constexpr int kReducers = 16;",
                    "constexpr int kReducers = 32;"),),
    # x, res and dh kept in registers between the passes, not read again
    "hold_registers": (("          if (BULK) {   // read again from the ring",
                        "          if (false) {   // read again from the ring"),),
    # registers capped for two blocks an SM (run at the settings below)
    "two_blocks_an_sm": (_BOUNDS,),
    "two_blocks_an_sm_rows4": (_BOUNDS,),
    # a reducer thread keeps 16 partial rows' loads in flight, not 8
    "sums_batch16": (("constexpr int kBatch = 8;",
                      "constexpr int kBatch = 16;"),),
})
EXACT = ("registers", "registers_blocks_per_sm2", "block_order",
         "one_reducer", "one_reducer_block_order", "group_blocks8",
         "group_blocks4", "reducers8", "reducers32", "sums_batch16")
VARIANT_SETTINGS = {
    "two_blocks_an_sm": dict(BWD_BLOCKS_PER_SM=2),
    "two_blocks_an_sm_rows4": dict(BWD_BLOCKS_PER_SM=2, BWD_ROWS_PER_STEP=4),
    "registers_blocks_per_sm2": dict(BWD_BLOCKS_PER_SM=2)}
OUT = _build.BUILD_DIR.parent / "fused_bwd_ablations"


def build_variants():
    """One nvcc a variant, all started together; their libraries."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_add_rmsnorm_bwd.cu").read_text()
    nvcc, procs = _build.nvcc_path(), {}
    for name, subs in VARIANTS.items():
        text = src
        for anchor, new in subs:
            if anchor not in text:
                raise RuntimeError(f"fused_bwd variant {name!r}: anchor "
                                   f"{anchor.strip()[:50]!r} not in the source")
            text = text.replace(anchor, new)
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"fused_bwd variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def inputs(gen, rows, d):
    x, r, dh, dy = (torch.randn(rows, d, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(4))
    sc = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    return dh, dy, x, r, sc


def check(got, want, what):
    gs, gd = (t.float() for t in got)
    ws, wd = (t.float() for t in want)
    err = (gs - ws).abs()
    if not bool((err <= TOL + TOL * ws.abs()).all()):
        raise AssertionError(f"{what}: dsum {err.max().item():.3e}")
    top = wd.abs().max().item()
    if not (gd - wd).abs().max().item() <= TOL * top:
        raise AssertionError(f"{what}: dscale")


@contextlib.contextmanager
def constants(**values):
    """``fused``'s ``BWD_*`` set to ``values`` inside the block."""
    old = {k: getattr(fused_mod, k) for k in values}
    for k, v in values.items():
        setattr(fused_mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(fused_mod, k, v)


def main() -> int:
    default_only = "--default-only" in sys.argv[1:]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = card()
    libs = {} if default_only else build_variants()

    def run():
        return fused_mod.fused_add_rmsnorm_bwd_cuda(*args)

    for rows, d in SHAPES:
        args = inputs(gen, rows, d)
        want = fused_mod.fused_add_rmsnorm_bwd_plain(*args)
        out = dict(card=smi, shape=[rows, d], dtype="bfloat16",
                   bound_ms=2 * (5 * rows * d + 2 * d) / HBM_BYTES_S * 1e3)
        if default_only:
            check(run(), want, "default")
            out["module"] = fused_mod.__file__
            out["ms"] = at.bench_time(run, iters=20, device="cuda") * 1e3
            print(json.dumps(out), flush=True)
            continue
        from repro_torch.kernels import rmsnorm as rn
        pl = rn.plan(*args[2:], *args[:2], warp_vals=fused_mod.BWD_WARP_VALS)
        out["plans"], out["ms"] = {}, {}
        for name, setting in SETTINGS.items():
            with constants(**setting):
                check(run(), want, name)
                out["plans"][name] = fused_mod.bwd_plan(rows, d, 2, pl,
                                                        sms)._asdict()
                out["ms"][name] = at.bench_time(run, iters=20,
                                                device="cuda") * 1e3
        out["variants_ms"] = {}
        real = _build.load("fused_add_rmsnorm_bwd")
        for name, lib in libs.items():      # in the wrapper's place
            _build._libs["fused_add_rmsnorm_bwd"] = lib
            try:
                if name in _UNTIMED:
                    run()
                    torch.cuda.synchronize()
                    continue
                with constants(**VARIANT_SETTINGS.get(name, {})):
                    if name in EXACT:
                        check(run(), want, name)
                    out["variants_ms"][name] = at.bench_time(
                        run, iters=20, device="cuda") * 1e3
            finally:
                _build._libs["fused_add_rmsnorm_bwd"] = real
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
