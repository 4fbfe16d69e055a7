"""Where the bf16 attention kernel's time goes: timed variants of its source.

    python3 -m repro_torch.bench.attention_ablations     # from src/, on a GPU

Each variant is ``csrc/flash_attention.cu`` with one piece of the wgmma
kernel's tile loop changed by a text substitution (the anchors are checked,
so a variant that no longer applies fails loudly).  All variants build at
once, one ``nvcc`` each, into ``build/attention_ablations/``; each then runs
in its own process, so a fault in one cannot poison the others.  The
``base`` variant is also held against the plain version; the others compute
wrong values on purpose and are only timed.  Times are
``autotune.bench_time`` (cold L2, median of 20) at the serve shape
(8, 512, 15/5, 64) and the calibrate shape (1, 2048, 120/120, 64), causal,
``block_q`` 128, one JSON line a variant.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

from repro_torch.kernels import _build

OUT = _build.BUILD_DIR.parent / "attention_ablations"
SHAPES = ((8, 512, 15, 5, 64), (1, 2048, 120, 120, 64))

_COPY = "    if (j + kAhead < n_tiles) {                 // into tile j - 1's stage"
_LOOP = "    if (j >= my_tiles) continue;                // uniform in the warpgroup"
_QK = "      mma_ss_n64(s, desc(q_addr + 256 * kk, 128, GROUP_BYTES),"
_PV = "    MmaRS<D>::run(acc, hi[kk], b);\n    MmaRS<D>::run(acc, lo[kk], b);\n"
_EXP = "ex2(fmaf("
_STORE = "    if (qw + r < sq)\n      *reinterpret_cast<uint4*>"
# (anchor, replacement) pairs of each variant
VARIANTS: Dict[str, tuple] = {
    "base": (),
    "prefetch_1_tile": (("constexpr int kAhead = 2;",
                         "constexpr int kAhead = 1;"),),
    "prefetch_4_tiles": (("constexpr int kAhead = 2;",
                          "constexpr int kAhead = 4;"),),
    "single_bf16_p": ((_PV, "    MmaRS<D>::run(acc, hi[kk], b);\n"),),
    "no_kv_copies": ((_COPY, "    if (false) {"),),
    "copies_only": ((_LOOP, "    continue;"),),
    "no_products": ((_QK, "      if (false) " + _QK.lstrip()),
                    (_PV, "")),
    "no_exp": ((_EXP, "(fmaf("),),
    "no_output_store": ((_STORE, _STORE.replace("qw + r < sq", "false"),),),
}


def variant_source(name: str) -> str:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor, new in VARIANTS[name]:
        if anchor not in src:
            raise RuntimeError(f"attention ablation {name!r}: anchor "
                               f"{anchor.strip()[:50]!r} not in the source")
        src = src.replace(anchor, new)
    return src


def build_all() -> Dict[str, Path]:
    """One nvcc per variant, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name in VARIANTS:
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(variant_source(name))
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = so
    return libs


def run_variant(name: str, so: str) -> dict:
    """Time one built variant (in this process) through the port's
    launcher; ``base`` is also held against the plain version."""
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    lib = ctypes.CDLL(so)
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _build._libs["flash_attention"] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for b, s, h, kh, d in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kh, kh))
        key = f"ms_{b}x{s}x{h}/{kh}x{d}"
        row[key] = autotune.bench_time(
            lambda: fa.flash_attention_cuda(q, k, v), iters=20,
            device="cuda") * 1e3
        if name == "base":
            got = fa.flash_attention_cuda(q, k, v)
            want = fa.flash_attention_plain(q, k, v)
            row[f"max_abs_err_{b}x{s}"] = (got.float()
                                           - want.float()).abs().max().item()
    return row


def main() -> int:
    if len(sys.argv) == 3:                      # one variant, in a child
        print(json.dumps(run_variant(sys.argv[1], sys.argv[2])), flush=True)
        return 0
    libs = build_all()
    env = dict(os.environ, PYTHONPATH=str(_build.CSRC.parents[1]))
    for name, so in libs.items():
        out = subprocess.run([sys.executable, "-m",
                              "repro_torch.bench.attention_ablations", name,
                              str(so)],
                             capture_output=True, text=True, timeout=300,
                             env=env)
        if out.returncode != 0:
            print(json.dumps({"variant": name, "error": out.stderr[-2000:]}),
                  flush=True)
            continue
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
