"""Where the attention kernels' time goes: timed variants of their sources.

    python3 -m repro_torch.bench.attention_ablations         # from src/, on a GPU
    python3 -m repro_torch.bench.attention_ablations bwd     # the backward's only
    python3 -m repro_torch.bench.attention_ablations f32     # the fp32 forward's only
    python3 -m repro_torch.bench.attention_ablations bwd_f32 # the fp32 backward's only
    python3 src/repro_torch/bench/attention_ablations.py --f32-default-only
    python3 src/repro_torch/bench/attention_ablations.py --f32-bwd-default-only [inputs.pt]

Each variant is ``csrc/flash_attention.cu`` (the bf16 forward's, named
plainly; the fp32 CUDA-core forward's, ``f32_*``) or
``csrc/flash_attention_bwd.cu`` (``bwd_*``; the fp32 CUDA-core
backward's, ``bwd_f32_*``) with one piece of a kernel
changed by a text substitution (the anchors are checked, so a variant
that no longer applies fails loudly).  All variants build at once,
one ``nvcc`` each, into ``build/attention_ablations/``; each then runs in
its own process, so a fault in one cannot poison the others.  The ``base``
variants, and those that change only how P and dS are rounded, are also
held against the plain version (the backward's with the same roundings);
the others compute wrong values on purpose and are only timed.  Times are
``autotune.bench_time`` (cold L2, median of 20), one JSON line a variant:
the forward at the serve shape (8, 512, 15/5, 64) and the calibrate shape
(1, 2048, 120/120, 64), causal, ``block_q`` 128; the backward at the train
shape (4, 1024, 15/5, 64) and at (1, 2048, 16/16, 128), causal, its
default blocks; the fp32 forward at the forward's shapes in fp32, at
``block_q`` 64 and, for ``f32_base``, 128 too; the fp32 backward at the
train shape and the plan phase's fp32 fit shape (4, 128, 15/5, 64),
causal, its default blocks, held against the plain version.

``--f32-default-only`` times only the wrapper's own fp32 launch at the
forward's shapes (default ``block_q``, checked against the plain version)
with whatever ``repro_torch`` ``PYTHONPATH`` finds first: run it with an
older tree's ``src`` to time that tree's kernel on the same card in the
same call.  ``--f32-bwd-default-only`` does the same for the fp32
backward at ``F32_BWD_SHAPES`` (default blocks), on seeded inputs or on
those a ``torch.save`` file holds (``{label: (q, k, v, do, lse)}``, as
``chip_smoke.py`` writes them), and prints one JSON line.
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
from repro_torch.kernels import flash_attention as fa

OUT = _build.BUILD_DIR.parent / "attention_ablations"
SHAPES = ((8, 512, 15, 5, 64), (1, 2048, 120, 120, 64))
BWD_SHAPES = ((4, 1024, 15, 5, 64), (1, 2048, 16, 16, 128))
F32_BWD_SHAPES = ((4, 1024, 15, 5, 64), (4, 128, 15, 5, 64))

_COPY = "    if (j + kAhead < n_tiles) {                 // into tile j - 1's stage"
_LOOP = "    if (j >= my_tiles) continue;                // uniform in the warpgroup"
_QK = "    mma_scores<D>(s, q_addr, k_addr);           // S = Q K^T"
_PV = "    mma_rs_tile<D, true>(acc, hi, lo,             // O += P V"
_EXP = "ex2(fmaf("
_STORE = "    if (qw + r < sq)\n      *reinterpret_cast<uint4*>"
_SPLIT = ("constexpr bool kSplitPdV = {};", "constexpr bool kSplitDsDk = {};",
          "constexpr bool kSplitDsDq = {};")
_BWD_SPLIT = fa.WGMMA_BWD_SPLIT          # mirrors the source's kSplit*
_MASK = "      if (k0 + kBlockK > sk || (causal && k0 + kBlockK - 1 > wrow)) {"
_CORR = "        const float corr = ex2(m[r] - m_new);"
_P = "          s[r][i] = ex2(fmaf(s[r][i], scale_log2, -m_new));"


def _split(**parts) -> tuple:
    """Substitutions that set the backward's kSplit* to ``parts`` (the
    source's values where not given)."""
    want = dict(_BWD_SPLIT, **parts)
    return tuple((a.format(str(_BWD_SPLIT[k]).lower()),
                  a.format(str(want[k]).lower()))
                 for a, k in zip(_SPLIT, _BWD_SPLIT) if want[k] != _BWD_SPLIT[k])


# (anchor, replacement) pairs of each variant
VARIANTS: Dict[str, tuple] = {
    "base": (),
    "prefetch_1_tile": (("constexpr int kAhead = 2;",
                         "constexpr int kAhead = 1;"),),
    "prefetch_4_tiles": (("constexpr int kAhead = 2;",
                          "constexpr int kAhead = 4;"),),
    "single_bf16_p": ((_PV, _PV.replace("true", "false")),),
    "no_kv_copies": ((_COPY, "    if (false) {"),),
    "copies_only": ((_LOOP, "    continue;"),),
    "no_products": ((_QK, ""), (_PV, "    if (false) " + _PV.lstrip())),
    "no_exp": ((_EXP, "(fmaf("),),
    "no_output_store": ((_STORE, _STORE.replace("qw + r < sq", "false"),),),
    # the backward: how P and dS enter their products (values right, the
    # plain version told the same split), and where its time goes (pass 1
    # of the dQ kernel streams its tiles but runs no products)
    "bwd_base": (),
    "bwd_one_rounding_all": _split(ds_dq=False),
    "bwd_split_all": _split(p_dv=True, ds_dk=True),
    "bwd_no_delta_pass": (("    if (j >= my_tiles) continue;                   "
                           "// uniform in the warpgroup",
                           "    if (j >= my_tiles || it < n_tiles) continue;"),),
    "bwd_prefetch_1_tile": (("constexpr int kAhead = 2;          // tiles",
                             "constexpr int kAhead = 1;          // tiles"),),
    # the fp32 CUDA-core forward: a second K/V stage (a copy in flight in
    # the block, two blocks an SM), its mask only where it bites, the
    # copies' addresses computed afresh for every piece, its exponential
    # (each keeps the values, so each is checked)
    "f32_base": (),
    "f32_two_stages": (("constexpr int kKvStages = 1;",
                        "constexpr int kKvStages = 2;"),),
    "f32_mask_every_tile": ((_MASK, "      if (true) {"),),
    "f32_generic_copy": (("copy_rows<", "copy_rows_each<"),),
    "f32_expf": ((_CORR, _CORR.replace("ex2(m[r] - m_new)",
                                       "expf(kLn2 * (m[r] - m_new))")),
                 (_P, _P.replace("ex2(", "expf(kLn2 * "))),
    # the fp32 CUDA-core backward: a second streamed stage (a copy in flight
    # in the block, fewer blocks an SM); values kept, so each is checked
    "bwd_f32_base": (),
    "bwd_f32_two_stages": (("constexpr int kStages = 1;",
                            "constexpr int kStages = 2;"),),
}
F32_BLOCK_Q = {"f32_base": (64, 128)}    # the others at block_q 64 only
# what each backward variant rounds, for its plain version (None: wrong
# values on purpose, timed only)
BWD_PLAIN_SPLIT = {
    "bwd_base": _BWD_SPLIT,
    "bwd_one_rounding_all": dict(_BWD_SPLIT, ds_dq=False),
    "bwd_split_all": dict(p_dv=True, ds_dk=True, ds_dq=True),
}


def _source(name: str) -> str:
    return "flash_attention_bwd" if name.startswith("bwd_") \
        else "flash_attention"


def variant_source(name: str) -> str:
    src = (_build.CSRC / f"{_source(name)}.cu").read_text()
    for anchor, new in VARIANTS[name]:
        if anchor not in src:
            raise RuntimeError(f"attention ablation {name!r}: anchor "
                               f"{anchor.strip()[:50]!r} not in the source")
        src = src.replace(anchor, new)
    return src


def build_all(names) -> Dict[str, Path]:
    """One nvcc per variant, all started together (``-I csrc`` for the
    headers the sources include)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name in names:
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(variant_source(name))
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)],
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
    launcher; ``base`` and the backward's rounding variants are also held
    against the plain version."""
    import torch

    from repro_torch.kernels import autotune
    lib = ctypes.CDLL(so)
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _build._libs[_source(name)] = lib
    bwd = name.startswith("bwd_")
    if name.startswith("bwd_f32"):
        return {"variant": name, "card": torch.cuda.get_device_name(0),
                **f32_bwd_times(None)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"variant": name, "card": torch.cuda.get_device_name(0)}
    for b, s, h, kh, d in BWD_SHAPES if bwd else SHAPES:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kh, kh))
        key = f"ms_{b}x{s}x{h}/{kh}x{d}"
        if bwd:
            do = torch.randn(b, s, h, d, generator=gen,
                             device="cuda").to(torch.bfloat16)
            _, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            args = (q, k, v, do, lse)
            row[key] = autotune.bench_time(
                lambda: fa.flash_attention_bwd_cuda(*args), iters=20,
                device="cuda") * 1e3
            if name in BWD_PLAIN_SPLIT:
                got = fa.flash_attention_bwd_cuda(*args)
                want = fa.flash_attention_bwd_plain(
                    *args, split=BWD_PLAIN_SPLIT[name])
                row[f"max_err_of_max_{b}x{s}"] = max(
                    ((x.float() - y.float()).abs().max()
                     / y.float().abs().max()).item()
                    for x, y in zip(got, want))
            continue
        if name.startswith("f32_"):
            q, k, v = (t.float() for t in (q, k, v))
            for bq in F32_BLOCK_Q.get(name, (64,)):
                row[f"{key}_bq{bq}"] = _time_checked(q, k, v, bq, row,
                                                     f"{b}x{s}_bq{bq}")
            continue
        row[key] = autotune.bench_time(
            lambda: fa.flash_attention_cuda(q, k, v), iters=20,
            device="cuda") * 1e3
        if name == "base":
            got = fa.flash_attention_cuda(q, k, v)
            want = fa.flash_attention_plain(q, k, v)
            row[f"max_abs_err_{b}x{s}"] = (got.float()
                                           - want.float()).abs().max().item()
    return row


def _time_checked(q, k, v, block_q, row: dict, tag: str) -> float:
    """ms of one fp32 forward at ``block_q`` (None: the wrapper's default),
    after holding it against the plain version (max error into ``row``)."""
    import torch

    from repro_torch.kernels import autotune
    got = fa.flash_attention_cuda(q, k, v, block_q=block_q)
    want = fa.flash_attention_plain(q, k, v, block_q=block_q)
    err = (got - want).abs().max().item()
    if not bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()):
        raise AssertionError(f"fp32 forward {tag}: max |kernel - plain| "
                             f"{err:.3e} exceeds 2e-5")
    row[f"max_abs_err_{tag}"] = err
    torch.cuda.synchronize()
    return autotune.bench_time(
        lambda: fa.flash_attention_cuda(q, k, v, block_q=block_q), iters=20,
        device="cuda") * 1e3


def f32_bwd_times(inputs) -> dict:
    """ms of the fp32 backward (default blocks) at ``F32_BWD_SHAPES``,
    causal, each after holding it against the plain version (2e-5 of the
    max |g|): on ``inputs`` (label -> (q, k, v, do, lse)) where given, else
    on seeded ones."""
    import torch

    from repro_torch.kernels import autotune
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {}
    for b, s, h, kh, d in F32_BWD_SHAPES:
        label = f"{b}x{s}x{h}/{kh}x{d}"
        if inputs is not None:
            args = tuple(t.cuda() for t in inputs[label])
        else:
            q, k, v, do = (torch.randn(b, s, n, d, generator=gen,
                                       device="cuda") for n in (h, kh, kh, h))
            _, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
            args = (q, k, v, do, lse)
        got = fa.flash_attention_bwd_cuda(*args)
        want = fa.flash_attention_bwd_plain(*args)
        err = max(((x - y).abs().max() / y.abs().max()).item()
                  for x, y in zip(got, want))
        if not err <= 2e-5:
            raise AssertionError(f"fp32 backward {label}: max |kernel - "
                                 f"plain| {err:.3e} of max |g| exceeds 2e-5")
        row[f"max_err_of_max_{label}"] = err
        torch.cuda.synchronize()
        row[f"ms_{label}"] = autotune.bench_time(
            lambda: fa.flash_attention_bwd_cuda(*args), iters=20,
            device="cuda") * 1e3
    return row


def _card() -> str:
    import subprocess as sp
    return sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  check=True).stdout.strip().splitlines()[0]


def default_only() -> dict:
    """The installed tree's fp32 forward at the forward's shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"variant": "f32_default_only", "module": fa.__file__,
           "card": _card()}
    for b, s, h, kh, d in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                   for n in (h, kh, kh))
        row[f"ms_{b}x{s}x{h}/{kh}x{d}"] = _time_checked(q, k, v, None, row,
                                                        f"{b}x{s}")
    return row


def main() -> int:
    if sys.argv[1:] == ["--f32-default-only"]:
        print(json.dumps(default_only()), flush=True)
        return 0
    if sys.argv[1:2] == ["--f32-bwd-default-only"]:
        import torch
        inputs = (torch.load(sys.argv[2]) if len(sys.argv) > 2 else None)
        print(json.dumps({"variant": "f32_bwd_default_only",
                          "module": fa.__file__, "card": _card(),
                          **f32_bwd_times(inputs)}), flush=True)
        return 0
    if len(sys.argv) == 3:                      # one variant, in a child
        print(json.dumps(run_variant(sys.argv[1], sys.argv[2])), flush=True)
        return 0
    only = (sys.argv[1] + "_" if sys.argv[1:] in (["bwd"], ["f32"],
                                                  ["bwd_f32"]) else "")
    names = [n for n in VARIANTS if n.startswith(only)]
    libs = build_all(names)
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
