"""Block-size autotuner with a persistent on-disk cache (counterpart of
``repro/kernels/autotune.py``), plus the chip identity and kernel timing
that kernel calibration uses.

``default_chip`` names the device the kernels run on, as the key of the
accelerator catalog, of cost tables and of this cache; ``bench_time``
times one call.  ``autotune`` benchmarks a small candidate grid once per
``(op, shape, dtype, chip)`` and remembers the winner on disk, so every
later process reuses it without re-timing; ``kernels/ops.py`` consults it
for ``block="auto"``, or for ``None`` while ``enabled()``
(``REPRO_KERNEL_AUTOTUNE``).

Determinism: the cache key includes a fingerprint of the candidate grid,
so the same grid always resolves to the same stored winner; a fresh tune
breaks timing ties by candidate order (first-best wins), and candidates
whose benchmark raises are skipped, not fatal, unless the caller narrows
``skip``.  The four tuners below skip nothing: their grids hold only
tiles the kernels are built for, so a candidate that raises there is a
kernel that failed to build or launch, and the error propagates.  A tune
that misses the cache while the current CUDA stream is capturing a graph
raises: timing
synchronizes and allocates, which a capture refuses, so a graphed step
must meet each shape eagerly first (``graphs.GraphedShapes`` does).

Cache file schema (JSON, one file per chip by default)::

    { "<op>|<dtype>|<chip>|s<shape>|g<grid-fp>":
        {"config": {...}, "time_s": 1.2e-4, "tuned": [[{...}, t], ...]} }

Dtypes are written under the reference's names (``"float32"``,
``"bfloat16"``), so for the same op, shape, dtype, chip and grid the key
is the reference's.  ``tuned`` keeps every candidate's time; only
``config`` is consulted on the hot path.

The grids are the tiles the port's kernels are built for, not the
reference's 64/128/256:

* ``flash_attention``: ``block_q`` in ``flash_attention.BLOCK_Q_CHOICES``
  of the kernel the dtype runs (64, 128 for both the bf16 tensor-core and
  the fp32 CUDA-core kernel) by ``block_k`` in ``BLOCK_K_CHOICES`` (64);
* ``rmsnorm`` and ``fused_add_rmsnorm``: ``block_rows`` None (the plan's
  default: one row a warp, or a warp group) then 32, 128 and 512 rows a
  CUDA block, each capped at the row count;
* ``ssd_scan``: ``chunk`` 32, 64 and 128 (``ssd.MAX_CHUNK``), each capped
  at the sequence length.

Both packages default to one file per chip under
``~/.cache/repro-kernels`` (``REPRO_KERNEL_CACHE_DIR`` moves it); their
grid fingerprints differ, so neither reads the other's winners, and each
``put`` rewrites the file from its own entries, as the reference does.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import dtype_name

DeviceArg = Union[str, torch.device, None]
Config = Dict[str, Optional[int]]
_SLEEP_CYCLES = 20_000_000    # ~10 ms of device clock, longer than the enqueue
_FLUSH_BYTES = 128 << 20      # over twice the H100's 50 MB L2


# the one card the catalog's "H100" entry describes: the SXM part's data
# sheet (core/profiler/hw_specs.py), under the name the card reports
H100_SXM_NAME = "NVIDIA H100 80GB HBM3"


def default_chip(device: DeviceArg = None) -> str:
    """Cache identity of the device the kernels run on: ``"H100"`` for the
    card the catalog's ``"H100"`` entry describes (the SXM part,
    ``H100_SXM_NAME``; the key ``JobProfile.cost(..., "H100", ...)`` looks
    up), any other card's name lowercased with ``-`` for spaces (the
    reference's rule for a device kind: ``nvidia-h100-pcie``,
    ``nvidia-h100-nvl``, which the catalog does not hold), and
    ``"cpu-host"`` for the CPU."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device or "cpu")
    if dev.type != "cuda":
        return "cpu-host"
    name = torch.cuda.get_device_name(dev)
    if name == H100_SXM_NAME:
        return "H100"
    return name.replace(" ", "-").lower()


def bench_time(fn: Callable[[], Any], *, warmup: int = 1, iters: int = 3,
               device: DeviceArg = None) -> float:
    """Median seconds of one ``fn()`` call.

    On a CUDA device each call is timed alone with a pair of CUDA events
    (device time: what ``JobProfile`` adds to its compute term; host
    dispatch belongs to the engine's overheads), and starts with a cold L2:
    a 128 MB read queued before it evicts what earlier calls left there, so
    its bytes come from device memory and the time can be held against the
    memory-rate bound.  A sleep kernel queued first keeps the device busy
    while the host enqueues the calls, so the host's launch gaps do not
    count where the host keeps ahead.  On the CPU the host clock times each
    call, as the reference times its interpret-mode kernels."""
    dev = torch.device(device or "cpu")
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        # read before each call: the last call's inputs leave the L2, and
        # its outputs are written back outside the timed window
        flush = torch.ones(_FLUSH_BYTES // 4, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(_SLEEP_CYCLES)
        pairs = []
        for _ in range(iters):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
        return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


# --- the cache ----------------------------------------------------------------

def enabled() -> bool:
    """ops.py consults this for implicit (block size = None) autotuning."""
    return os.environ.get("REPRO_KERNEL_AUTOTUNE", "0") not in ("", "0")


def default_cache_path(chip: Optional[str] = None) -> Path:
    root = Path(os.environ.get("REPRO_KERNEL_CACHE_DIR",
                               Path.home() / ".cache" / "repro-kernels"))
    return root / f"autotune-{chip or default_chip()}.json"


def _grid_fingerprint(candidates: Sequence[Config]) -> str:
    blob = json.dumps([sorted(c.items()) for c in candidates])
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def cache_key(op: str, shape: Tuple[int, ...], dtype: str, chip: str,
              candidates: Sequence[Config]) -> str:
    sh = "x".join(str(int(s)) for s in shape)
    return f"{op}|{dtype}|{chip}|s{sh}|g{_grid_fingerprint(candidates)}"


class AutotuneCache:
    """Persistent winner store; loads eagerly, saves atomically."""

    def __init__(self, path: os.PathLike):
        self.path = Path(path)
        self._data: Dict[str, Dict[str, Any]] = {}
        if self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except (json.JSONDecodeError, OSError):
                self._data = {}            # corrupt cache: retune

    def get(self, key: str) -> Optional[Config]:
        ent = self._data.get(key)
        return dict(ent["config"]) if ent else None

    def put(self, key: str, config: Config, time_s: float,
            tuned: List[Tuple[Config, float]]) -> None:
        self._data[key] = {"config": dict(config), "time_s": time_s,
                           "tuned": [[dict(c), t] for c, t in tuned]}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(self._data, indent=1, sort_keys=True))
        os.replace(tmp, self.path)


@functools.lru_cache(maxsize=8)
def _shared_cache(path: str) -> AutotuneCache:
    return AutotuneCache(Path(path))


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def autotune(op: str, shape: Tuple[int, ...], dtype: str,
             candidates: Sequence[Config],
             bench: Callable[[Config], float], *,
             chip: Optional[str] = None,
             cache: Optional[AutotuneCache] = None,
             skip: Tuple[type, ...] = (Exception,)) -> Config:
    """Return the fastest candidate config, consulting/updating the cache.

    ``bench(config) -> seconds``; raising one of ``skip`` marks the
    candidate infeasible, any other exception propagates.
    The winner is min by (time, candidate order): deterministic given the
    measured times, and permanently deterministic once cached.  A cache
    miss during a CUDA graph capture raises ``RuntimeError``.
    """
    if not candidates:
        raise ValueError(f"autotune({op}): empty candidate grid")
    chip = chip or default_chip()
    if cache is None:
        cache = _shared_cache(str(default_cache_path(chip)))
    key = cache_key(op, shape, dtype, chip, candidates)
    hit = cache.get(key)
    if hit is not None:
        return hit
    if _capturing():
        raise RuntimeError(
            f"autotune({op}): no cached winner for shape={shape} {dtype} "
            f"and the current CUDA stream is capturing a graph; tuning "
            f"times on the device, which a capture cannot hold. Run the "
            f"shape once eagerly (or pass an int block) before capturing")
    tuned: List[Tuple[Config, float]] = []
    with torch.no_grad():
        for cand in candidates:
            try:
                tuned.append((cand, bench(cand)))
            except skip:
                continue                   # infeasible tiling
    if not tuned:
        raise RuntimeError(f"autotune({op}): no feasible candidate "
                           f"for shape={shape}")
    best_i = min(range(len(tuned)), key=lambda i: (tuned[i][1], i))
    best, t = tuned[best_i]
    cache.put(key, best, t, tuned)
    return dict(best)


# --- per-op candidate grids + tuners (used by ops.py and the bench) -----------

ROWS_CHOICES = (32, 128, 512)     # block_rows besides the plan's default
CHUNK_CHOICES = (32, 64, 128)     # SSD chunks, all <= ssd.MAX_CHUNK


def flash_candidates(dtype: torch.dtype) -> List[Config]:
    from repro_torch.kernels import flash_attention as fa
    qs = fa.BLOCK_Q_CHOICES[fa.kernel_for(dtype)]
    return [{"block_q": bq, "block_k": bk}
            for bq in qs for bk in fa.BLOCK_K_CHOICES]


def rows_candidates(rows: int) -> List[Config]:
    return [{"block_rows": None}] + [
        {"block_rows": b}
        for b in sorted({max(1, min(b, rows)) for b in ROWS_CHOICES})]


def chunk_candidates(s: int) -> List[Config]:
    return [{"chunk": c}
            for c in sorted({max(1, min(c, s)) for c in CHUNK_CHOICES})]


def _rows(x: torch.Tensor) -> int:
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    return rows


def tune_flash_attention(q, k, v, *, causal: bool,
                         cache: Optional[AutotuneCache] = None) -> Config:
    """q: (B, S, H, D), k/v: (B, Sk, KH, D); keyed as the reference keys
    its (B*H, S, D) call, ``(B*H, S, Sk, D, causal)``, with KH appended
    where KH < H: the reference's kernel sees K/V repeated to H heads, the
    port's reads the KH heads in place (GQA), so a grouped call times
    otherwise than a full-head one with the same q."""
    from repro_torch.kernels import ops
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    shape = (b * h, sq, sk, d, int(causal)) + ((kh,) if kh != h else ())
    cpu = ops._on_cpu(q, k, v)

    def bench(c: Config) -> float:     # the forward alone, at this tile
        return bench_time(lambda: ops._flash_fwd(
            q, k, v, causal, c["block_q"], c["block_k"], cpu,
            return_lse=False), device=q.device)

    return autotune("flash_attention", shape, dtype_name(q.dtype),
                    flash_candidates(q.dtype), bench,
                    chip=default_chip(q.device), cache=cache, skip=())


def tune_rmsnorm(x, scale, *, eps: float,
                 cache: Optional[AutotuneCache] = None) -> Config:
    from repro_torch.kernels import ops
    rows = _rows(x)

    def bench(c: Config) -> float:     # the resolved call: None is the default
        return bench_time(lambda: ops._rmsnorm(x, scale, eps,
                                               c["block_rows"]),
                          device=x.device)

    return autotune("rmsnorm", (rows, x.shape[-1]), dtype_name(x.dtype),
                    rows_candidates(rows), bench,
                    chip=default_chip(x.device), cache=cache, skip=())


def tune_fused_add_rmsnorm(x, res, scale, *, eps: float,
                           cache: Optional[AutotuneCache] = None) -> Config:
    from repro_torch.kernels import ops
    rows = _rows(x)

    cpu = ops._on_cpu(x, res, scale)

    def bench(c: Config) -> float:     # the forward alone, at this tile
        return bench_time(lambda: ops._fused_fwd(
            x, res, scale, eps, c["block_rows"], cpu), device=x.device)

    return autotune("fused_add_rmsnorm", (rows, x.shape[-1]),
                    dtype_name(x.dtype), rows_candidates(rows), bench,
                    chip=default_chip(x.device), cache=cache, skip=())


def tune_ssd_scan(x, dt, a, b, c, *,
                  cache: Optional[AutotuneCache] = None) -> Config:
    from repro_torch.kernels import ops
    bs, s, h, p = x.shape

    def bench(cand: Config) -> float:
        return bench_time(lambda: ops._ssd_scan(x, dt, a, b, c,
                                                cand["chunk"]),
                          device=x.device)

    return autotune("ssd_scan", (bs, s, h, p, b.shape[-1]),
                    dtype_name(x.dtype), chunk_candidates(s), bench,
                    chip=default_chip(x.device), cache=cache, skip=())
