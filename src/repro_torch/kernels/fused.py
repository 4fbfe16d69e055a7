"""Fused residual-add + RMSNorm: the CUDA kernel's launcher and its plain
version.

The kernel (``csrc/fused_add_rmsnorm.cu``) replaces the Pallas
``repro/kernels/fused.py::_kernel`` and keeps its order of rounding, not
the model's jnp path: ``y = fp32(x) + fp32(res)`` is stored once in the
input dtype, and the norm is taken from the fp32 ``y``,
``h = (y * rsqrt(mean(y^2) + eps)) * fp32(scale)``, cast once.  It reads
x and res once and writes ``h`` and ``y`` once, one warp (or, past 512
bf16 / 256 fp32 elements, a few warps) a row; ``plan`` picks the
instantiation with the RMSNorm kernel's planner.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.rmsnorm import MAX_D, Plan

BLOCK_ROWS = None     # rows a CUDA block takes; None: one a warp (or warp group)
# 16-byte values a lane holds before a row takes more warps: half RMSNorm's,
# since x, res and the scale are three rows of registers (see the source)
WARP_VALS = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-1: "dtype", -2: "plan / block_rows", -3: "16-byte alignment"}
LAST_PLAN: Optional[Plan] = None   # the instantiation the last launch ran


def check_args(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
               block_rows: Optional[int]) -> None:
    """What the kernel takes, held for the plain version too."""
    d = x.shape[-1] if x.dim() else 0
    if x.shape != res.shape or x.dim() < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"fused_add_rmsnorm: x/res (..., d) and scale (d,) "
                         f"expected, got {tuple(x.shape)}, {tuple(res.shape)}"
                         f", {tuple(scale.shape)}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"fused_add_rmsnorm: d={d}; the kernel takes "
                         f"1..{MAX_D}")
    if x.dtype not in _DTYPE_CODE or res.dtype != x.dtype \
            or scale.dtype != x.dtype:
        raise ValueError(f"fused_add_rmsnorm: dtypes {x.dtype}, {res.dtype}, "
                         f"{scale.dtype}; the kernel takes one of "
                         f"{list(_DTYPE_CODE)} for all three")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"fused_add_rmsnorm: block_rows={block_rows}")


def fused_add_rmsnorm_plain(x: torch.Tensor, res: torch.Tensor,
                            scale: torch.Tensor, *, eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, res: (..., d); scale: (d,).  Returns (normed, x + res)."""
    y = x.float() + res.float()
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    h = (y * torch.rsqrt(var + eps)) * scale.float()
    return h.to(x.dtype), y.to(x.dtype)


def plan(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor) -> Plan:
    """The instantiation for these inputs: ``rmsnorm.plan`` over x, res and
    scale (all three must start on 16-byte boundaries for 16-byte accesses)
    at ``WARP_VALS`` values a lane."""
    return rn.plan(x, res, scale, warp_vals=WARP_VALS)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def fused_add_rmsnorm_cuda(x: torch.Tensor, res: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-5,
                           block_rows: Optional[int] = BLOCK_ROWS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream; raises on any
    tensor it does not take and on a refused launch."""
    global LAST_PLAN
    for t in (x, res, scale):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("fused_add_rmsnorm_cuda: x, res, scale must be "
                             "CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("fused_add_rmsnorm_cuda: tensors must be "
                             "contiguous")
    d = x.shape[-1]
    rows = x.numel() // d
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    if rows == 0:
        return h, y
    pl = plan(x, res, scale)
    rpb = block_rows or rn.WARPS // pl.warps_per_row
    lib = _build.load("fused_add_rmsnorm")
    fn = lib.repro_fused_add_rmsnorm
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), res.data_ptr(), scale.data_ptr(), h.data_ptr(),
            y.data_ptr(), _DTYPE_CODE[x.dtype], x.device.index, rows, d,
            int(pl.vector), pl.vals, pl.warps_per_row, rpb, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "fused_add_rmsnorm", _ERRORS)
    LAST_PLAN = pl
    return h, y


# --- backward ---------------------------------------------------------------------
#
# The reference differentiates its jnp seam; the kernel in
# ``csrc/fused_add_rmsnorm_bwd.cu`` is the backward of the function above.
# With y = fp32(x) + fp32(res) (the kernel's fp32 sum, recomputed),
# rstd = rsqrt(mean(y^2) + eps), n = y * rstd, and the casts of h and y
# passed straight through:
#   dn = dh * scale;  dsum = dy + rstd * (dn - n * mean(dn * n))
#   dx = dres = dsum;  dscale = sum over rows of dh * n
# One kernel a call: a persistent grid (``bwd_plan``) whose blocks walk
# contiguous runs of rows through a shared-memory ring fed by bulk async
# copies, each block writing an fp32 partial row of dscale; the last 16
# blocks to draw a ticket from an int32 counter add the partial rows, a
# slice of the columns each, in a fixed order (groups of 16 blocks in
# block order, then the groups in order) in the same launch.  No atomics
# on data, so two runs agree bit for bit.  The settings below are the
# ablations' (``bench/fused_bwd_plans.py``, which varies the source's own
# constants by text).

BWD_WARP_VALS = rn.WARP_VALS   # one warp a row up to 1024 bf16 / 512 fp32
BWD_STAGES = 2                 # ring stages a block (1-4)
BWD_ROWS_PER_STEP = 8          # rows a step at one warp a row; w warps: / w
BWD_BLOCKS_PER_SM = 1
BWD_REDUCERS = 16              # the source's kReducers, for the grid rule
SM_SMEM = 233472               # shared memory of an H100 SM (228 KB)
BLOCK_SMEM = 232448            # the most one block may take (227 KB)
STATIC_SMEM = 256              # the kernel's own barriers and sums
_BWD_ERRORS = {-1: "dtype", -2: "plan", -3: "16-byte alignment",
               -4: "grid (more blocks than SMs, a reducer on every SM)"}
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


class BwdPlan(NamedTuple):
    """One launch of the backward: the row plan (``rmsnorm.Plan``'s three
    fields), the ring (stages, 0 on the scalar plan's register loads; rows
    a step) and the persistent grid (rows a block, blocks)."""
    vector: bool
    vals: int
    warps_per_row: int
    stages: int
    rows_per_step: int
    rows_per_block: int
    blocks: int


def bwd_plan(rows: int, d: int, elem: int, pl: Plan, sms: int) -> BwdPlan:
    """The launch for ``rows`` rows of ``d`` elements of ``elem`` bytes
    under row plan ``pl`` on a card of ``sms`` SMs, at the module's
    ``BWD_*``.  A ring stage holds a step's rows of x, res, dh and dy; rows
    a step and then stages shrink until ``BWD_BLOCKS_PER_SM`` blocks'
    rings fit in an SM's shared memory (a single row that does not fit at
    two blocks an SM takes one), and a block has no more stages than
    steps.  The grid has at most ``sms * BWD_BLOCKS_PER_SM`` blocks and at
    most one a step: every block gets a whole number of steps and at least
    one row.  A card with no more SMs than ``BWD_REDUCERS`` takes one block
    an SM, so the reducers' wait cannot hold every SM (the C entry refuses
    such a grid)."""
    stages, bps = BWD_STAGES, BWD_BLOCKS_PER_SM
    step = max(1, BWD_ROWS_PER_STEP // pl.warps_per_row)
    if not 1 <= stages <= 4 or bps < 1 or step < 1 or rows < 1 or sms < 1:
        raise ValueError(f"bwd_plan: stages={stages}, blocks_per_sm={bps}, "
                         f"rows_per_step={step}, rows={rows}, sms={sms}")
    if sms <= BWD_REDUCERS:
        bps = 1
    row = 4 * d * elem               # a row of x, res, dh and dy
    budget = min(BLOCK_SMEM, SM_SMEM // bps - 1024) - STATIC_SMEM
    if pl.vector and row > budget:
        bps, budget = 1, BLOCK_SMEM - STATIC_SMEM
    if pl.vector:
        step = min(step, budget // row)
    steps = -(-rows // step)
    per = -(-steps // (sms * bps))   # steps a block
    blocks = -(-steps // per)
    # no more stages than fit, nor than the block has steps
    stages = min(stages, budget // (step * row), per) if pl.vector else 0
    return BwdPlan(pl.vector, pl.vals, pl.warps_per_row, stages, step,
                   per * step, blocks)


def _bwd_rows(dh, dy, x, res, scale, eps):
    """(dsum, dh * n), both fp32 (..., d)."""
    y = x.float() + res.float()
    rstd = torch.rsqrt(torch.mean(torch.square(y), dim=-1, keepdim=True)
                       + eps)
    n = y * rstd
    dhf = dh.float()
    dn = dhf * scale.float()
    dsum = dy.float() + rstd * (dn - n * torch.mean(dn * n, dim=-1,
                                                    keepdim=True))
    return dsum, dhf * n


def fused_add_rmsnorm_bwd_plain(dh: torch.Tensor, dy: torch.Tensor,
                                x: torch.Tensor, res: torch.Tensor,
                                scale: torch.Tensor, *, eps: float = 1e-5
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dsum in x's dtype, the gradient of both x and res;
    dscale in scale's dtype), all arithmetic in fp32."""
    dsum, dhn = _bwd_rows(dh, dy, x, res, scale, eps)
    dscale = dhn.reshape(-1, x.shape[-1]).sum(dim=0)
    return dsum.to(x.dtype), dscale.to(scale.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ticket_counters(device: torch.device, stream) -> torch.Tensor:
    """The stream's two ticket counters: allocated and zeroed once, on the
    stream, at the first call for this (device, stream); every launch
    leaves them zero.  A CUDA graph captured on ``stream`` needs them made
    before its capture begins (call this, or run the backward once on the
    stream): made inside a capture, they would come from the graph's
    private pool and their zeroing would be a node of the graph, so a call
    that would create them there raises."""
    key = (device.index, stream.cuda_stream)
    if key not in _COUNTERS:
        with torch.cuda.stream(stream):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "fused_add_rmsnorm_bwd: the ticket counters of a stream "
                    "under graph capture must be created before the capture "
                    "(fused.ticket_counters(device, stream))")
            _COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTERS[key]


_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                 + [ctypes.c_float, ctypes.c_void_p])


def fused_add_rmsnorm_bwd_cuda(dh: torch.Tensor, dy: torch.Tensor,
                               x: torch.Tensor, res: torch.Tensor,
                               scale: torch.Tensor, *, eps: float = 1e-5
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on PyTorch's current stream, at
    ``bwd_plan`` over ``rmsnorm.plan`` of all five inputs at
    ``BWD_WARP_VALS``; raises on any tensor it does not take and on a
    refused launch."""
    for t in (dh, dy, x, res, scale):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("fused_add_rmsnorm_bwd_cuda: dh, dy, x, res, "
                             "scale must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("fused_add_rmsnorm_bwd_cuda: tensors must be "
                             "contiguous")
    if dh.shape != x.shape or dy.shape != x.shape or dh.dtype != x.dtype \
            or dy.dtype != x.dtype:
        raise ValueError(f"fused_add_rmsnorm_bwd_cuda: dh {tuple(dh.shape)} "
                         f"{dh.dtype}, dy {tuple(dy.shape)} {dy.dtype} do not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    dsum = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dsum, dscale.zero_()
    bp = bwd_plan(
        rows, d, x.element_size(),
        rn.plan(x, res, scale, dh, dy, warp_vals=BWD_WARP_VALS),
        _sm_count(x.device.index))
    partial = torch.empty((bp.blocks, d), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device)
    counter = ticket_counters(x.device, stream)
    lib = _build.load("fused_add_rmsnorm_bwd")
    fn = lib.repro_fused_add_rmsnorm_bwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    rc = fn(dh.data_ptr(), dy.data_ptr(), x.data_ptr(), res.data_ptr(),
            scale.data_ptr(), dsum.data_ptr(), dscale.data_ptr(),
            partial.data_ptr(), counter.data_ptr(), _DTYPE_CODE[x.dtype],
            x.device.index, rows, d, int(bp.vector), bp.vals,
            bp.warps_per_row, bp.rows_per_step, bp.rows_per_block, bp.blocks,
            bp.stages, eps, stream.cuda_stream)
    _build.check(lib, rc, "fused_add_rmsnorm_bwd", _BWD_ERRORS)
    del partial   # freed in stream order, after the kernel
    return dsum, dscale
