"""Input stand-ins per (arch x shape) cell (counterpart of
``repro/launch/shapes.py``).

No device allocation: where the reference builds ``ShapeDtypeStruct``s
with their ``NamedSharding``s, the port builds ``placement.Sharded``
trees of fake tensors (``torch._subclasses.FakeTensor``), one block a
mesh position, laid out by the port's own specs (``sharding.param_specs``,
``batch_spec``, ``serve_step.cache_specs``), so the port's real step can
run on them (``launch/dryrun.py``).

The fakes live on ``meta`` stand-ins of the mesh's devices
(``stand_in_mesh``: each distinct device, in the order it first appears,
becomes ``meta:i``).  A fake CUDA tensor runs a forward on a build
without CUDA, but the autograd engine needs the device's runtime for a
backward (a CPU-only build aborts the process; a CUDA build has one queue
a card it owns), and a stand-in needs neither.  The dry run prices the
stand-ins as the cards (``device.meta_stands_for_cuda``), so every route
picked by device is the card's.

Applicability rules (the reference's):
  * long_500k needs sub-quadratic attention -> run only for ssm/hybrid/SWA
    archs; full-attention archs return a skip marker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import torch_dtype
from repro_torch.dist import placement as pm
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import Mesh
from repro_torch.dist.sharding import P
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShapeConfig, get_shape
from repro_torch.serve import serve_step

@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    kind: str                       # train | prefill | decode
    args: Tuple                     # Sharded trees of fakes for the step fn
    num_microbatches: int = 1
    skip_reason: Optional[str] = None
    mesh: Optional[Mesh] = None     # the stand-in mesh the args lie on
    # stand-in device name -> the device it stands in for
    devices: Dict[str, str] = dataclasses.field(default_factory=dict)
    mode: Optional[FakeTensorMode] = None


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is full-attention (skip per assignment)")
    return None


def num_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                     mesh: Mesh) -> int:
    if shape.kind != "train":
        return 1
    if shape.num_microbatches:
        return shape.num_microbatches
    dp = int(np.prod([mesh.shape[a] for a in shd.dp_axes(mesh)]))
    # keep per-shard microbatch tokens ~<= 8k so remat'd activations of the
    # widest archs stay inside 16 GB (see DESIGN.md §9)
    per_shard = shape.global_batch // max(dp, 1)
    target_seqs = max(1, 8192 // shape.seq_len)
    nm = 1
    while (per_shard // nm) > target_seqs and nm < 8:
        nm *= 2
    while shape.global_batch % (nm * dp) != 0 and nm > 1:
        nm //= 2
    return nm


def stand_in_mesh(mesh: Mesh) -> Tuple[Mesh, Dict[str, str]]:
    """``mesh`` with each distinct device replaced by ``meta:i`` (i in
    order of first appearance), and the map from stand-in to device."""
    order: Dict[torch.device, torch.device] = {}
    for d in mesh.device_list:
        order.setdefault(d, torch.device("meta", len(order)))
    grid = np.empty(mesh.size, dtype=object)
    grid[:] = [order[d] for d in mesh.device_list]
    return (Mesh(grid.reshape(mesh.devices.shape), mesh.axis_names),
            {str(s): str(d) for d, s in order.items()})


def _fake(shape, dtype: torch.dtype, mesh: Mesh, spec) -> pm.Sharded:
    """A ``Sharded`` of fresh fakes: one block a position, its own
    storage, as ``placement.shard`` lays a tensor out."""
    spec = pm.check_spec(shape, spec, mesh)
    blocks = []
    for p, d in enumerate(mesh.device_list):
        sl = pm.block_slices(shape, spec, mesh, p)
        blocks.append(torch.empty(tuple(s.stop - s.start for s in sl),
                                  dtype=dtype, device=d))
    return pm.Sharded(tuple(shape), spec, mesh, blocks)


def _tree(decls, specs, fn) -> Dict[str, Any]:
    flat = dict(pm.tree_items(specs))
    out: Dict[str, Any] = {}
    for path, d in shd.iter_decls(decls):
        shd.set_path(out, path, fn(d, flat[path]))
    return out


def param_fakes(cfg: ModelConfig, mesh: Mesh):
    decls = model_lib.decls(cfg)
    specs = shd.param_specs(decls, cfg.sharding, mesh)
    dt = torch_dtype(cfg.param_dtype)
    return _tree(decls, specs, lambda d, s: _fake(d.shape, dt, mesh, s))


def opt_fakes(cfg: ModelConfig, mesh: Mesh):
    def moments():
        decls = model_lib.decls(cfg)
        specs = shd.param_specs(decls, cfg.sharding, mesh)
        return _tree(decls, specs,
                     lambda d, s: _fake(d.shape, torch.float32, mesh, s))
    return {"m": moments(), "v": moments(),
            "step": _fake((), torch.int32, mesh, P())}


def batch_fakes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                nm: int) -> Dict[str, pm.Sharded]:
    mb = shape.global_batch // nm
    dp = shd.batch_spec(mesh, mb)[0]
    s = shape.seq_len
    n_text = s - cfg.n_patches if cfg.family == "vlm" else s
    out = {
        "tokens": _fake((nm, mb, n_text), torch.int32, mesh, P(None, dp, None)),
        "labels": _fake((nm, mb, s), torch.int32, mesh, P(None, dp, None)),
    }
    if cfg.family == "encdec":
        out["frames"] = _fake((nm, mb, cfg.n_frames, cfg.d_model),
                              torch.bfloat16, mesh, P(None, dp, None, None))
    if cfg.family == "vlm":
        out["patches"] = _fake((nm, mb, cfg.n_patches, cfg.d_model),
                               torch.bfloat16, mesh, P(None, dp, None, None))
    return out


def infer_batch_fakes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    """Prefill inputs: (B, S) without the microbatch dim."""
    b = shape.global_batch
    dp = shd.batch_spec(mesh, b)[0]
    s = shape.seq_len
    n_text = s - cfg.n_patches if cfg.family == "vlm" else s
    out = {"tokens": _fake((b, n_text), torch.int32, mesh, P(dp, None))}
    if cfg.family == "encdec":
        out["frames"] = _fake((b, cfg.n_frames, cfg.d_model), torch.bfloat16,
                              mesh, P(dp, None, None))
    if cfg.family == "vlm":
        out["patches"] = _fake((b, cfg.n_patches, cfg.d_model),
                               torch.bfloat16, mesh, P(dp, None, None))
    return out


def cache_fakes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh):
    decls = model_lib.cache_decls(cfg, shape.global_batch, shape.seq_len)
    specs = serve_step.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   mesh)

    def mk(d: shd.Decl, s: P):
        # the reference writes bf16, every catalog config's dtype; the
        # port's cache is in cfg.dtype (a reduced fp32 config decodes too)
        dt = torch.int32 if d.shape == () else torch_dtype(cfg.dtype)
        if "ssm" in str(d.axes) and len(d.shape) == 5:
            dt = torch.float32               # ssm states kept fp32
        return _fake(d.shape, dt, mesh, s)
    return {k: mk(d, specs[k]) for k, d in decls.items()}


def build_cell(cfg: ModelConfig, shape_name: Union[str, ShapeConfig],
               mesh: Mesh, nm_override: int = 0,
               mode: Optional[FakeTensorMode] = None) -> Cell:
    """The cell's stand-ins, made under ``mode`` (a fresh
    ``FakeTensorMode`` by default; the step must run under the same one)
    on ``stand_in_mesh(mesh)``.  ``shape_name`` names one of ``SHAPES``,
    or is a ``ShapeConfig`` of its own (a run's own batch)."""
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else get_shape(shape_name)
    if nm_override:
        shape = dataclasses.replace(shape, num_microbatches=nm_override)
    skip = applicable(cfg, shape)
    if skip:
        return Cell(cfg, shape, shape.kind, (), skip_reason=skip)
    mode = mode or FakeTensorMode()
    fake_mesh, devices = stand_in_mesh(mesh)
    cell = Cell(cfg, shape, shape.kind, (), mesh=fake_mesh, devices=devices,
                mode=mode)
    with mode:
        if shape.kind == "train":
            nm = num_microbatches(cfg, shape, fake_mesh)
            cell.args = (param_fakes(cfg, fake_mesh),
                         opt_fakes(cfg, fake_mesh),
                         batch_fakes(cfg, shape, fake_mesh, nm))
            cell.num_microbatches = nm
        elif shape.kind == "prefill":
            cell.args = (param_fakes(cfg, fake_mesh),
                         infer_batch_fakes(cfg, shape, fake_mesh))
        else:
            # decode: one new token against a seq_len cache
            b = shape.global_batch
            dp = shd.batch_spec(fake_mesh, b)[0]
            tokens = _fake((b, 1), torch.int32, fake_mesh, P(dp, None))
            cell.args = (param_fakes(cfg, fake_mesh),
                         cache_fakes(cfg, shape, fake_mesh), tokens)
    return cell

