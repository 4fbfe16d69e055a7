"""Production mesh shapes (counterpart of ``repro/launch/mesh.py``).

Single pod:  (16, 16)    -> ("data", "model")         = 256 devices
Multi-pod:   (2, 16, 16) -> ("pod", "data", "model")  = 512 devices, the
'pod' axis the slow domain.  Mesh construction lives in
``repro_torch.dist.mesh``; this module only pins the shapes.  Where the
reference always takes a prefix of ``jax.devices()``, ``devices`` may
name the devices (and repeat one): without it too few cards raise.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.dist import mesh as dist_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None
                         ) -> dist_mesh.Mesh:
    if multi_pod:
        return dist_mesh.pod_data_model_mesh(2, 16, 16, devices)
    return dist_mesh.data_model_mesh(16, 16, devices)
