"""Device and dtype helpers shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceArg = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: DeviceArg = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit request this raises; it never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ...) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_DTYPES)}") from None


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """``torch_dtype``'s inverse: ``torch.bfloat16`` -> ``"bfloat16"``,
    the name configs, cost tables and autotune keys write."""
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor in a (nested dict) params tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = device_of(v)
            if d is not None:
                return d
    return None
