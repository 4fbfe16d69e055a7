"""Device and dtype helpers shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


# True inside ``meta_stands_for_cuda``: the dry run (``launch/dryrun.py``)
# runs a step on fake tensors whose devices are ``meta`` stand-ins for
# the mesh's cards, and the routes picked by device must be the card's
_META_IS_CUDA = False


@contextlib.contextmanager
def meta_stands_for_cuda() -> Iterator[None]:
    """Within the block, ``is_cuda_like`` takes a ``meta`` device for a CUDA
    device, so a step on ``meta`` stand-ins picks the kernel routes the
    card would take."""
    global _META_IS_CUDA
    old, _META_IS_CUDA = _META_IS_CUDA, True
    try:
        yield
    finally:
        _META_IS_CUDA = old


def is_cuda_like(device: Union[str, torch.device]) -> bool:
    """Whether the routes picked by device (the attention kernel, the SSD
    kernel) take the card's: a CUDA device, or a ``meta`` stand-in inside
    ``meta_stands_for_cuda``."""
    kind = torch.device(device).type
    return kind == "cuda" or (kind == "meta" and _META_IS_CUDA)


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
