"""Flags and devices shared by the examples."""
from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Sequence

import torch

from repro_torch.launch.train import local_devices


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's parser: its docstring's first line as the description,
    and ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def positions(device: str, n: int) -> List[torch.device]:
    """``n`` mesh positions of ``device``'s kind: the visible cards in
    turn (``[cuda:0] * n`` on one card), or ``[cpu] * n``."""
    devices = local_devices(device)
    return [devices[i % len(devices)] for i in range(n)]


def synchronize(devices: Sequence[torch.device]) -> None:
    """Wait for every card among ``devices`` (a timed step ends here)."""
    for index in sorted({d.index for d in devices if d.type == "cuda"}):
        torch.cuda.synchronize(index)


def fresh_checkpoints(workdir: str) -> None:
    """Remove the checkpoints (``step-*``, ``tmp-*``) an earlier run left
    in ``workdir``, and nothing else: a stale one would be restored."""
    if not os.path.isdir(workdir):
        return
    for name in os.listdir(workdir):
        if name.startswith(("step-", "tmp-")):
            shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)
