"""Architecture registry of the port (counterpart of ``repro/configs``).

``get_config(name)`` resolves every registered architecture, as the
reference's does; each config module is a copy of the reference's.  The
analytic profiler prices every family; ``models.model.get_module`` raises
for a family whose model is not ported yet.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "smollm_360m",
    "qwen1_5_0_5b",
    "minitron_8b",
    "granite_20b",
    "mixtral_8x22b",
    "dbrx_132b",
    "zamba2_2_7b",
    "whisper_tiny",
    "mamba2_130m",
    "internvl2_26b",
]

PAPER_IDS: List[str] = ["opt_350m", "gpt_neo_2_7b"]

_ALIASES = {
    "smollm-360m": "smollm_360m",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "minitron-8b": "minitron_8b",
    "granite-20b": "granite_20b",
    "mixtral-8x22b": "mixtral_8x22b",
    "dbrx-132b": "dbrx_132b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-130m": "mamba2_130m",
    "internvl2-26b": "internvl2_26b",
    "opt-350m": "opt_350m",
    "gpt-neo-2.7b": "gpt_neo_2_7b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS + PAPER_IDS:
        raise KeyError(f"unknown arch {name!r}; "
                       f"known: {ARCH_IDS + PAPER_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
