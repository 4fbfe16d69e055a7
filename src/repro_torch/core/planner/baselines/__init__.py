"""Baseline planner registry (paper Table 1 comparison set)."""
from repro_torch.core.planner.baselines import (amp, common, dtfm, flashflex,
                                          galvatron, metis, piper, varuna)

REGISTRY = {
    "piper": piper.plan,
    "amp": amp.plan,
    "varuna": varuna.plan,
    "metis": metis.plan,
    "flashflex": flashflex.plan,
    "dtfm": dtfm.plan,
    "galvatron": galvatron.plan,
}
