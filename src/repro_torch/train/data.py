"""Deterministic synthetic data pipeline (counterpart of
``repro/train/data.py``, a plain copy).

Generates LM token streams (plus stub frame/patch embeddings for the
audio/VLM archs) from numpy's counter-based PRNG keyed on ``(seed, step)``,
so any batch is reproducible from its step index alone, and the same seed
and step give the reference's batch exactly.  Tokens follow a Zipf-ish
distribution rather than uniform so the loss curve moves like real text
early in training.  Batches are numpy arrays; ``train_step`` moves them to
the params' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    num_microbatches: int = 1
    seed: int = 0

    @property
    def micro_batch(self) -> int:
        assert self.global_batch % self.num_microbatches == 0
        return self.global_batch // self.num_microbatches


class SyntheticDataset:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig):
        self.cfg = cfg
        self.dc = data_cfg
        # Zipf weights over the vocab (stationary across steps).
        v = cfg.vocab_size
        rank = np.arange(1, v + 1, dtype=np.float64)
        w = 1.0 / rank ** 1.1
        self._probs = w / w.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Returns arrays shaped (num_micro, micro_batch, ...)."""
        rng = self._rng(step)
        nm, mb, s = (self.dc.num_microbatches, self.dc.micro_batch,
                     self.dc.seq_len)
        n_text = s
        if self.cfg.family == "vlm":
            n_text = s - self.cfg.n_patches
        toks = rng.choice(self.cfg.vocab_size, size=(nm, mb, n_text + 1),
                          p=self._probs).astype(np.int32)
        out = {"tokens": toks[..., :-1]}
        labels = toks[..., 1:]
        if self.cfg.family == "vlm":
            pats = rng.standard_normal(
                (nm, mb, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32) * 0.02
            out["patches"] = pats
            ign = np.full((nm, mb, self.cfg.n_patches), -100, np.int32)
            labels = np.concatenate([ign, labels], axis=-1)
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (nm, mb, self.cfg.n_frames, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        out["labels"] = labels
        return out
