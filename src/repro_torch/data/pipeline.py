"""Deterministic synthetic data pipeline: the port's copy of the
reference's ``data/pipeline.py`` (numpy only).

``batch_at(step)`` is a pure function of (seed, step, host), so a
restart resumes bit-exactly by storing only the step counter, and the
port's batches equal the reference's bit for bit.  The token stream is a
mixture of Zipf-distributed ids with order-1 Markov structure, which
keeps losses non-degenerate.  Training batches of text only (the
port's models have no modality frontends; decode batches and the
host-thread prefetcher are not ported: the train loop reads
``batch_at(step)`` directly).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic synthetic LM batches for a (model, shape) cell."""

    def __init__(self, model: ModelConfig, shape: ShapeConfig,
                 cfg: PipelineConfig = PipelineConfig()):
        if shape.kind == "decode":
            raise ValueError("SyntheticLM makes training batches; decode "
                             "batches are not ported")
        self.model = model
        self.shape = shape
        self.cfg = cfg

    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        v = self.model.vocab_size
        # zipf with rejection to the vocab range, then light markov smoothing
        z = rng.zipf(self.cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        t = (z - 1) % v
        keep = rng.random((b, s + 1)) < 0.8
        for j in range(1, s + 1):        # cheap order-1 structure
            t[:, j] = np.where(keep[:, j], t[:, j], t[:, j - 1])
        return t.astype(np.int32)

    def batch_at(self, step: int, *, host_id: int = 0,
                 n_hosts: int = 1) -> dict:
        """Global-batch slice for this host at `step` (pure function)."""
        b_global, s = self.shape.global_batch, self.shape.seq_len
        if b_global % n_hosts:
            raise ValueError(f"global batch {b_global} does not split over "
                             f"{n_hosts} hosts")
        b = b_global // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, host_id]))
        t = self._tokens(rng, b, s)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}
