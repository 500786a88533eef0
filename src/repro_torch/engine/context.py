"""PEContext: the execution context of the PE engine.

Carries the compiled program, the kernel backend, the phase whose
program-word column :meth:`PEContext.dot` runs and, for training, the
step's UP-phase entropy key.  Every weight-bearing matmul of the model
code calls ``sh.dot(op_name, x, w)``.  Single device: the reference's
sharding constraints have no counterpart here yet.

Serving contexts default to ``Phase.PREFILL``; a training context is
built with ``phase=Phase.FF`` (autograd then runs BP and UP).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.phases import Phase
from repro_torch.engine.dispatch import BACKENDS, DEFAULT_WORD, op_key, pe_dot


@dataclass
class PEContext:
    program: Optional[object] = None     # core.program.Program
    backend: str = "reference"           # reference | cuda
    phase: Phase = Phase.PREFILL
    key: Optional[int] = None            # the step's UP-phase entropy key

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown kernel backend {self.backend!r}; "
                             f"one of {BACKENDS}")

    def with_phase(self, phase: Phase) -> "PEContext":
        return dataclasses.replace(self, phase=phase)

    def with_key(self, key: int) -> "PEContext":
        """Per-step copy carrying the step's SR entropy key."""
        return dataclasses.replace(self, key=key)

    def word(self, op_name: str):
        if self.program is not None:
            return self.program.pe_word(op_name)
        return dataclasses.replace(DEFAULT_WORD, op=op_name)

    def dot(self, op_name: str, x: torch.Tensor, w: torch.Tensor, *,
            transpose_w: bool = False,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """THE seam: one weight-bearing matmul under op_name's word (rows:
        an expert table's live rows an expert, see ``pe_dot``)."""
        # the reference backend draws no entropy: no key to derive
        key = op_key(self.key, op_name) if self.backend == "cuda" else None
        return pe_dot(x, w, word=self.word(op_name), backend=self.backend,
                      transpose_w=transpose_w, phase=self.phase, key=key,
                      rows=rows)
