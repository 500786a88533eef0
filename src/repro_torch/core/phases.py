"""Training and serving phases (the paper's §2 decomposition).

FF / BP / UP are the training phases; PREP the data re-layout between
flow changes.  Serving adds PREFILL (a prompt chunk on the MAC array),
DECODE (the bandwidth-bound width-1 step) and DRAFT (the speculative draft
model's width-1 step).  Each phase selects its own column of the PE
program word (core/program.py).
"""
from __future__ import annotations

import enum


class Phase(str, enum.Enum):
    FF = "FF"
    BP = "BP"
    UP = "UP"
    PREP = "PREP"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    DRAFT = "DRAFT"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


TRAINING_PHASES = (Phase.FF, Phase.BP, Phase.UP)
SERVING_PHASES = (Phase.PREFILL, Phase.DECODE)
SPECULATIVE_PHASES = (Phase.PREFILL, Phase.DECODE, Phase.DRAFT)
