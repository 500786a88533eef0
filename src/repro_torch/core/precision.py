"""Phase-dependent precision policy (paper §3.3.2, Table 4).

FF: bf16 operands, f32 accumulation; BP: bf16 operands; UP: f32 update
math with an SR cast of persistent state to bf16.  The serving phases run
the FF ladder.  Dtypes are torch dtypes; ``dtype_name`` gives the string
the PE program word carries (the reference's numpy names).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.phases import Phase

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def dtype_name(dt: torch.dtype) -> str:
    return _NAMES[dt]


def dtype_from_name(name: str) -> torch.dtype:
    for dt, n in _NAMES.items():
        if n == name:
            return dt
    raise KeyError(f"unknown dtype name {name!r}")


@dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    ff_dtype: torch.dtype
    bp_dtype: torch.dtype
    param_dtype: torch.dtype
    state_dtype: torch.dtype
    update_rounding: str                # nearest | sr | sr_lo

    def compute_dtype(self, phase: Phase) -> torch.dtype:
        return self.bp_dtype if phase in (Phase.BP, Phase.UP) else self.ff_dtype


_BF, _F32 = torch.bfloat16, torch.float32

PRESETS: dict = {
    "fp32": PrecisionPolicy("fp32", _F32, _F32, _F32, _F32, "nearest"),
    "bf16_fp32": PrecisionPolicy("bf16_fp32", _BF, _BF, _F32, _F32,
                                 "nearest"),
    "paper_sr_bf16": PrecisionPolicy("paper_sr_bf16", _BF, _BF, _BF, _BF,
                                     "sr"),
    "paper_sr_lo_bf16": PrecisionPolicy("paper_sr_lo_bf16", _BF, _BF, _BF,
                                        _BF, "sr_lo"),
    "bf16_nearest": PrecisionPolicy("bf16_nearest", _BF, _BF, _BF, _BF,
                                    "nearest"),
}


def get_policy(name: str) -> PrecisionPolicy:
    if name not in PRESETS:
        raise KeyError(f"unknown precision preset {name!r}; "
                       f"known: {sorted(PRESETS)}")
    return PRESETS[name]
