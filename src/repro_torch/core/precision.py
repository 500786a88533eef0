"""Phase-dependent precision policy (paper §3.3.2, Table 4).

FF: bf16 operands, f32 accumulation; BP: bf16 operands; UP: f32 update
math with an SR cast of persistent state to bf16 (:meth:`writeback`).
The serving phases run the FF ladder.  Dtypes are torch dtypes;
``dtype_name`` gives the string the PE program word carries (the
reference's numpy names).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.phases import Phase
from repro_torch.core.rounding import round_nearest_bf16, sr_bits, sr_cast_bf16

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

    def cast_for(self, phase: Phase, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype(phase)
        return x.to(dt) if x.dtype != dt else x

    def writeback(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  rbits: Optional[torch.Tensor] = None,
                  round_fn: Callable = sr_cast_bf16) -> torch.Tensor:
        """UP-phase cast of persistent state to ``param_dtype``.

        SR modes round with `rbits` (the per-element bits of the mode's
        layout, :func:`~repro_torch.core.rounding.sr_bits`) when given,
        else with bits drawn from `generator`; `round_fn(x, rbits)` does
        the rounding (the sr_round kernel's wrapper on the cuda backend).
        """
        if self.param_dtype == torch.float32:
            return x.to(torch.float32)
        if self.update_rounding == "nearest":
            return round_nearest_bf16(x)
        if rbits is None:
            if generator is None:
                raise ValueError(f"{self.name}: SR writeback requires a "
                                 f"generator or rbits")
            rbits = sr_bits(self.update_rounding, x.shape, generator,
                            x.device)
        return round_fn(x.to(torch.float32).contiguous(), rbits)

    @property
    def bytes_per_param_state(self) -> int:
        """Training-state bytes/param (param + 2 Adam moments)."""
        p = self.param_dtype.itemsize
        s = self.state_dtype.itemsize
        return p + 2 * s


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
