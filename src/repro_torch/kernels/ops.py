"""Public wrappers for the kernels, with explicit SR entropy.

Every wrapper takes ``rbits`` explicitly, so tests can inject the bits the
reference generated; a live caller draws them with :func:`make_rbits`
from a ``torch.Generator`` (torch's Philox never reproduces the
reference's threefry bits).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.rounding import make_rbits
from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels import sr_matmul as _mm

fused_attn_unit = _df.fused_attn_unit


def sr_matmul(a: torch.Tensor, b: torch.Tensor,
              generator: Optional[torch.Generator] = None, *,
              sr: bool = False, lo: bool = False,
              rbits: Optional[torch.Tensor] = None,
              trans_b: bool = False) -> torch.Tensor:
    """bf16 matmul, f32 accumulation, optional fused SR-bf16 writeback.

    sr=True rounds with `rbits` when given, else with bits drawn from
    `generator` (lo=True: the shared-entropy layout).
    """
    if sr and rbits is None:
        if generator is None:
            raise ValueError("sr=True needs rbits or a generator")
        n = b.shape[0] if trans_b else b.shape[1]
        rbits = make_rbits((a.shape[0], n), generator, device=a.device,
                           lo=lo)
    return _mm.sr_matmul(a, b, rbits if sr else None, trans_b=trans_b)


__all__ = ["make_rbits", "sr_matmul", "fused_attn_unit"]
