"""The PE engine: dispatch seam + execution context."""
from repro_torch.engine.context import PEContext
from repro_torch.engine.dispatch import (BACKENDS, pe_dot,
                                         pe_fused_attn_unit)

__all__ = ["PEContext", "BACKENDS", "pe_dot", "pe_fused_attn_unit"]
