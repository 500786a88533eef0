"""The PE engine: dispatch seam + execution context."""
from repro_torch.engine.context import PEContext
from repro_torch.engine.dispatch import (BACKENDS, op_key, pe_dot,
                                         pe_fused_attn_unit, up_key)

__all__ = ["PEContext", "BACKENDS", "op_key", "pe_dot", "pe_fused_attn_unit",
           "up_key"]
