"""Phases, precision, SR rounding, loop nests and the PE program words."""
from repro_torch.core.phases import Phase
from repro_torch.core.program import PEWord, Program, compile_program

__all__ = ["Phase", "PEWord", "Program", "compile_program"]
