"""PMAG — the paper's nested address counters (§3.2) as launch arithmetic.

The reference maps the counter bank onto a Pallas grid and derives each
operand's BlockSpec from it.  A CUDA kernel computes its own offsets from
``blockIdx``, so the port keeps the counter bank as plain grid and tile
arithmetic: :func:`matmul_nest` gives the (i, j, l) nest a kernel
launches over — i and j become grid axes (:meth:`LoopNest.launch_grid`),
l, the reduction, the loop inside the block.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class LoopDim:
    """One nested counter: iterates ceil(size/tile) steps of width `tile`."""
    name: str
    size: int
    tile: int

    @property
    def steps(self) -> int:
        return math.ceil(self.size / self.tile)


@dataclass(frozen=True)
class LoopNest:
    """Ordered counter bank, outermost first (paper's r1 -> r7)."""
    dims: tuple

    def __post_init__(self) -> None:
        if len(self.dims) > 7:
            raise ValueError("PMAG has 7 counter levels (r1..r7)")
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate loop dims {names}")

    @property
    def grid(self) -> tuple:
        return tuple(d.steps for d in self.dims)

    def dim(self, name: str) -> LoopDim:
        for d in self.dims:
            if d.name == name:
                return d
        raise KeyError(f"no loop dim {name!r} in {[d.name for d in self.dims]}")

    def launch_grid(self, *names: str) -> tuple:
        """CUDA grid (x, y, z) over the named dims, x first."""
        return tuple(self.dim(n).steps for n in names)


def matmul_nest(m: int, n: int, k: int, *, tm: int, tn: int, tk: int
                ) -> LoopNest:
    """The canonical (i, j, l) matmul nest: the reduction l innermost, so
    the f32 partial-sum tile stays resident across it (§3.3.1)."""
    return LoopNest((LoopDim("i", m, tm), LoopDim("j", n, tn),
                     LoopDim("l", k, tk)))
