"""outer_accum: the UP-phase weight update dW = scale * X^T dY (+ SR cast).

Port of the TPU kernel ``repro/kernels/outer_accum.py::outer_accum``.
The CUDA kernel is ``csrc/outer_accum.cu`` (its header says what bounds
it on the H100 and how it reads X transposed and masks ragged edges);
:func:`outer_accum_plain` is its plain torch version.  :func:`outer_accum`
runs the plain version for tensors on the CPU and the kernel for
tensors on a CUDA device — never one in place of the other.  Operands
are both bf16 (tensor cores) or both f32 (the fp32 preset, f32 FMA).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.pmag import LoopDim, LoopNest
from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels import build

COUNTER = build.LaunchCounter("outer_accum")
# the kernel's block tile (bd, bf, bt): csrc/common.cuh TM, TN, TK
TILE = (32, 32, 64)


def _bind(lib: ctypes.CDLL):
    fn = lib.outer_accum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shapes(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"outer_accum takes x (T, D) and dy (T, F), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    return x.shape[0], x.shape[1], dy.shape[1]


def outer_accum_nest(t: int, d: int, f: int) -> LoopNest:
    """The (i, j, l) counter bank over (D, F, T): i and j become the grid,
    the token reduction l the block's loop."""
    bd, bf, bt = TILE
    return LoopNest((LoopDim("i", d, bd), LoopDim("j", f, bf),
                     LoopDim("l", t, bt)))


def outer_accum_plain(x: torch.Tensor, dy: torch.Tensor, *,
                      scale: float = 1.0,
                      rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scale * X^T dY with f32 accumulation; SR-cast when rbits given."""
    _shapes(x, dy)
    acc = torch.matmul(x.to(torch.float32).t(), dy.to(torch.float32)) * scale
    return acc if rbits is None else sr_cast_bf16(acc, rbits)


def outer_accum(x: torch.Tensor, dy: torch.Tensor, *, scale: float = 1.0,
                rbits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (T, D), dy (T, F) -> dW (D, F) = scale * x^T dy.

    Returns f32 without rbits, SR-bf16 with rbits (32-bit patterns,
    (D, F)).  CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernel on the current stream (no synchronisation), and
    anything the kernel does not take raises.
    """
    t, d, f = _shapes(x, dy)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return outer_accum_plain(x, dy, scale=scale, rbits=rbits)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"outer_accum: operands on {x.device} and "
                         f"{dy.device}")
    if x.dtype != dy.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"outer_accum kernel takes two bf16 or two f32 "
                        f"operands, got {x.dtype}, {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("outer_accum kernel takes contiguous operands")
    sr = rbits is not None
    if sr and (rbits.shape != (d, f) or rbits.device != x.device
               or rbits.dtype not in (torch.int32, torch.uint32)
               or not rbits.is_contiguous()):
        raise ValueError("outer_accum: rbits must be contiguous 32-bit "
                         "(D, F) on the operands' device")
    out = torch.empty((d, f), dtype=torch.bfloat16 if sr else torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    grid_x, grid_y = outer_accum_nest(t, d, f).launch_grid("j", "i")
    err = _bind(build.load("outer_accum"))(
        build.ptr(x), build.ptr(dy), build.ptr(rbits) if sr else None,
        build.ptr(out), t, d, f, float(scale), int(sr),
        int(x.dtype == torch.float32), grid_x, grid_y,
        build.stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"outer_accum kernel launch failed (cudaError "
                           f"{err})")
    COUNTER.n += 1
    return out
