"""sr_matmul: matmul with f32 accumulation, optional fused SR-bf16 cast.

Port of the TPU kernel ``repro/kernels/sr_matmul.py::sr_matmul``.  The
CUDA kernel is ``csrc/sr_matmul.cu`` (its header says what bounds it on
the H100 and how it is tiled); :func:`sr_matmul_plain` is its plain torch
version.  :func:`sr_matmul` runs the plain version for tensors on the
CPU and the kernel for tensors on a CUDA device — never one in place of
the other.  Operands are both bf16 (tensor cores) or both f32 (the fp32
preset: f32 FMA on the CUDA cores, no TF32).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.pmag import matmul_nest
from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels import build

COUNTER = build.LaunchCounter("sr_matmul")
# the kernel's block tile (tm, tn, tk): csrc/common.cuh TM, TN, TK
TILE = (32, 32, 64)


def _bind(lib: ctypes.CDLL, f32: bool):
    fn = lib.sr_matmul_f32 if f32 else lib.sr_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shapes(a: torch.Tensor, b: torch.Tensor, trans_b: bool) -> tuple:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"sr_matmul takes 2-D operands, got {tuple(a.shape)}"
                         f" and {tuple(b.shape)}")
    m, k = a.shape
    n, k2 = (b.shape if trans_b else (b.shape[1], b.shape[0]))
    if k != k2:
        raise ValueError(f"sr_matmul: inner dims differ: {tuple(a.shape)} x "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    return m, n, k


def sr_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                    rbits: Optional[torch.Tensor] = None, *,
                    trans_b: bool = False) -> torch.Tensor:
    """A @ B (or A @ B.T) with f32 accumulation; SR-cast when rbits given."""
    _shapes(a, b, trans_b)
    bf = b.to(torch.float32)
    acc = torch.matmul(a.to(torch.float32), bf.t() if trans_b else bf)
    return acc if rbits is None else sr_cast_bf16(acc, rbits)


def sr_matmul(a: torch.Tensor, b: torch.Tensor,
              rbits: Optional[torch.Tensor] = None, *,
              trans_b: bool = False) -> torch.Tensor:
    """a (M, K) @ b (K, N) — or a @ b.T for b (N, K) with trans_b.

    Operands both bf16 or both f32.  Returns f32 without rbits, SR-bf16
    with rbits (int32 bit patterns, (M, N)).  CPU tensors take the plain
    version; CUDA tensors launch the hand-written kernel on the current
    stream (no synchronisation), and anything the kernel does not take
    raises.
    """
    m, n, k = _shapes(a, b, trans_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sr_matmul_plain(a, b, rbits, trans_b=trans_b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sr_matmul: operands on {a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sr_matmul kernel takes two bf16 or two f32 "
                        f"operands, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sr_matmul kernel takes contiguous operands")
    sr = rbits is not None
    if sr and (rbits.shape != (m, n) or rbits.device != a.device
               or rbits.dtype not in (torch.int32, torch.uint32)
               or not rbits.is_contiguous()):
        raise ValueError("sr_matmul: rbits must be contiguous 32-bit (M, N) "
                         "on the operands' device")
    out = torch.empty((m, n), dtype=torch.bfloat16 if sr else torch.float32,
                      device=a.device)
    if out.numel() == 0:
        return out
    # the (i, j, l) counter bank: i, j become the grid, l the block's loop
    nest = matmul_nest(m, n, k, tm=TILE[0], tn=TILE[1], tk=TILE[2])
    grid_x, grid_y = nest.launch_grid("j", "i")
    fn = _bind(build.load("sr_matmul"), a.dtype == torch.float32)
    err = fn(build.ptr(a), build.ptr(b),
             build.ptr(rbits) if sr else None, build.ptr(out),
             m, n, k, int(trans_b), int(sr), grid_x, grid_y,
             build.stream_ptr(a.device))
    if err != 0:
        raise RuntimeError(f"sr_matmul kernel launch failed (cudaError {err})")
    COUNTER.n += 1
    return out
