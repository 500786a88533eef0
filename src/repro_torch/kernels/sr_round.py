"""sr_round: elementwise f32 -> bf16 stochastic rounding from given bits.

Port of the TPU kernel ``repro/kernels/sr_round.py::sr_round``.  The
CUDA kernel is ``csrc/sr_round.cu`` (a grid-stride pass over the shared
``sr_bf16_bits`` epilogue); :func:`sr_round_plain` is its plain torch
version (``core.rounding.sr_cast_bf16``).  :func:`sr_round` runs the
plain version for tensors on the CPU and the kernel for tensors on a
CUDA device — never one in place of the other.  It takes any contiguous
f32 tensor, viewed flat (an optimizer leaf such as a stacked
(24, 896, 9728) table is rounded in one launch, without a copy).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels import build

COUNTER = build.LaunchCounter("sr_round")
THREADS = 256
MAX_BLOCKS = 132 * 16            # 16 resident 256-thread blocks per SM


def _bind(lib: ctypes.CDLL):
    fn = lib.sr_round
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sr_round_plain(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    return sr_cast_bf16(x, rbits)


def sr_round(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """x f32, rbits 32-bit of x's shape -> bf16 of x's shape.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (no synchronisation), and anything the kernel does
    not take raises.
    """
    if tuple(rbits.shape) != tuple(x.shape):
        raise ValueError(f"sr_round: rbits {tuple(rbits.shape)} for x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu" and rbits.device.type == "cpu":
        return sr_round_plain(x, rbits)
    if x.device.type != "cuda" or rbits.device != x.device:
        raise ValueError(f"sr_round: tensors on {x.device} and "
                         f"{rbits.device}")
    if x.dtype != torch.float32 or rbits.dtype not in (torch.int32,
                                                       torch.uint32):
        raise TypeError(f"sr_round kernel takes f32 x and 32-bit rbits, got "
                        f"{x.dtype}, {rbits.dtype}")
    if not (x.is_contiguous() and rbits.is_contiguous()):
        raise ValueError("sr_round kernel takes contiguous tensors")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    blocks = max(1, min(MAX_BLOCKS, -(-n // (4 * THREADS))))
    err = _bind(build.load("sr_round"))(
        build.ptr(x), build.ptr(rbits), build.ptr(out), n, blocks,
        build.stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"sr_round kernel launch failed (cudaError {err})")
    COUNTER.n += 1
    return out
