"""outer_accum: the UP-phase weight update dW = scale * X^T dY (+ SR cast).

Port of the TPU kernel ``repro/kernels/outer_accum.py::outer_accum``.
The CUDA kernels are ``csrc/outer_accum.cu`` and the mainloop it shares
with sr_matmul, ``csrc/gemm_sm90.cuh`` (their headers say what bounds it
on the H100 and how it reads X transposed and masks ragged edges);
:func:`outer_accum_plain` is its plain torch version.  :func:`outer_accum`
runs the plain version for tensors on the CPU and a kernel for tensors
on a CUDA device — never one in place of the other.  Operands are both
bf16 (tensor cores) or both f32 (the fp32 preset, f32 FMA).  bf16
operands take the ``sm90`` or the ``generic`` path by
:func:`repro_torch.kernels.sr_matmul.plan`, each with its own launch
counter.

:func:`outer_accum_batched` is the kernel's batched mode, the TPU kernel
under ``jax.vmap`` (``repro/engine/dispatch.py:220-229``: one
``pallas_call`` with an expert axis in its grid): dW[e] = scale *
X[e]^T dY[e] for the E experts of a MoE table, ONE launch a call,
planned over all E experts' tiles: bf16 operands on the sm90 path
(:func:`batched_plan`; ``csrc/gemm_sm90_batched.cuh``, whose reduction
stops at each expert's live tokens when given their count), f32 or
SR-bf16 out with each expert's bits at its own offset; f32 operands
(the fp32 preset) on the f32 path (:func:`batched_f32_plan`;
``csrc/sgemm_sm90_batched.cuh``, whose token loop stops at each
expert's live count too), f32 out with no SR.  It has its own counter
(``outer_accum:batched``) besides ``outer_accum`` and the path's;
:func:`outer_accum_batched_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.rounding import sr_cast_bf16
from repro_torch.kernels import build
from repro_torch.kernels.sr_matmul import (PATHS, Plan, aligned16,
                                           check_rows, launch_error,
                                           launch_geometry, live_rows, plan,
                                           row_stride, split_workspace,
                                           takes_view)

COUNTER = build.LaunchCounter("outer_accum")   # every launch, any path
PATH_COUNTERS = {p: build.LaunchCounter(f"outer_accum:{p}") for p in PATHS}
BATCHED_COUNTER = build.LaunchCounter("outer_accum:batched")


@functools.lru_cache(maxsize=None)
def _bind(lib: ctypes.CDLL, name: str = "outer_accum"):
    """The C entry point `name`, without argtypes (sr_matmul._bind):
    pointers as ctypes.c_void_p or None, ints as Python ints, the scale
    as a ctypes.c_float."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    return fn


def _shapes(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"outer_accum takes x (T, D) and dy (T, F), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    return x.shape[0], x.shape[1], dy.shape[1]


def up_plan(x: torch.Tensor, dy: torch.Tensor) -> Plan:
    """The plan of dW = X^T dY for x (T, D), dy (T, F): A = X^T is
    M-major, dY N-major; D is a weight dimension, so its tiles count
    towards filling the card (f32 operands: sr_matmul.f32_plan)."""
    t, d, f = _shapes(x, dy)
    return plan(d, f, t, "m", "n", lda=row_stride(x), ldb=row_stride(dy),
                aligned=aligned16(x, dy), rows_invariant=False,
                f32=x.dtype == torch.float32)


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

    Operands both bf16 (unit inner stride, row stride at least the row
    length) or both f32 and contiguous.  Returns f32 without rbits,
    SR-bf16 with rbits (32-bit patterns, (D, F)).  CPU tensors take the
    plain version; CUDA tensors launch a hand-written kernel on the
    current stream (no synchronisation), and anything the kernels do not
    take raises.
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
    f32 = x.dtype == torch.float32
    if f32 and not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("outer_accum kernel takes contiguous f32 operands")
    if not (takes_view(x) and takes_view(dy)):
        raise ValueError("outer_accum kernel takes bf16 operands with unit "
                         "inner stride and rows no closer than their length")
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
    ldx, ldy = row_stride(x), row_stride(dy)
    # the (i, j, l) nest over (D, F, T) at the plan's tiles
    p, grid_x, grid_y, _, kb = launch_geometry(
        d, f, t, "m", "n", ldx, ldy, aligned16(x, dy), False, f32)
    if f32:
        ws = split_workspace(p, d, f, x.device)
    else:
        ws = (torch.empty((p.splits, d, f), dtype=torch.float32,
                          device=x.device) if p.splits > 1 else None)
    err = _bind(build.load("outer_accum"))(
        build.ptr(x), build.ptr(dy), build.ptr(rbits) if sr else None,
        build.ptr(out), build.ptr(ws) if ws is not None else None, t, d, f,
        ldx, ldy, ctypes.c_float(scale), int(sr), int(f32),
        int(p.path == "sm90"),
        p.bn, p.splits, kb, grid_x, grid_y, build.stream_ptr(x.device))
    if err != 0:
        raise launch_error("outer_accum", err)
    COUNTER.n += 1
    PATH_COUNTERS[p.path].n += 1
    return out


def _batched_shapes(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    if (x.dim() != 3 or dy.dim() != 3 or x.shape[0] != dy.shape[0]
            or x.shape[1] != dy.shape[1]):
        raise ValueError(f"outer_accum_batched takes x (E, T, D) and dy "
                         f"(E, T, F), got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    return tuple(x.shape) + (dy.shape[2],)


def batched_plan(e: int, t: int, d: int, f: int) -> Plan:
    """The plan of one expert's dW (D, F) = X^T dY in a batched call: A =
    X^T M-major, dY N-major, every expert's row and column tiles counted
    once towards filling the card (sr_matmul.plan, experts=E)."""
    return plan(d, f, t, "m", "n", rows_invariant=False, experts=e)


def batched_f32_plan(e: int, t: int, d: int, f: int) -> Plan:
    """The plan of one expert's f32 dW (D, F) = X^T dY in a batched call:
    sr_matmul.f32_plan over every expert's tiles."""
    return plan(d, f, t, "m", "n", f32=True, experts=e)


def outer_accum_batched_plain(x: torch.Tensor, dy: torch.Tensor, *,
                              scale: float = 1.0,
                              rbits: Optional[torch.Tensor] = None,
                              rows: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """:func:`outer_accum_plain` expert by expert: (E, D, F), f32, or
    SR-bf16 from rbits (E, D, F).  rows: only the tokens of x[e] and
    dy[e] below rows[e] enter the sum (the kernel's contract: the rest
    are zero)."""
    e, t, d, f = _batched_shapes(x, dy)
    check_rows(rows, e, x.device, "outer_accum_batched")
    if e == 0:
        return torch.empty((0, d, f), device=x.device,
                           dtype=torch.float32 if rbits is None
                           else torch.bfloat16)
    if rows is not None:
        live = live_rows(rows, t)[..., None]
        x, dy = torch.where(live, x, 0.0), torch.where(live, dy, 0.0)
    return torch.stack([outer_accum_plain(
        x[i], dy[i], scale=scale, rbits=None if rbits is None else rbits[i])
        for i in range(e)])


def outer_accum_batched(x: torch.Tensor, dy: torch.Tensor, *,
                        scale: float = 1.0,
                        rbits: Optional[torch.Tensor] = None,
                        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, T, D), dy (E, T, F) -> dW (E, D, F) = scale * x[e]^T dy[e]
    for every expert e, in ONE launch.

    Operands both bf16, each contiguous and 16-byte aligned, with D and
    F multiples of 8, so that TMA describes them (the sm90 path): f32
    out without rbits, SR-bf16 with rbits (32-bit patterns, (E, D, F),
    contiguous).  rows: (E,) int32 on the operands' device, each
    expert's live tokens — the contract is that the tokens of x[e] and
    dy[e] at or past rows[e] are zero, so each tile's reduction stops at
    ceil(rows[e] / 64) token blocks; the result is still x[e]^T dy[e]
    (up to the sign of a zero).  Or both f32 and contiguous (the f32
    path, the fp32 preset): f32 out, no rbits (an f32 weight is not
    rounded), the reduction stopped at ceil(rows[e] / 16) token blocks.
    Anything else raises; there is no generic fallback.  CPU tensors take
    the plain version.
    """
    e, t, d, f = _batched_shapes(x, dy)
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return outer_accum_batched_plain(x, dy, scale=scale, rbits=rbits,
                                         rows=rows)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"outer_accum_batched: operands on {x.device} and "
                         f"{dy.device}")
    dt = x.dtype
    if dy.dtype != dt or dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"outer_accum_batched kernel takes two bf16 or two "
                        f"f32 operands, got {dt}, {dy.dtype}")
    check_rows(rows, e, x.device, "outer_accum_batched")
    if dt == torch.float32:
        return _batched_f32(x, dy, e, t, d, f, scale, rbits, rows)
    if not (x.is_contiguous() and dy.is_contiguous() and aligned16(x, dy)
            and d % 8 == 0 and f % 8 == 0):
        raise ValueError(
            "outer_accum_batched kernel takes contiguous, 16-byte aligned "
            "operands with 16-byte rows (D and F multiples of 8): the TMA "
            "describes no other")
    sr = rbits is not None
    if sr and (rbits.shape != (e, d, f) or rbits.device != x.device
               or rbits.dtype not in (torch.int32, torch.uint32)
               or not rbits.is_contiguous()):
        raise ValueError("outer_accum_batched: rbits must be contiguous "
                         "32-bit (E, D, F) on the operands' device")
    out = torch.empty((e, d, f), dtype=torch.bfloat16 if sr else
                      torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    p = batched_plan(e, t, d, f)
    gx, gy, _ = p.grid(d, f, t)
    ws = (torch.empty((p.splits, e, d, f), dtype=torch.float32,
                      device=x.device) if p.splits > 1 else None)
    err = _bind(build.load("outer_accum"), "outer_accum_batched_bf16")(
        build.ptr(x), build.ptr(dy), build.ptr(rbits) if sr else None,
        build.ptr(out), build.ptr(ws) if ws is not None else None,
        build.ptr(rows) if rows is not None else None, e, t, d, f,
        ctypes.c_float(scale), int(sr), p.bn, p.splits, p.kb_per_split(t),
        gx, gy, build.stream_ptr(x.device))
    if err != 0:
        raise launch_error("outer_accum_batched", err)
    COUNTER.n += 1
    PATH_COUNTERS["sm90"].n += 1
    BATCHED_COUNTER.n += 1
    return out


def _batched_f32(x, dy, e: int, t: int, d: int, f: int, scale: float,
                 rbits: Optional[torch.Tensor],
                 rows: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`outer_accum_batched` of two f32 operands: one launch of
    ``csrc/sgemm_sm90_batched.cuh``'s kernel under
    :func:`batched_f32_plan`, each expert's reduction stopped at its
    `rows` live tokens."""
    if rbits is not None:
        raise ValueError("outer_accum_batched: f32 operands take no rbits "
                         "(the f32 batched form has no SR epilogue)")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("outer_accum_batched kernel takes contiguous f32 "
                         "operands")
    out = torch.empty((e, d, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    p = batched_f32_plan(e, t, d, f)
    gx, gy, _ = p.grid(d, f, t)
    ws = split_workspace(p, d, f, x.device, experts=e)
    err = _bind(build.load("outer_accum"), "outer_accum_batched_f32")(
        build.ptr(x), build.ptr(dy), build.ptr(out),
        build.ptr(ws) if ws is not None else None,
        build.ptr(rows) if rows is not None else None, e, t, d, f,
        ctypes.c_float(scale), p.splits, p.kb_per_split(t), gx, gy,
        build.stream_ptr(x.device))
    if err != 0:
        raise launch_error("outer_accum_batched", err)
    COUNTER.n += 1
    PATH_COUNTERS["f32"].n += 1
    BATCHED_COUNTER.n += 1
    return out
