"""selective_scan: Mamba's selective state-space recurrence, from a
carried state.

Replaces no TPU kernel: the reference leaves the recurrence to a
``lax.scan`` (``repro/models/ssm.py::selective_scan``).  On the card a
token loop of torch ops would launch several kernels a token and layer,
so the hot path runs the hand-written kernel ``csrc/selective_scan.cu``
(its header gives the design and what bounds it on the H100).
:func:`selective_scan_plain` is its plain torch version, the
reference's formula token by token:

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t
    y_t = C_t . h_t + D x_t

Shapes: x (B, S, di) bf16 or f32; dt (B, S, di) f32; A (di, N) f32;
B_t, C_t (B, S, N) f32; D (di,) f32; the state (B, di, N) f32.  Both
return y (B, S, di) in f32 and the final state, so a PREFILL chunk and
a DECODE step share one entry.  A given state is updated IN PLACE, on
the batch rows ``active`` selects (None = every row); without one the
recurrence starts from zeros.  Every device checks the same operands;
CPU tensors then take the plain version, CUDA tensors launch the kernel
as :func:`selective_scan_plan` lays it out, or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sr_matmul import SMS

COUNTER = build.LaunchCounter("selective_scan")
D_STATES = (4, 8, 16)             # csrc/selective_scan.cu's instantiations
X_DTYPES = (torch.float32, torch.bfloat16)
TILE = 32                         # tokens staged at once, at most
MAX_THREADS = 256                 # a block's (csrc: MAX_THREADS)
MAX_SMEM = 48 * 1024              # a block's shared memory (csrc: MAX_SMEM)
KP = 8                            # a thread's share of a tile (csrc: KP)
_F32, _F64 = torch.float32, torch.float64


class ScanPlan(NamedTuple):
    lanes: int      # a channel's lanes: N / 4, four states a lane
    channels: int   # channels a block
    tile: int       # tokens staged in shared memory at once
    threads: int    # channels x lanes, whole warps
    grid: tuple     # (ceil(di / channels), B)
    smem: int       # bytes of shared memory a block


def smem_bytes(N: int, channels: int, tile: int) -> int:
    """csrc/selective_scan.cu::smem_bytes: a tile's B and C (N floats a
    token each), x, dt and y (a float a channel and token each)."""
    return tile * (2 * N + 3 * channels) * 4


@functools.lru_cache(maxsize=256)
def selective_scan_plan(B: int, S: int, di: int, N: int) -> ScanPlan:
    """The launch of csrc/selective_scan.cu from (B, S, di, N) alone.

    Four states a lane (a float4: N / 4 lanes a channel), so a warp's
    state and A accesses are 512 contiguous bytes and a token's exps,
    products and pairwise sum run four to a thread.  Blocks of up to
    MAX_THREADS threads, halved (down to two warps) while the grid has
    fewer than two blocks an SM: a one-slot chunk at di 8192 runs 512
    blocks of 64 threads, a 32-slot step 4096 blocks of 256.  Tiles of
    up to TILE tokens whose x, dt, B and C are at most KP values a thread,
    halved until the block's shared memory fits MAX_SMEM."""
    if N not in D_STATES:
        raise ValueError(f"selective_scan kernel takes d_state in "
                         f"{D_STATES}, got {N}")
    lanes = N // 4
    channels = MAX_THREADS // lanes
    while channels * lanes > 64 and B * -(-di // channels) < 2 * SMS:
        channels //= 2
    # a tile's x and dt (tile x channels) and its B and C (tile x N) are
    # at most KP values a thread each
    tile = min(S, TILE, KP * lanes, KP * channels * lanes // N)
    while smem_bytes(N, channels, tile) > MAX_SMEM:
        tile //= 2
    return ScanPlan(lanes, channels, tile, channels * lanes,
                    (-(-di // channels), B), smem_bytes(N, channels, tile))


def selective_scan_plain(x, dt, A, Bm, Cm, D,
                         state0: Optional[torch.Tensor] = None):
    """The recurrence token by token; returns (y (B, S, di) f32, final
    state (B, di, N) f32); state0 is not modified.

    The updates are f32 elementwise, rounded as the reference rounds
    them; exp(dt A) and y's sum over the N state values run in f64 and
    round to f32, so a row's result does not depend on the batch shape
    (the reference backend's chunk == token-by-token invariant)."""
    Bsz, S, di = x.shape
    N = A.shape[1]
    h = (torch.zeros((Bsz, di, N), dtype=_F32, device=x.device)
         if state0 is None else state0.to(_F32).clone())
    A64 = A.to(_F64)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(_F32), dt[:, t].to(_F32)
        dA = torch.exp(dtt.to(_F64)[..., None] * A64).to(_F32)
        h = dA * h + (dtt * xt)[..., None] * Bm[:, t, None, :].to(_F32)
        ys.append((h.to(_F64) * Cm[:, t, None, :].to(_F64)).sum(-1)
                  .to(_F32))
    y = torch.stack(ys, dim=1) + x.to(_F32) * D.to(_F32)
    return y, h


def _check_operands(x, dt, A, Bm, Cm, D, state, active) -> None:
    """What the kernel takes, checked alike on every device."""
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"selective_scan: x must be (B, S>=1, di), got "
                         f"{tuple(x.shape)}")
    Bsz, S, di = x.shape
    N = A.shape[-1]
    want = {"dt": (dt, (Bsz, S, di)), "A": (A, (di, N)),
            "B": (Bm, (Bsz, S, N)), "C": (Cm, (Bsz, S, N)), "D": (D, (di,))}
    if state is not None:
        want["state"] = (state, (Bsz, di, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)} for "
                             f"{shape}")
    if x.dtype not in X_DTYPES:
        raise TypeError(f"selective_scan: x must be one of {X_DTYPES}, got "
                        f"{x.dtype}")
    f32 = [t for t, _ in want.values()]
    if any(t.dtype != _F32 for t in f32):
        raise TypeError("selective_scan: dt, A, B, C, D and the state must "
                        "be f32")
    ops = [x] + f32
    if any(t.device != x.device for t in ops):
        raise ValueError("selective_scan: operands on more than one device")
    if not all(t.is_contiguous() for t in ops):
        raise TypeError("selective_scan takes contiguous tensors")
    if active is not None and (state is None or active.shape != (Bsz,)):
        raise ValueError("selective_scan: `active` (B,) selects rows of a "
                         "given state")
    if any(t.data_ptr() % 16 for t in (A, state) if t is not None):
        raise TypeError("selective_scan: A and the state must start on 16 "
                        "bytes (the kernel reads them as float4s)")


def _bind(lib: ctypes.CDLL):
    fn = lib.selective_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, A, Bm, Cm, D, state, active):
    Bsz, S, di = x.shape
    N = A.shape[1]
    plan = selective_scan_plan(Bsz, S, di, N)
    dev = x.device
    y = torch.empty((Bsz, S, di), dtype=_F32, device=dev)
    s_out = state if state is not None else torch.empty(
        (Bsz, di, N), dtype=_F32, device=dev)
    act32 = (active.to(device=dev, dtype=torch.int32).contiguous()
             if active is not None else None)
    null = ctypes.c_void_p(None)
    err = _bind(build.load("selective_scan"))(
        build.ptr(x), build.ptr(dt), build.ptr(A), build.ptr(Bm),
        build.ptr(Cm), build.ptr(D),
        build.ptr(state) if state is not None else null, build.ptr(s_out),
        build.ptr(y), build.ptr(act32) if act32 is not None else null,
        Bsz, S, di, N, int(x.dtype == torch.bfloat16), plan.lanes,
        plan.channels, plan.tile, build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed "
                           f"(cudaError {err})")
    COUNTER.n += 1
    return y, s_out


def selective_scan_update_plain(x, dt, A, Bm, Cm, D,
                                state: Optional[torch.Tensor] = None, *,
                                active: Optional[torch.Tensor] = None):
    """:func:`selective_scan`'s semantics on the plain version: the given
    state updated in place on the rows ``active`` selects."""
    y, h = selective_scan_plain(x, dt, A, Bm, Cm, D, state)
    if state is None:
        return y, h
    if active is None:
        state.copy_(h)
    else:
        rows = active.to(torch.bool)
        state[rows] = h[rows]
    return y, state


def selective_scan(x, dt, A, Bm, Cm, D,
                   state: Optional[torch.Tensor] = None, *,
                   active: Optional[torch.Tensor] = None):
    """y (B, S, di) f32 and the final state (B, di, N) f32 of the
    recurrence; `state` updated in place (on the rows where ``active``
    (B,) is true, when given), or None to start from zeros.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check_operands(x, dt, A, Bm, Cm, D, state, active)
    if x.device.type == "cpu":
        return selective_scan_update_plain(x, dt, A, Bm, Cm, D, state,
                                           active=active)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: tensors on {x.device}")
    return _launch(x, dt, A, Bm, Cm, D, state, active)
