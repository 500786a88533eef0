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

Training differentiates the recurrence from a zero state through
:func:`selective_scan_train`: the forward above, and as its backward
:func:`selective_scan_bwd` — the hand-written kernel
``csrc/selective_scan_bwd.cu`` (no TPU kernel: the reference lets XLA
differentiate the ``lax.scan``) — or its plain version
:func:`selective_scan_bwd_plain`, the reverse recurrence written out.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sr_matmul import SMS

COUNTER = build.LaunchCounter("selective_scan")
BWD_COUNTER = build.LaunchCounter("selective_scan_bwd")
D_STATES = (4, 8, 16)             # csrc/selective_scan.cu's instantiations
X_DTYPES = (torch.float32, torch.bfloat16)
TILE = 32                         # tokens staged at once, at most
MAX_THREADS = 256                 # a block's (csrc: MAX_THREADS)
MAX_SMEM = 48 * 1024              # a block's shared memory (csrc: MAX_SMEM)
KP = 8                            # a thread's share of a tile (csrc: KP)
BWD_TILE = 8                      # csrc/selective_scan_bwd.cu's tokens a tile
PLAIN_BWD_TILE = 32               # selective_scan_bwd_plain's tokens a tile
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


# ---------------------------------------------------------------------------
# The gradient (training: from a zero state, no carried state out)
# ---------------------------------------------------------------------------


class ScanBwdPlan(NamedTuple):
    lanes: int      # a channel's lanes: N / 4, four states a lane
    channels: int   # channels a block
    tile: int       # tokens a tile: recomputed, then walked back
    threads: int    # channels x lanes, whole warps
    grid: tuple     # (ceil(di / channels), B)
    smem: int       # bytes of dynamic shared memory a block


def bwd_smem_bytes(N: int, channels: int, tile: int) -> int:
    """csrc/selective_scan_bwd.cu::smem_bytes: a tile's x, dt and dy (a
    float a channel and token each), its B and C (N floats a token each),
    each thread's h_{t-1} (four floats a thread and token: N a channel)
    and each channel's terms of dB and dC (2N floats a channel and
    token)."""
    return tile * (3 * channels + 2 * N + 3 * N * channels) * 4


@functools.lru_cache(maxsize=256)
def selective_scan_bwd_plan(B: int, S: int, di: int, N: int) -> ScanBwdPlan:
    """The launch of csrc/selective_scan_bwd.cu from (B, S, di, N) alone:
    the forward's lanes (a float4 of a channel's states a lane) and
    blocks of up to MAX_THREADS threads, halved (down to two warps)
    while the grid has fewer than two blocks an SM; tiles of BWD_TILE
    tokens (S, where that is fewer).  Jamba's training shape (B 4, di
    8192, N 16) runs 128 x 4 blocks of 256 threads, 105472 B of shared
    memory each: two blocks an SM."""
    if N not in D_STATES:
        raise ValueError(f"selective_scan_bwd kernel takes d_state in "
                         f"{D_STATES}, got {N}")
    lanes = N // 4
    channels = MAX_THREADS // lanes
    while channels * lanes > 64 and B * -(-di // channels) < 2 * SMS:
        channels //= 2
    tile = min(S, BWD_TILE)
    return ScanBwdPlan(lanes, channels, tile, channels * lanes,
                       (-(-di // channels), B),
                       bwd_smem_bytes(N, channels, tile))


def selective_scan_bwd_plain(x, dt, A, Bm, Cm, D, dy):
    """The recurrence's gradient from a zero state, written out step by
    step (no autograd).  With a_t = exp(dt_t A) and G_t = dL/dh_t
    (G_S = 0), running t from S down to 1:

        G_t = C_t dy_t + a_{t+1} G_{t+1}
        dx_t = dt_t sum_n G_t B_t + D dy_t
        ddt_t = sum_n G_t (A a_t h_{t-1} + x_t B_t)
        dB_t = sum_d G_t dt_t x_t          dC_t = sum_d dy_t h_t
        dA = sum_{b,t} G_t dt_t a_t h_{t-1}
        dD = sum_{b,t} dy_t x_t

    h_{t-1} is recomputed forward, a tile of PLAIN_BWD_TILE tokens at a
    time from the state kept at each tile's start, so memory stays at a
    tile of states; nothing divides by a_t, which underflows to 0 where
    dt A is very negative.  a_t and the updates of h and G are rounded
    as :func:`selective_scan_plain` rounds them (the exp in f64 rounded
    to f32, the rest f32 elementwise); every sum runs in f64 and rounds
    to f32.  Returns (dx, ddt (B, S, di), dA (di, N), dB, dC (B, S, N),
    dD (di,)), all f32."""
    Bsz, S, di = x.shape
    N = A.shape[1]
    dev = x.device
    A64 = A.to(_F64)
    D64 = D.to(_F64)
    at = lambda a, t: a[:, t].to(_F32)                  # noqa: E731

    def decay(t):
        return torch.exp(at(dt, t).to(_F64)[..., None] * A64).to(_F32)

    def inject(t):
        return (at(dt, t) * at(x, t))[..., None] * at(Bm, t)[:, None, :]

    tile = PLAIN_BWD_TILE
    h = torch.zeros((Bsz, di, N), dtype=_F32, device=dev)
    starts = []
    for t in range(S):
        if t % tile == 0:
            starts.append(h)
        h = decay(t) * h + inject(t)
    dx, ddt = (torch.empty((Bsz, S, di), dtype=_F32, device=dev)
               for _ in range(2))
    dB, dC = (torch.empty((Bsz, S, N), dtype=_F32, device=dev)
              for _ in range(2))
    dA = torch.zeros((di, N), dtype=_F64, device=dev)
    dD = torch.zeros((di,), dtype=_F64, device=dev)
    g = torch.zeros((Bsz, di, N), dtype=_F32, device=dev)
    a_next = torch.zeros_like(g)
    for t0 in reversed(range(0, S, tile)):
        h, prev = starts[t0 // tile], []
        for t in range(t0, min(t0 + tile, S)):
            prev.append(h)
            h = decay(t) * h + inject(t)
        for t in reversed(range(t0, min(t0 + tile, S))):
            hp = prev[t - t0]
            a = decay(t)
            ht = a * hp + inject(t)
            g = a_next * g + at(Cm, t)[:, None, :] * at(dy, t)[..., None]
            x64, dt64, dy64 = (at(v, t).to(_F64) for v in (x, dt, dy))
            b64 = at(Bm, t).to(_F64)[:, None, :]
            g64, a64, hp64 = g.to(_F64), a.to(_F64), hp.to(_F64)
            dx[:, t] = ((g64 * b64).sum(-1) * dt64 + D64 * dy64).to(_F32)
            ddt[:, t] = (g64 * (A64 * a64 * hp64 + x64[..., None] * b64)
                         ).sum(-1).to(_F32)
            dB[:, t] = (g64 * (dt64 * x64)[..., None]).sum(1).to(_F32)
            dC[:, t] = (ht.to(_F64) * dy64[..., None]).sum(1).to(_F32)
            dA += (g64 * dt64[..., None] * a64 * hp64).sum(0)
            dD += (dy64 * x64).sum(0)
            a_next = a
    return dx, ddt, dA.to(_F32), dB, dC, dD.to(_F32)


def _check_bwd_operands(x, dt, A, Bm, Cm, D, dy) -> None:
    """The forward's operands (no state) and dy: f32 of x's shape."""
    _check_operands(x, dt, A, Bm, Cm, D, None, None)
    if dy.shape != x.shape or dy.dtype != _F32 or dy.device != x.device \
            or not dy.is_contiguous():
        raise TypeError(f"selective_scan_bwd: dy must be contiguous f32 "
                        f"{tuple(x.shape)} on {x.device}, got {dy.dtype} "
                        f"{tuple(dy.shape)} on {dy.device}")


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.selective_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def selective_scan_bwd(x, dt, A, Bm, Cm, D, dy):
    """The gradient of :func:`selective_scan`'s y from a zero state, given
    dy = dL/dy (B, S, di) f32; operands as for the forward, no state.
    Returns (dx, ddt, dA, dB, dC, dD), all f32, in the shapes of x, dt,
    A, B, C and D.  CPU tensors take :func:`selective_scan_bwd_plain`;
    CUDA tensors launch ``csrc/selective_scan_bwd.cu`` (laid out by
    :func:`selective_scan_bwd_plan`: its per-block partial sums of dB and
    dC and per-row ones of dA and dD are summed in a fixed order by a
    second kernel of the same entry) or raise."""
    _check_bwd_operands(x, dt, A, Bm, Cm, D, dy)
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, A, Bm, Cm, D, dy)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd: tensors on {x.device}")
    Bsz, S, di = x.shape
    N = A.shape[1]
    p = selective_scan_bwd_plan(Bsz, S, di, N)
    dev = x.device
    empty = lambda *s: torch.empty(s, dtype=_F32, device=dev)  # noqa: E731
    dx, ddt = empty(Bsz, S, di), empty(Bsz, S, di)
    # the state at every tile's start after the first
    ntiles = -(-S // p.tile)
    starts = empty(Bsz, max(ntiles - 1, 1), di, N)
    # per-block terms of dB then dC, per-row ones of dA then dD
    part_bc = empty(2, Bsz, S, p.grid[0], N)
    part_ad = empty(Bsz, di * (N + 1))
    bc, ad = empty(2, Bsz, S, N), empty(di * (N + 1))
    err = _bind_bwd(build.load("selective_scan_bwd"))(
        *(build.ptr(t) for t in (x, dt, A, Bm, Cm, D, dy, dx, ddt, starts,
                                 part_bc, part_ad, bc, ad)),
        Bsz, S, di, N, int(x.dtype == torch.bfloat16), p.lanes, p.channels,
        p.tile, build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed "
                           f"(cudaError {err})")
    BWD_COUNTER.n += 1
    return (dx, ddt, ad[:di * N].view(di, N), bc[0], bc[1],
            ad[di * N:])


class _SelectiveScanTrain(torch.autograd.Function):
    """y of the recurrence from zeros, with the backward above.  It saves
    only the operands; dx comes back in x's dtype (as the reference's VJP
    through ``astype(f32)``), the rest in f32."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, plain: bool):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.plain = plain
        if plain:
            y, _ = selective_scan_plain(x, dt, A, Bm, Cm, D)
        else:
            y, _ = selective_scan(x, dt, A, Bm, Cm, D)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        bwd = selective_scan_bwd_plain if ctx.plain else selective_scan_bwd
        dx, ddt, dA, dB, dC, dD = bwd(x, dt, A, Bm, Cm, D,
                                      dy.to(_F32).contiguous())
        return dx.to(x.dtype), ddt, dA, dB, dC, dD, None


def selective_scan_train(x, dt, A, Bm, Cm, D,
                         state: Optional[torch.Tensor] = None, *,
                         plain: bool = False):
    """The differentiable recurrence of a training step: y (B, S, di) f32
    from a zero state, operands as for :func:`selective_scan`.  The
    forward is :func:`selective_scan` and the backward
    :func:`selective_scan_bwd` (each its plain version on CPU tensors);
    ``plain`` runs the plain versions on any device (the reference
    backend).  Training carries no state: a given one raises (its
    gradient is not computed)."""
    if state is not None:
        raise ValueError("selective_scan_train runs from a zero state: a "
                         "carried state (and a gradient for it) is not "
                         "supported")
    _check_operands(x, dt, A, Bm, Cm, D, None, None)
    return _SelectiveScanTrain.apply(x, dt, A, Bm, Cm, D, plain)
