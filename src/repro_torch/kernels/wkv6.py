"""wkv6: the RWKV6 recurrence, from a carried state.

Port of the TPU kernel ``repro/kernels/wkv6.py::wkv6``.  The CUDA kernel
is ``csrc/wkv6.cu`` (its header gives the design and what bounds it on
the H100: each head's state split by value columns over blocks, a whole
token tile staged on chip before the recurrence, no block barrier per
token); :func:`wkv6_plan` lays out its launch from the shape alone.
:func:`wkv6_plain` is its plain torch version, the reference's
sequential oracle (``kernels/ref.py::wkv6_ref``, ``models/ssm.py::
wkv6_scan``) step for step:

    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t

Unlike the TPU kernel, both take an initial state (serving continues a
request's state across chunks and decode steps), any S >= 1, and update
a given state IN PLACE, only on the batch rows ``active`` selects.

Two layouts, one launch: :func:`wkv6_bshd` takes the model's (B, S, H,
hd) with u (H, hd) — ``kernels/ops.py::wkv6`` — and :func:`wkv6` the
TPU kernel's (BH, S, hd) fold with u (BH, hd).  r, k and v are bf16 or
f32 (one type for the three; the kernel converts bf16 on load, which is
exact); w, u and the state are f32; y is f32.  Every device checks the
same operands; CPU tensors then take the plain version, CUDA tensors
launch the kernel or raise.

Training differentiates the recurrence from a zero state through
:func:`wkv6_train`: the forward above, and as its backward
:func:`wkv6_bwd` — the hand-written kernel ``csrc/wkv6_bwd.cu`` (no TPU
kernel: the reference lets XLA differentiate ``wkv6_scan``) — or its
plain version :func:`wkv6_bwd_plain`, an explicit reverse recurrence.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sr_matmul import SMS

COUNTER = build.LaunchCounter("wkv6")
BWD_COUNTER = build.LaunchCounter("wkv6_bwd")
# the same launches by shape: one token (S = 1, a DECODE step) or a chunk
SHAPE_COUNTERS = {s: build.LaunchCounter(f"wkv6:{s}")
                  for s in ("step", "chunk")}
HEAD_DIMS = (16, 32, 64)          # csrc/wkv6.cu's instantiations
RKV_DTYPES = (torch.float32, torch.bfloat16)
_F32, _F64 = torch.float32, torch.float64

TILE = 32                         # tokens staged a stage
ROWS = 4                          # state rows a thread owns (csrc RPG)
BWD_TILE = 8                      # csrc/wkv6_bwd.cu's tokens a tile
BWD_COLS = 4                      # its state values a thread (one row)
PLAIN_BWD_TILE = 32               # wkv6_bwd_plain's tokens a tile


class WkvPlan(NamedTuple):
    grid: int       # blocks: B * H * (hd // cols), a head's blocks adjacent
    cols: int       # state (value) columns a block: 16, or hd
    cv: int         # columns a thread: 1, or 4 (float4) with cols = hd
    threads: int    # (hd / ROWS) row groups x (cols / cv)
    tile: int       # tokens staged a stage
    stages: int     # 2 when S spans more than one tile


def wkv6_plan(B: int, H: int, S: int, hd: int) -> WkvPlan:
    """The launch of csrc/wkv6.cu from (B, H, S, hd) alone.

    A DECODE step (S = 1) with a head for every SM (B * H >= SMS) and
    hd >= 32 runs one block a head, four columns (a float4 of each state
    row) a thread, so many state bytes are in flight (32 slots x 32
    heads of 64: 1024 blocks of 256 threads).  Otherwise 16 columns a
    block, one a thread, so the serial token loop runs on many threads
    (a one-slot chunk at hd 64: 32 heads x 4 = 128 blocks of 256).
    Tiles of up to TILE tokens, two stages when S spans several; the
    kernel sizes its shared memory from these (csrc/wkv6.cu::smem_need).
    The bits do not depend on the plan: every sum's order is fixed by
    hd."""
    cols, cv = (hd, 4) if S == 1 and B * H >= SMS and hd >= 32 else (16, 1)
    tile = min(S, TILE)
    stages = 2 if S > tile else 1
    return WkvPlan(B * H * (hd // cols), cols, cv, hd // ROWS * cols // cv,
                   tile, stages)


class WkvBwdPlan(NamedTuple):
    grid: int       # blocks: one a (b, h)
    threads: int    # hd * hd / cols: a state row's `cols` columns a thread
    cols: int       # state values of S and of G a thread holds
    tile: int       # tokens staged a tile (BWD_TILE)
    smem: int       # bytes of shared memory a block


def wkv6_bwd_plan(B: int, H: int, S: int, hd: int) -> WkvBwdPlan:
    """The launch of csrc/wkv6_bwd.cu from (B, H, S, hd) alone.

    One block a (b, h) of hd * hd / BWD_COLS threads (1024 at hd 64), a
    warp 8 state rows x 16 columns; tiles of BWD_TILE tokens.  The shared
    memory is the kernel's (csrc/wkv6_bwd.cu::smem_bytes), the larger of
    its two passes': pass A's ring of three 4 * BWD_TILE-token tiles of
    k, v, w; pass B's three staged tiles of r, k, v, w, dy, three tiles'
    starting states, two tiles' token sums {v.dy, sum u r k} and
    two tiles of output partials (3 a column block of 16, 1 a row block
    of 8; a token's partials padded to 16 banks off a multiple of 32),
    all at 4 bytes a value: 163968 B at hd 64."""
    t = BWD_TILE
    pad16 = lambda n: n + (48 - n % 32) % 32     # noqa: E731
    part = t * (pad16(3 * (hd // 16) * hd) + pad16((hd // 8) * hd))
    pass_a = 3 * 3 * 4 * t * hd * 4
    pass_b = 3 * 5 * t * hd * 4 + 3 * hd * hd * 4 + 2 * t * 8 + 2 * part * 4
    return WkvBwdPlan(B * H, hd * hd // BWD_COLS, BWD_COLS, t,
                      max(pass_a, pass_b))


def wkv6_plain(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, S, H, hd); u: (H, hd) or (B, H, hd); state0:
    (B, H, hd, hd) or None (zeros).  Returns (y (B, S, H, hd) f32, final
    state (B, H, hd, hd) f32); state0 is not modified.

    The state update is f32 elementwise; y's sum over k runs in f64 and
    rounds to f32, so a row's result does not depend on the batch shape
    (the reference backend's chunk == token-by-token invariant).
    """
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=_F32, device=r.device)
         if state0 is None else state0.to(_F32).clone())
    uu = u.to(_F32).expand(B, H, hd)[..., :, None]
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (a[:, t].to(_F32) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]          # (B, H, hd, hd)
        y = (rt[..., :, None].to(_F64) * (s + uu * kv).to(_F64)).sum(-2)
        ys.append(y.to(_F32))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _bind(lib: ctypes.CDLL):
    fn = lib.wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(r, k, v, w, u, state, active) -> None:
    """What the kernel takes, checked alike on every device: r, k, v,
    w of one (B, S >= 1, H, hd) shape; r, k, v one of RKV_DTYPES; w, u
    and the state f32; all contiguous and on one device; ``active`` only
    with a state."""
    B, S, H, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or S < 1:
        raise ValueError(f"wkv6: r, k, v, w must share one (B, S>=1, H, "
                         f"hd) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    if r.dtype not in RKV_DTYPES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v must be one of {RKV_DTYPES}, got "
                        f"{[t.dtype for t in (r, k, v)]}")
    f32 = [w, u] + ([state] if state is not None else [])
    if any(t.dtype != _F32 for t in f32):
        raise TypeError("wkv6: w, u and the state must be f32")
    ops = [r, k, v] + f32
    if any(t.device != r.device for t in ops):
        raise ValueError("wkv6: operands on more than one device")
    if not all(t.is_contiguous() for t in ops):
        raise TypeError("wkv6 takes contiguous tensors")
    if state is not None and state.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6: state {tuple(state.shape)} for "
                         f"{(B, H, hd, hd)}")
    if active is not None and state is None:
        raise ValueError("wkv6: `active` selects rows of a given state")


def _launch(r, k, v, w, u, state, active, u_per_b: bool):
    """The kernel on checked (B, S, H, hd) operands; returns (y, state)."""
    B, S, H, hd = r.shape
    dev = r.device
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    ops = [r, k, v, w, u] + ([state] if state is not None else [])
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("wkv6 kernel takes 16-byte aligned operands")
    p = wkv6_plan(B, H, S, hd)
    y = torch.empty(r.shape, dtype=_F32, device=dev)
    s_out = state if state is not None else torch.empty(
        (B, H, hd, hd), dtype=_F32, device=dev)
    act32 = (active.to(device=dev, dtype=torch.int32).contiguous()
             if active is not None else None)
    null = ctypes.c_void_p(None)
    err = _bind(build.load("wkv6"))(
        build.ptr(r), build.ptr(k), build.ptr(v), build.ptr(w), build.ptr(u),
        build.ptr(state) if state is not None else null, build.ptr(s_out),
        build.ptr(y), build.ptr(act32) if act32 is not None else null,
        B, H, S, hd, int(u_per_b), int(r.dtype == torch.bfloat16), p.cols,
        p.cv, p.tile, build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (cudaError {err})")
    COUNTER.n += 1
    SHAPE_COUNTERS["step" if S == 1 else "chunk"].n += 1
    return y, s_out


def _run(r, k, v, w, u, state, active, u_per_b: bool):
    _check_operands(r, k, v, w, u, state, active)
    if r.device.type == "cpu":
        return wkv6_bshd_plain(r, k, v, w, u, state, active=active)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: tensors on {r.device}")
    return _launch(r, k, v, w, u, state, active, u_per_b)


def wkv6_bshd_plain(r, k, v, w, u, state: Optional[torch.Tensor] = None,
                    *, active: Optional[torch.Tensor] = None):
    """:func:`wkv6_bshd`'s semantics on the plain version: the given
    state updated in place on the rows ``active`` selects."""
    y, s = wkv6_plain(r, k, v, w, u, state)
    if state is None:
        return y, s
    if active is None:
        state.copy_(s)
    else:
        rows = active.to(torch.bool)
        state[rows] = s[rows]
    return y, state


def wkv6_bshd(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
              active: Optional[torch.Tensor] = None):
    """The model's layout.  r, k, v: (B, S, H, hd) bf16 or f32 (one
    type); w: the same shape, f32; u: (H, hd) f32; state: (B, H, hd, hd)
    f32, updated in place (on rows where ``active`` (B,) is true, when
    given), or None to start from zeros.  Returns (y (B, S, H, hd) f32,
    final state)."""
    return _run(r, k, v, w, u, state, active, u_per_b=False)


def wkv6(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
         active: Optional[torch.Tensor] = None):
    """The TPU kernel's fold.  r, k, v, w: (BH, S, hd) (types as for
    :func:`wkv6_bshd`); u: (BH, hd);
    state: (BH, hd, hd), updated in place (rows where ``active`` (BH,)
    is true), or None for zeros.  Returns (y (BH, S, hd), final state)."""
    y, s = _run(*(t[:, :, None] for t in (r, k, v, w)), u[:, None],
                state[:, None] if state is not None else None, active,
                u_per_b=True)
    return y[:, :, 0], s[:, 0]


# ---------------------------------------------------------------------------
# The gradient (training: from a zero state, no carried state out)
# ---------------------------------------------------------------------------


def wkv6_bwd_plain(r, k, v, w, u, dy):
    """The recurrence's gradient, written out step by step (no autograd).

    r, k, v, w, dy: (B, S, H, hd); u: (H, hd).  With G_t = dL/dS_t
    (G_S = 0), running t from S down to 1:

        G_{t-1} = diag(w_t) G_t + r_t (x) dy_t
        dr_t = (S_{t-1} + diag(u) k_t (x) v_t) dy_t
        dk_t = G_t v_t + (u . r_t) (v_t . dy_t)
        dv_t = G_t^T k_t + (r_t . (u . k_t)) dy_t
        dw_t = rowsum(G_t . S_{t-1})
        du = sum over b, t of r_t . k_t (v_t . dy_t)

    S_{t-1} is recomputed forward from zeros, a tile of PLAIN_BWD_TILE
    tokens at a time from the state kept at each tile's start, so memory
    stays at a tile of states (nothing divides by w, which reaches ~0
    under strong decay).  The elementwise updates run in f32; every sum
    runs in f64 and rounds to f32, so a row's result does not depend on
    the batch shape.  Returns (dr, dk, dv, dw) (B, S, H, hd) and du
    (H, hd), all f32.
    """
    B, S, H, hd = r.shape
    dev = r.device
    tile = PLAIN_BWD_TILE
    uu = u.to(_F32)[..., :, None]                       # (H, hd, 1)
    at = lambda a, t: a[:, t].to(_F32)                  # noqa: E731
    s = torch.zeros((B, H, hd, hd), dtype=_F32, device=dev)
    starts = []
    for t in range(S):
        if t % tile == 0:
            starts.append(s)
        s = at(w, t)[..., :, None] * s \
            + at(k, t)[..., :, None] * at(v, t)[..., None, :]
    dr, dk, dv, dw = (torch.empty((B, S, H, hd), dtype=_F32, device=dev)
                      for _ in range(4))
    du = torch.zeros((H, hd), dtype=_F64, device=dev)
    g = torch.zeros((B, H, hd, hd), dtype=_F32, device=dev)
    for t0 in reversed(range(0, S, tile)):
        s, prev = starts[t0 // tile], []
        for t in range(t0, min(t0 + tile, S)):
            prev.append(s)
            s = at(w, t)[..., :, None] * s \
                + at(k, t)[..., :, None] * at(v, t)[..., None, :]
        for t in reversed(range(t0, min(t0 + tile, S))):
            rt, kt, vt, wt, dyt = (at(a, t) for a in (r, k, v, w, dy))
            sp = prev[t - t0].to(_F64)
            kv = kt[..., :, None] * vt[..., None, :]
            gu = g + uu * (rt[..., :, None] * dyt[..., None, :])
            v64, dy64 = vt.to(_F64), dyt.to(_F64)
            dr[:, t] = ((sp + (uu * kv).to(_F64)) * dy64[..., None, :]
                        ).sum(-1).to(_F32)
            dk[:, t] = (gu.to(_F64) * v64[..., None, :]).sum(-1).to(_F32)
            dv[:, t] = (gu.to(_F64) * kt.to(_F64)[..., :, None]).sum(-2) \
                .to(_F32)
            dw[:, t] = (g.to(_F64) * sp).sum(-1).to(_F32)
            du += ((rt * kt).to(_F64)
                   * (v64 * dy64).sum(-1, keepdim=True)).sum(0)
            g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.to(_F32)


def _bind_bwd(lib: ctypes.CDLL):
    fn = lib.wkv6_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_bwd_operands(r, k, v, w, u, dy) -> None:
    """The forward's operands (no state) and dy: f32 of r's shape."""
    _check_operands(r, k, v, w, u, None, None)
    B, S, H, hd = r.shape
    if dy.shape != r.shape or dy.dtype != _F32 or dy.device != r.device \
            or not dy.is_contiguous():
        raise TypeError(f"wkv6_bwd: dy must be contiguous f32 "
                        f"{tuple(r.shape)} on {r.device}, got {dy.dtype} "
                        f"{tuple(dy.shape)} on {dy.device}")
    if u.shape != (H, hd):
        raise ValueError(f"wkv6_bwd: u {tuple(u.shape)} for {(H, hd)}")


def wkv6_bwd(r, k, v, w, u, dy):
    """The gradient of :func:`wkv6_bshd`'s y from a zero state, given dy =
    dL/dy.  r, k, v: (B, S, H, hd) bf16 or f32 (one type); w, dy: f32 of
    that shape; u: (H, hd) f32; all contiguous.  Returns (dr, dk, dv, dw)
    (B, S, H, hd) and du (H, hd), all f32.  CPU tensors take
    :func:`wkv6_bwd_plain`; CUDA tensors launch ``csrc/wkv6_bwd.cu`` (laid
    out by :func:`wkv6_bwd_plan`; du's per-b partials then sum over b) or
    raise."""
    _check_bwd_operands(r, k, v, w, u, dy)
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, dy)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd: tensors on {r.device}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_bwd kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, u, dy)):
        raise ValueError("wkv6_bwd kernel takes 16-byte aligned operands")
    dev = r.device
    p = wkv6_bwd_plan(B, H, S, hd)
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=_F32, device=dev)
                      for _ in range(4))
    du_b = torch.empty((B, H, hd), dtype=_F32, device=dev)
    # the state at every tile's start after the first, a (b, h)'s in a row
    ntiles = -(-S // p.tile)
    bounds = torch.empty((B * H, max(ntiles - 1, 1), hd * hd), dtype=_F32,
                         device=dev)
    err = _bind_bwd(build.load("wkv6_bwd"))(
        *(build.ptr(t) for t in (r, k, v, w, u, dy, dr, dk, dv, dw, du_b,
                                 bounds)),
        B, H, S, hd, int(r.dtype == torch.bfloat16), p.threads, p.tile,
        p.smem, build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed (cudaError {err})")
    BWD_COUNTER.n += 1
    return dr, dk, dv, dw, du_b.sum(0)


class _WKV6Train(torch.autograd.Function):
    """y of the recurrence from zeros, with the backward above.  It saves
    only r, k, v, w and u; dr, dk, dv come back in r's dtype (as the
    reference's VJP through ``astype(f32)``), dw and du in f32."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, plain: bool):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.plain = plain
        y, _ = (wkv6_bshd_plain if plain else wkv6_bshd)(r, k, v, w, u)
        return y

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u = ctx.saved_tensors
        bwd = wkv6_bwd_plain if ctx.plain else wkv6_bwd
        dr, dk, dv, dw, du = bwd(r, k, v, w, u,
                                 dy.to(_F32).contiguous())
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du,
                None)


def wkv6_train(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
               plain: bool = False):
    """The differentiable recurrence of a training step: y (B, S, H, hd)
    f32 from a zero state, operands as for :func:`wkv6_bshd`.  The
    forward is :func:`wkv6_bshd` and the backward :func:`wkv6_bwd` (each
    its plain version on CPU tensors); ``plain`` runs the plain versions
    on any device (the reference backend).  Training carries no state:
    a given one raises (its gradient is not computed)."""
    if state is not None:
        raise ValueError("wkv6_train runs from a zero state: a carried "
                         "state (and a gradient for it) is not supported")
    return _WKV6Train.apply(r, k, v, w, u, plain)
