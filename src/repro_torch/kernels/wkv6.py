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
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sr_matmul import SMS

COUNTER = build.LaunchCounter("wkv6")
# the same launches by shape: one token (S = 1, a DECODE step) or a chunk
SHAPE_COUNTERS = {s: build.LaunchCounter(f"wkv6:{s}")
                  for s in ("step", "chunk")}
HEAD_DIMS = (16, 32, 64)          # csrc/wkv6.cu's instantiations
RKV_DTYPES = (torch.float32, torch.bfloat16)
_F32, _F64 = torch.float32, torch.float64

TILE = 32                         # tokens staged a stage
ROWS = 4                          # state rows a thread owns (csrc RPG)


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
