"""wkv6: the RWKV6 recurrence, from a carried state.

Port of the TPU kernel ``repro/kernels/wkv6.py::wkv6``.  The CUDA kernel
is ``csrc/wkv6.cu`` (its header gives the design and what bounds it on
the H100); :func:`wkv6_plain` is its plain torch version, the
reference's sequential oracle (``kernels/ref.py::wkv6_ref``,
``models/ssm.py::wkv6_scan``) step for step:

    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t

Unlike the TPU kernel, both take an initial state (serving continues a
request's state across chunks and decode steps), any S >= 1, and update
a given state IN PLACE, only on the batch rows ``active`` selects.

Two layouts, one launch: :func:`wkv6_bshd` takes the model's (B, S, H,
hd) with u (H, hd) — ``kernels/ops.py::wkv6`` — and :func:`wkv6` the
TPU kernel's (BH, S, hd) fold with u (BH, hd).  CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("wkv6")
# the same launches by shape: one token (S = 1, a DECODE step) or a chunk
SHAPE_COUNTERS = {s: build.LaunchCounter(f"wkv6:{s}")
                  for s in ("step", "chunk")}
HEAD_DIMS = (16, 32, 64)          # csrc/wkv6.cu's instantiations
_F32, _F64 = torch.float32, torch.float64


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
    fn = lib.wkv6_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(r, k, v, w, u, state, active, u_per_b: bool):
    """The kernel on (B, S, H, hd) operands; returns (y, state)."""
    B, S, H, hd = r.shape
    dev = r.device
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    ops = [r, k, v, w, u] + ([state] if state is not None else [])
    for t in ops:
        if t.device != dev or t.dtype != _F32 or not t.is_contiguous():
            raise TypeError("wkv6 kernel takes contiguous f32 tensors on "
                            "one device")
    if state is not None and state.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6: state {tuple(state.shape)} for "
                         f"{(B, H, hd, hd)}")
    if active is not None and state is None:
        raise ValueError("wkv6: `active` selects rows of a given state")
    y = torch.empty_like(r)
    s_out = state if state is not None else torch.empty(
        (B, H, hd, hd), dtype=_F32, device=dev)
    act32 = (active.to(device=dev, dtype=torch.int32).contiguous()
             if active is not None else None)
    null = ctypes.c_void_p(None)
    err = _bind(build.load("wkv6"))(
        build.ptr(r), build.ptr(k), build.ptr(v), build.ptr(w), build.ptr(u),
        build.ptr(state) if state is not None else null, build.ptr(s_out),
        build.ptr(y), build.ptr(act32) if act32 is not None else null,
        B, H, S, hd, int(u_per_b), build.stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (cudaError {err})")
    COUNTER.n += 1
    SHAPE_COUNTERS["step" if S == 1 else "chunk"].n += 1
    return y, s_out


def _run(r, k, v, w, u, state, active, u_per_b: bool):
    B, S, H, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or S < 1:
        raise ValueError(f"wkv6: r, k, v, w must share one (B, S>=1, H, "
                         f"hd) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
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
    """The model's layout.  r, k, v, w: (B, S, H, hd) f32; u: (H, hd)
    f32; state: (B, H, hd, hd) f32, updated in place (on rows where
    ``active`` (B,) is true, when given), or None to start from zeros.
    Returns (y (B, S, H, hd) f32, final state)."""
    return _run(r, k, v, w, u, state, active, u_per_b=False)


def wkv6(r, k, v, w, u, state: Optional[torch.Tensor] = None, *,
         active: Optional[torch.Tensor] = None):
    """The TPU kernel's fold.  r, k, v, w: (BH, S, hd) f32; u: (BH, hd);
    state: (BH, hd, hd), updated in place (rows where ``active`` (BH,)
    is true), or None for zeros.  Returns (y (BH, S, hd), final state)."""
    y, s = _run(*(t[:, :, None] for t in (r, k, v, w)), u[:, None],
                state[:, None] if state is not None else None, active,
                u_per_b=True)
    return y[:, :, 0], s[:, 0]
