"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba.

RWKV6 time-mix, the mixer of rwkv6-1.6b:

A linear-state recurrence: each (batch row, head) carries an hd x hd
f32 state, O(1) in sequence length, plus the last token of the layer's
input for the token shift.  Kept from the reference
(``repro/models/ssm.py``): token-shift mixing, the fused r, k, v, g
projection under the ``rwkv_rkvg`` word, the data-dependent decay
w_t = exp(-exp(w0 + x_w W_decay)), the first-token bonus u, the silu(g)
gate and the ``rwkv_o`` output projection.

The recurrence runs on the ``wkv6`` kernel on the cuda backend
(``kernels/wkv6.py``; its plain version on CPU tensors) and on that
plain version on the reference backend: ``kernels.wkv6.wkv6_plain`` is
the port of the reference's ``wkv6_scan`` (same layout, state0 in).
Both read r, k and v in the projections' dtype (bf16 when serving)
and convert exactly, so no f32 copy of them is made.  A
given state is updated IN PLACE, on the rows ``active`` selects, where
the reference returns a new state.  A call without a state (training)
runs through ``kernels.wkv6.wkv6_train``, whose backward is the ``wkv6_bwd``
kernel on the cuda backend, the plain reverse recurrence on the
reference backend.

Mamba, the mixer of jamba's seven non-attention layers a period: the
``mamba_in`` projection to (x, z), a depthwise causal conv over the
last d_conv tokens (its K - 1 rows carried in bf16), silu, the
``mamba_xproj`` projection to (dt, B, C), ``dt = softplus(dt W_dt +
dt_bias)`` under ``mamba_dt``, the selective scan (f32 state (B, di,
N)), ``y * silu(z)`` and ``mamba_out``, with the reference's casts.  The
scan runs on the ``selective_scan`` kernel on the cuda backend
(``kernels/selective_scan.py``; its plain version on CPU tensors) and on
that plain version on the reference backend; both states are updated in
place on the rows ``active`` selects.  A call without a state under
autograd (training) runs through ``kernels.selective_scan.
selective_scan_train``, whose backward is the ``selective_scan_bwd``
kernel on the cuda backend, the plain reverse recurrence on the
reference backend; the conv, silu, softplus and ``-exp(A_log)`` around
it are torch ops that autograd differentiates.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.context import PEContext
from repro_torch.kernels import selective_scan as kss
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.models.layers import _silu, param_drawer

_F32, _F64 = torch.float32, torch.float64


def _makers(generator: Optional[torch.Generator], lead: tuple,
            dtype: torch.dtype):
    """(normal(shape, std), full(shape, value)) on the generator's device
    (meta without one), in `dtype` (the constants here are exact in
    bf16)."""
    dev = generator.device if generator is not None else torch.device("meta")
    return (param_drawer(generator, lead, dtype),
            lambda shape, value: torch.full(lead + shape, value, dtype=dtype,
                                            device=dev))


def rwkv_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                lead: tuple = (), dtype: torch.dtype = _F32) -> dict:
    """f32 mixer weights in the reference's shapes and scales, drawn on
    the generator's device, each cast to `dtype` as it is drawn; without
    a generator, meta tensors."""
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    normal, full = _makers(generator, lead, dtype)
    return {
        "rkvg": normal((d, 4 * d), d ** -0.5),
        "decay": normal((d, d), 0.01),
        "o": normal((d, d), d ** -0.5),
        "w0": full((d,), -2.0),
        "u": normal((d // hd, hd), 0.1),
        "mix": full((5, d), 0.5),
    }


def rwkv_init_state(cfg: ModelConfig, batch: int, device=None,
                    lead: tuple = ()) -> dict:
    """{"wkv": f32 (batch, H, hd, hd), "shift": bf16 (batch, d)} zeros."""
    hd = cfg.ssm.head_dim
    H = cfg.d_model // hd
    return {"wkv": torch.zeros(lead + (batch, H, hd, hd), dtype=_F32,
                               device=device),
            "shift": torch.zeros(lead + (batch, cfg.d_model),
                                 dtype=torch.bfloat16, device=device)}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The x_{t-1} stream; `prev` (B, 1, d) carries the last token across
    calls (zeros when None)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_block(cfg: ModelConfig, x: torch.Tensor, params: dict,
               sh: PEContext, state: Optional[dict] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RWKV6 time-mix.  x: (B, S, d) (the normed layer input).  Returns
    out (B, S, d).  With `state` ({"wkv", "shift"} rows of x's batch) the
    recurrence continues it, and both leaves are updated in place on the
    rows `active` (B,) selects (None = every row).  Without a state the
    recurrence runs from zeros and is differentiable."""
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    H = d // hd
    B, S, _ = x.shape
    xs = _token_shift(x, state["shift"][:, None] if state is not None
                      else None)
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xs - x) * mix[i] for i in range(5))

    w_rkvg = params["rkvg"]
    r = sh.dot("rwkv_rkvg", xr, w_rkvg[:, :d])
    k = sh.dot("rwkv_rkvg", xk, w_rkvg[:, d:2 * d])
    v = sh.dot("rwkv_rkvg", xv, w_rkvg[:, 2 * d:3 * d])
    g = sh.dot("rwkv_rkvg", xg, w_rkvg[:, 3 * d:])
    # data-dependent decay (Finch): w_t in (0, 1); the transcendentals in
    # f64, rounded to f32, so a row's value does not depend on the shape
    wlog = params["w0"].to(_F32) \
        + sh.dot("rwkv_decay", xw, params["decay"]).to(_F32)
    w = torch.exp(-torch.exp(wlog.to(_F64))).to(_F32)

    # r, k, v as the projections give them (bf16 on the serving path): a
    # reshape, no copy; the kernel converts on load, the plain version
    # per token, both exactly
    heads = [t.reshape(B, S, H, hd) for t in (r, k, v, w)]
    u = params["u"].to(_F32).contiguous()
    if state is None:
        y = kwkv.wkv6_train(*heads, u, plain=sh.backend != "cuda")
    else:
        run = (kwkv.wkv6_bshd if sh.backend == "cuda"
               else kwkv.wkv6_bshd_plain)
        y, _ = run(*heads, u, state["wkv"], active=active)
    if state is not None:
        last = x[:, -1].to(state["shift"].dtype)
        if active is None:
            state["shift"].copy_(last)
        else:
            rows = active.to(torch.bool)
            state["shift"][rows] = last[rows]
    out = y.to(x.dtype).reshape(B, S, d) * _silu(g)
    return sh.dot("rwkv_o", out, params["o"])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def mamba_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                 lead: tuple = (), dtype: torch.dtype = _F32) -> dict:
    """The mixer's leaves in the reference's shapes and scales (A_log =
    log 1..N a channel, D ones, dt_bias zeros), drawn in f32 on the
    generator's device and each cast to `dtype` as it is made; without a
    generator, meta tensors."""
    s, d = cfg.ssm, cfg.d_model
    di, r, N = s.inner(d), s.rank(d), s.d_state
    normal, full = _makers(generator, lead, dtype)
    p = {"in": normal((d, 2 * di), d ** -0.5),
         "conv": normal((di, s.d_conv), 0.2),
         "xproj": normal((di, r + 2 * N), di ** -0.5),
         "dt": normal((r, di), r ** -0.5),
         "dt_bias": full((di,), 0.0)}
    dev = p["in"].device
    a_log = torch.log(torch.arange(1, N + 1, dtype=_F32, device=dev))
    p["A_log"] = a_log.expand(lead + (di, N)).contiguous().to(dtype)
    p["D"] = full((di,), 1.0)
    p["out"] = normal((di, d), di ** -0.5)
    return p


def mamba_init_state(cfg: ModelConfig, batch: int, device=None,
                     lead: tuple = ()) -> dict:
    """{"conv": bf16 (batch, d_conv - 1, di), "ssm": f32 (batch, di, N)}
    zeros."""
    s = cfg.ssm
    di = s.inner(cfg.d_model)
    return {"conv": torch.zeros(lead + (batch, s.d_conv - 1, di),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros(lead + (batch, di, s.d_state), dtype=_F32,
                               device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along S in x's dtype, summed over taps in the
    order i = 0 .. K-1 as the reference sums them.  x: (B, S, di); w:
    (di, K); state: the K - 1 rows before x (B, K-1, di), zeros if None."""
    K = w.shape[1]
    S = x.shape[1]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    wx = w.to(x.dtype)
    out = xp[:, 0:S] * wx[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wx[:, i]
    return out


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """The reference's softplus, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), in f64, rounded to x's dtype.  Its gradient is
    logaddexp's, sigmoid(x), at x = 0 too: there the subgradients of
    clamp (1) and abs (0) would sum to 1, not 1/2."""
    x64 = x.to(_F64)
    y = x64.clamp(min=0) + torch.log1p(torch.exp(-x64.abs()))
    if y.requires_grad:
        # the same value (x64 - x64.detach() is 0), differentiated as
        # sigmoid(x) times x
        y = y.detach() + torch.sigmoid(x64.detach()) * (x64 - x64.detach())
    return y.to(x.dtype)


def mamba_block(cfg: ModelConfig, x: torch.Tensor, params: dict,
                sh: PEContext, state: Optional[dict] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Mamba mixer.  x: (B, S, d) (the normed layer input).  Returns
    out (B, S, d).  With `state` ({"conv", "ssm"} rows of x's batch) the
    conv and the scan continue it, and both leaves are updated in place
    on the rows `active` (B,) selects (None = every row); without one
    both start from zeros, and under autograd the scan is
    differentiable."""
    s = cfg.ssm
    di, r, N, K = s.inner(cfg.d_model), s.rank(cfg.d_model), s.d_state, \
        s.d_conv
    xz = sh.dot("mamba_in", x, params["in"])
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = state["conv"] if state is not None else None
    xc = _silu(_causal_conv(xi, params["conv"], conv_state))
    proj = sh.dot("mamba_xproj", xc, params["xproj"])
    # dt's rows are read in place, a view of r columns at proj's row
    # stride r + 2N (the PREFILL kernel takes strided rows)
    dt = _softplus(sh.dot("mamba_dt", proj[..., :r], params["dt"]).to(_F32)
                   + params["dt_bias"].to(_F32))
    Bm = proj[..., r:r + N].to(_F32).contiguous()
    Cm = proj[..., r + N:].to(_F32).contiguous()
    # A = -exp(A_log) in A_log's dtype (bf16 when serving), as the
    # reference computes it
    a_log = params["A_log"]
    A = (-torch.exp(a_log.to(_F64)).to(a_log.dtype)).to(_F32).contiguous()
    D = params["D"].to(_F32).contiguous()
    if state is None and torch.is_grad_enabled():
        y = kss.selective_scan_train(xc, dt, A, Bm, Cm, D,
                                     plain=sh.backend != "cuda")
    elif sh.backend == "cuda":
        y, _ = kss.selective_scan(
            xc, dt, A, Bm, Cm, D, state["ssm"] if state is not None
            else None, active=active)
    else:
        y, _ = kss.selective_scan_update_plain(
            xc, dt, A, Bm, Cm, D, state["ssm"] if state is not None
            else None, active=active)
    if state is not None and K > 1:
        new = torch.cat([conv_state.to(xi.dtype), xi], dim=1)[:, -(K - 1):]
        new = new.to(conv_state.dtype)
        if active is None:
            conv_state.copy_(new)
        else:
            rows = active.to(torch.bool)
            conv_state[rows] = new[rows]
    y = y.to(x.dtype) * _silu(z)
    return sh.dot("mamba_out", y, params["out"])
