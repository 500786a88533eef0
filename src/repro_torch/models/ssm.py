"""RWKV6 (Finch) time-mix: the attention-free mixer of rwkv6-1.6b.

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
reference backend.  Mamba waits for its slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.context import PEContext
from repro_torch.kernels import wkv6 as kwkv
from repro_torch.models.layers import _silu

_F32, _F64 = torch.float32, torch.float64


def rwkv_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                lead: tuple = ()) -> dict:
    """f32 mixer weights in the reference's shapes and scales, drawn on
    the generator's device; without a generator, meta tensors."""
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    dev = generator.device if generator is not None else torch.device("meta")

    def normal(*shape):
        if generator is None:
            return torch.empty(lead + shape, dtype=_F32, device=dev)
        return torch.randn(lead + shape, generator=generator, dtype=_F32,
                           device=dev)

    return {
        "rkvg": normal(d, 4 * d) * d ** -0.5,
        "decay": normal(d, d) * 0.01,
        "o": normal(d, d) * d ** -0.5,
        "w0": torch.full(lead + (d,), -2.0, dtype=_F32, device=dev),
        "u": normal(d // hd, hd) * 0.1,
        "mix": torch.full(lead + (5, d), 0.5, dtype=_F32, device=dev),
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
