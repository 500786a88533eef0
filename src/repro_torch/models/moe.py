"""Mixture-of-Experts, single-shard and dropless (the reference's
``repro/models/moe.py`` without its mesh).

  1. Route: f32 router logits through the router's VPU word, softmax,
     top-k, renormalised combine weights and the Switch load-balancing
     value.
  2. Dispatch: a stable sort groups the (token, choice) entries by
     expert; each entry's position inside its expert's group gives its
     row in an (E, C, d) buffer (C = capacity), and an entry past C goes
     to a trash row.
  3. The expert FFN: three batched products (gate and up are separate
     tables), one PE program word each over all E experts, each told
     every expert's count of kept entries (its live rows: the buffer's
     rows past it are zero), so the kernels compute only those.
  4. Combine: each token's k expert rows, weighted by the combine
     weights, summed in f32.

The capacity C is T rounded up to 8 while T <= 4096, so no entry is
dropped (one expert may take every token): a prompt chunk then routes
exactly as token-by-token decode does.  Above 4096 tokens C follows the
capacity factor, as the reference's single-shard path does.

Reductions and transcendental functions run in float64 and round to
float32 where the reference computes in float32 (``models/layers.py``),
so a token's result does not depend on how many tokens share the call.
The sharded expert-parallel path of the reference (all-to-all over the
data axis) needs several devices and is not here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.program import PEWord, _VPU_WORD_KERNELS
from repro_torch.engine.context import PEContext
from repro_torch.engine.dispatch import pe_dot
from repro_torch.models.layers import _gelu, _silu, act_fn

CAPACITY_FACTOR = 1.25
_F32, _F64 = torch.float32, torch.float64

# Routing is VPU math (role 'state'): a word whose every phase selects
# the vpu kernel, so no backend or phase can dispatch the router onto
# the bf16 MAC kernels — expert selection is identical across backends.
_ROUTER_WORD = PEWord(op="moe_router", ff_dtype="float32",
                      bp_dtype="float32", update_rounding="nearest",
                      **_VPU_WORD_KERNELS)


def moe_params(cfg: ModelConfig, generator: Optional[torch.Generator],
               lead: tuple = ()) -> dict:
    """f32 router and expert tables in the reference's layout and scales
    (normal * fan_in^-0.5), with `lead` dimensions in front (the scan
    groups); generator=None gives them on the meta device."""
    m = cfg.moe
    d, fe, E = cfg.d_model, m.d_expert, m.n_experts

    def normal(shape, std):
        if generator is None:
            return torch.empty(lead + shape, dtype=_F32, device="meta")
        return torch.randn(lead + shape, generator=generator, dtype=_F32,
                           device=generator.device) * std

    p = {"router": normal((d, E), d ** -0.5),
         "experts_in": normal((E, d, fe), d ** -0.5),
         "experts_out": normal((E, fe, d), fe ** -0.5)}
    if cfg.act in ("swiglu", "geglu"):
        p["experts_gate"] = normal((E, d, fe), d ** -0.5)
    return p


def _capacity(tokens: int, top_k: int, n_experts: int) -> int:
    """Entries per expert under the capacity factor, padded to 8."""
    c = math.ceil(tokens * top_k * CAPACITY_FACTOR / n_experts)
    return max(8, -(-c // 8) * 8)


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
           sh: PEContext, experts: Optional[torch.Tensor] = None):
    """x: (T, d).  Returns (combine weights (T, k) f32, experts (T, k)
    int64, aux f32 scalar).  Ties in the top k take the lower expert
    first (a stable descending sort), as ``lax.top_k`` does.  `experts`
    (T, k) holds the selection fixed instead (a comparison of two runs
    with routing held): the combine weights and aux then come from this
    call's own probabilities at those experts.  The router's gradient
    flows through the combine weights and aux's mean probabilities; the
    selection and aux's token shares carry none."""
    logits = pe_dot(x.to(_F32), router_w.to(_F32), word=_ROUTER_WORD,
                    backend=sh.backend, phase=sh.phase)
    probs = torch.softmax(logits.to(_F64), dim=-1).to(_F32)      # (T, E)
    if experts is None:
        srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        topv, topi = srt[:, :top_k], idx[:, :top_k]
    else:
        topi = experts.to(device=x.device, dtype=torch.int64)
        topv = probs.gather(1, topi)
    topv = topv / topv.to(_F64).sum(dim=-1, keepdim=True).to(_F32)
    E = router_w.shape[1]
    # the share of tokens whose first choice is each expert (a scatter:
    # one_hot would check its indices on the host, a sync every layer)
    frac_tokens = torch.zeros(E, dtype=_F64, device=x.device).scatter_add_(
        0, topi[:, 0], torch.ones(topi.shape[0], dtype=_F64,
                                  device=x.device)) / topi.shape[0]
    frac_probs = probs.to(_F64).mean(dim=0)
    aux = (E * torch.sum(frac_tokens * frac_probs)).to(_F32)
    return topv, topi, aux


def _dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int):
    """Sort-based capacity dispatch.  experts: (T*k,) expert id per entry.

    Returns (slot (T*k,), keep (T*k,)): slot indexes an (E*C + 1,) buffer
    whose last row is the trash row of the dropped entries."""
    n = experts.shape[0]
    order = torch.argsort(experts, stable=True)       # grouped by expert
    e_sorted = experts[order]
    first = torch.searchsorted(e_sorted, e_sorted)    # expert's first index
    pos = torch.arange(n, device=experts.device) - first
    keep_sorted = pos < capacity
    slot_sorted = e_sorted * capacity + torch.clamp(pos, max=capacity - 1)
    slot_sorted = torch.where(keep_sorted, slot_sorted,
                              torch.full_like(slot_sorted,
                                              n_experts * capacity))
    inv = torch.argsort(order, stable=True)           # back to (T*k,) order
    return slot_sorted[inv], keep_sorted[inv]


def _expert_rows(topi: torch.Tensor, n_experts: int,
                 capacity: int) -> torch.Tensor:
    """(E,) int32: each expert's kept entries, its count in topi clamped
    to the capacity — the rows of its buffer that the dispatch fills
    (_dispatch_indices keeps an expert's first `capacity` entries).  A
    scatter, on the device: bincount would read its length on the host,
    a sync every layer."""
    flat = topi.reshape(-1)
    count = torch.zeros(n_experts, dtype=torch.int32,
                        device=topi.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.int32,
                            device=topi.device))
    return count.clamp_(max=capacity)


def _expert_ffn(cfg: ModelConfig, xb: torch.Tensor, params: dict,
                sh: PEContext,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xb: (E, C, d) -> (E, C, d): one program word per table, each a
    batched product over the E experts.  rows (E,): each expert's live
    rows of xb (the rest zero, and so the rest of every table's input
    and output: the activations map 0 to 0)."""
    h = sh.dot("moe_experts_in", xb, params["experts_in"], rows=rows)
    if cfg.act in ("swiglu", "geglu"):
        g = sh.dot("moe_experts_gate", xb, params["experts_gate"], rows=rows)
        h = (_silu(g) if cfg.act == "swiglu" else _gelu(g)) * h
    else:
        h = act_fn(cfg.act, h)
    return sh.dot("moe_experts_out", h, params["experts_out"], rows=rows)


def _moe_single(cfg: ModelConfig, x: torch.Tensor, params: dict,
                sh: PEContext):
    """Single-shard dropless MoE.  x: (B, S, d).  Returns (out (B, S, d),
    aux)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    topv, topi, aux = _route(xf, params["router"], m.top_k, sh)
    # dropless: C = T rounded up to 8; past 4096 tokens the capacity
    # factor bounds the (E * C, d) buffer
    C = (max(8, -(-T // 8) * 8) if T <= 4096
         else _capacity(T, m.top_k, m.n_experts))
    E = m.n_experts
    slot, keep = _dispatch_indices(topi.reshape(-1), E, C)
    rows = _expert_rows(topi, E, C)
    tok = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    src = torch.where(keep[:, None], xf[tok], torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    # kept entries own distinct rows; only the trash row (last) is written
    # more than once, so the real rows do not depend on the write order
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, src)
    yb = _expert_ffn(cfg, buf[:-1].reshape(E, C, d), params, sh, rows)
    ybp = torch.cat([yb.reshape(E * C, d),
                     torch.zeros((1, d), dtype=yb.dtype, device=x.device)])
    y = (ybp[slot] * keep[:, None]).reshape(T, m.top_k, d)
    out = (y.to(_F64) * topv.to(_F64)[..., None]).sum(dim=1).to(_F32)
    return out.to(x.dtype).reshape(B, S, d), aux


def moe_block(cfg: ModelConfig, x: torch.Tensor, params: dict,
              sh: PEContext):
    """Returns (out (B, S, d), aux_loss scalar): the single-shard path."""
    return _moe_single(cfg, x, params, sh)
