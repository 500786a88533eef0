"""Decoder-only LM: dense attention units, RWKV6 units and attention
units with a mixture-of-experts FF (MoE models), each trained and served.

Parameters keep the reference's pytree layout: per-unit leaves stacked
over ``n_groups`` scan groups (``params["groups"]["u0"]["attn"]["qkv"]``
is (n_groups, d, (H+2K)*hd)).  Where the reference scans the groups with
``lax.scan``, the port loops over them in Python.  Serving takes each
group's slice as a view, so the in-place cache updates land in the
stacked arena; training takes all of them with one ``torch.unbind`` per
leaf, whose backward stacks the group gradients once (indexing each
group instead would build a zero-filled gradient of the whole stacked
leaf per group).

Entry points:
  init(generator, cfg) / init_cache(cfg, batch, max_len)
  forward(...) / loss_fn(...) — training (full sequence, FF word;
                     autograd runs BP and UP), remat per scan group; a
                     MoE unit's load-balancing value rides along (aux)
  chunk_step(...)  — T prompt tokens against the caches (PREFILL word)
  decode_step(...) — one token per arena row (DECODE word), per-op or
                     fused (one ``decode_fused`` word per layer; an rwkv6
                     unit keeps its mixer per-op and fuses its FF half, a
                     MoE unit fuses its attention half and routes its FF
                     per-op)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.context import PEContext
from repro_torch.engine.dispatch import pe_fused_attn_unit, pe_fused_ffn
from repro_torch.models.attention import (attention_block, attn_params,
                                          chunk_attend, decode_attend,
                                          init_kv_cache, split_qkv,
                                          update_cache, update_cache_chunk)
from repro_torch.models.layers import (apply_norm, apply_rope, embed,
                                       lm_logits, lm_loss_chunked, mlp,
                                       norm_params)
from repro_torch.models.moe import moe_block, moe_params
from repro_torch.models.ssm import (rwkv_block, rwkv_init_state,
                                    rwkv_params)


@dataclass(frozen=True)
class UnitDesc:
    mixer: str            # 'attn' | 'rwkv6'
    ffn: str              # 'dense' | 'moe'


def layer_pattern(cfg: ModelConfig) -> list:
    """One scan group's units: a single layer for every family here.  A
    MoE model takes a MoE FF on every layer (``moe_period`` 1, as
    granite's ``is_moe_layer`` picks), with no dense FF beside it."""
    if cfg.family == "dense" and cfg.attention is not None:
        return [UnitDesc("attn", "dense")]
    if cfg.family == "ssm" and cfg.ssm is not None \
            and cfg.ssm.kind == "rwkv6":
        return [UnitDesc("rwkv6", "dense")]
    if cfg.family == "moe" and cfg.attention is not None \
            and cfg.moe.moe_period == 1 and not cfg.moe.dense_residual:
        return [UnitDesc("attn", "moe")]
    raise NotImplementedError(
        f"{cfg.name}: the port runs dense attention, rwkv6 and MoE models "
        f"with a MoE FF on every layer and no dense residual only")


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(layer_pattern(cfg))


def _tree_index(tree, g: int):
    """Group g's slice of a stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, g) for k, v in tree.items()}
    return tree[g]


def _group_slices(tree, ng: int) -> list:
    """Every group's slice of a stacked tree: one unbind per leaf."""
    if isinstance(tree, dict):
        parts = {k: _group_slices(v, ng) for k, v in tree.items()}
        return [{k: p[g] for k, p in parts.items()} for g in range(ng)]
    return torch.unbind(tree, 0)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(generator: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """f32 parameters drawn on the generator's device, in the reference's
    layout and scales (normal * d^-0.5 projections, embed * 0.02, ones /
    zeros for norm scales and the qkv bias).  generator=None gives the
    same tree on the meta device: shapes and dtypes, nothing allocated
    (the reference's ``param_shapes``)."""
    ng = n_groups(cfg)
    dev = generator.device if generator is not None else torch.device("meta")
    d, f = cfg.d_model, cfg.d_ff
    fin = 2 * f if cfg.act in ("swiglu", "geglu") else f

    def normal(*shape):
        if generator is None:
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)

    params: dict = {"embed": {"table": normal(cfg.vocab_size, d) * 0.02}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, cfg.vocab_size) * 0.02
    fn = norm_params(cfg, device=dev)
    if fn is not None:
        params["final_norm"] = fn
    unit: dict = {}
    for key in ("norm1", "norm2"):
        p = norm_params(cfg, device=dev, lead=(ng,))
        if p is not None:
            unit[key] = p
    desc = layer_pattern(cfg)[0]
    if desc.mixer == "attn":
        unit["attn"] = attn_params(cfg, generator, lead=(ng,))
    else:
        unit["rwkv"] = rwkv_params(cfg, generator, lead=(ng,))
    if desc.ffn == "moe":
        unit["moe"] = moe_params(cfg, generator, lead=(ng,))
    else:
        unit["ffn"] = {"ffn_in": normal(ng, d, fin) * d ** -0.5,
                       "ffn_out": normal(ng, f, d) * f ** -0.5}
    params["groups"] = {"u0": unit}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Per-group stacked caches, leaves shaped (n_groups, batch, ...):
    {"u0": {"attn": {k, v, pos}}} or {"u0": {"rwkv": {wkv, shift}}}."""
    lead = (n_groups(cfg),)
    if layer_pattern(cfg)[0].mixer == "rwkv6":
        return {"u0": {"rwkv": rwkv_init_state(cfg, batch, device=device,
                                               lead=lead)}}
    return {"u0": {"attn": init_kv_cache(cfg.attention, batch, max_len,
                                         device=device, lead=lead)}}


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------


def _unit_forward(cfg: ModelConfig, x, up: dict, unit: UnitDesc,
                  sh: PEContext, positions):
    """One unit over the full sequence from no state.  x: (B, S, d).
    Returns (x, aux): aux is the MoE FF's load-balancing value, None for
    a dense FF."""
    h = apply_norm(cfg, x, up.get("norm1"))
    if unit.mixer == "attn":
        x = x + attention_block(cfg, h, up["attn"], sh, positions=positions)
    else:
        x = x + rwkv_block(cfg, h, up["rwkv"], sh)
    h2 = apply_norm(cfg, x, up.get("norm2"))
    if unit.ffn == "moe":
        y, aux = moe_block(cfg, h2, up["moe"], sh)
        return x + y, aux
    return x + mlp(cfg, h2, up["ffn"]["ffn_in"], up["ffn"]["ffn_out"],
                   sh), None


def prologue(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
             compute_dtype=torch.bfloat16) -> tuple:
    """Embedding: everything before the first layer group.  Returns
    (x (B, S, d), positions (S,))."""
    x = embed(tokens, params["embed"]["table"]).to(compute_dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    return x, positions


def group_scan(cfg: ModelConfig, x: torch.Tensor, aux: torch.Tensor,
               groups: dict, sh: PEContext, positions: torch.Tensor, *,
               remat="none") -> tuple:
    """Run the scan groups in order: the body of :func:`forward`.
    Returns (x, aux), aux the carried sum of the MoE units' values (the
    reference's scan carry (x, aux)).

    remat: 'none' | 'block' | 'full', or one mode per group.  'block'
    and 'full' run the group under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of the scan body): its FF words run
    again in backward, its activations are not kept.  Values are
    identical across modes; only what autograd saves differs.
    """
    pattern = layer_pattern(cfg)
    ng = n_groups(cfg)
    modes = [remat] * ng if isinstance(remat, str) else list(remat)
    if len(modes) != ng:
        raise ValueError(f"per-group remat has {len(modes)} entries for "
                         f"{ng} scan groups")

    def group_step(x, aux, gp):
        for i, unit in enumerate(pattern):
            x, a = _unit_forward(cfg, x, gp[f"u{i}"], unit, sh, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    for gp, mode in zip(_group_slices(groups, ng), modes):
        if mode in ("block", "full"):
            x, aux = checkpoint(group_step, x, aux, gp, use_reentrant=False)
        elif mode == "none":
            x, aux = group_step(x, aux, gp)
        else:
            raise ValueError(f"unknown remat mode {mode!r}")
    return x, aux


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            sh: PEContext, *, compute_dtype=torch.bfloat16, remat="none",
            return_hidden: bool = False) -> tuple:
    """tokens: (B, S).  Returns (logits f32 (B, S, V), or the final-normed
    hidden states with return_hidden; aux f32 scalar, the sum of the MoE
    units' load-balancing values, 0 without MoE units)."""
    x, positions = prologue(cfg, params, tokens,
                            compute_dtype=compute_dtype)
    x, aux = group_scan(cfg, x, torch.zeros((), dtype=torch.float32,
                                            device=x.device),
                        params["groups"], sh, positions, remat=remat)
    x = apply_norm(cfg, x, params.get("final_norm"))
    if return_hidden:
        return x, aux
    return lm_logits(x, cfg, params, sh), aux


def head_loss(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
              aux: torch.Tensor, labels: torch.Tensor, sh: PEContext
              ) -> torch.Tensor:
    """The loss head on the final-normed hidden states; a MoE model adds
    ``cfg.moe.aux_loss_weight`` (0.01, the weight the reference's loss_fn
    applies) x the units' load-balancing value."""
    loss = lm_loss_chunked(cfg, hidden, params, labels, sh)
    if cfg.moe is None:
        return loss
    return loss + cfg.moe.aux_loss_weight * aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, sh: PEContext, *,
            compute_dtype=torch.bfloat16, remat="none") -> torch.Tensor:
    hidden, aux = forward(cfg, params, batch["tokens"], sh,
                          compute_dtype=compute_dtype, remat=remat,
                          return_hidden=True)
    return head_loss(cfg, params, hidden, aux, batch["labels"], sh)


# ---------------------------------------------------------------------------
# Units (serving)
# ---------------------------------------------------------------------------


def _attn_decode(cfg: ModelConfig, h, up: dict, sh: PEContext, cache: dict,
                 pos: torch.Tensor, active: Optional[torch.Tensor]):
    """The attention mixer of one decode step: h (B, 1, d) -> (B, 1, d)."""
    a = cfg.attention
    qkv = sh.dot("attn_qkv", h, up["attn"]["qkv"])
    q, k, v = split_qkv(a, qkv, up["attn"].get("qkv_bias"))
    B = h.shape[0]
    K_, G, hd = q.shape[2:]
    posb = pos[:, None]
    q = apply_rope(q.reshape(B, 1, K_ * G, hd), posb,
                   a.rope_theta).reshape(B, 1, K_, G, hd)
    k = apply_rope(k, posb, a.rope_theta)
    c = cache["attn"]
    if active is None:
        update_cache(c, k[:, 0], v[:, 0], pos)
        kc, vc, kp = c["k"], c["v"], c["pos"]
    else:
        # inactive rows keep their cache; their (discarded) output still
        # attends over the row with the new entry, as the reference's
        # compute-then-restore does
        kc, vc, kp = c["k"].clone(), c["v"].clone(), c["pos"].clone()
        update_cache({"k": kc, "v": vc, "pos": kp}, k[:, 0], v[:, 0], pos)
        update_cache(c, k[:, 0], v[:, 0], pos, active)
    out = decode_attend(q[:, 0], kc, vc, kp, pos, window=a.window)
    return sh.dot("attn_o", out.reshape(B, 1, -1), up["attn"]["o"])


def _unit_ffn(cfg: ModelConfig, x, up: dict, unit: UnitDesc,
              sh: PEContext):
    """The unit's FF half: x + FF(norm2(x)), the FF dense or MoE."""
    h2 = apply_norm(cfg, x, up.get("norm2"))
    if unit.ffn == "moe":
        return x + moe_block(cfg, h2, up["moe"], sh)[0]
    return x + mlp(cfg, h2, up["ffn"]["ffn_in"], up["ffn"]["ffn_out"], sh)


def _unit_decode(cfg: ModelConfig, x, up: dict, unit: UnitDesc,
                 sh: PEContext, cache: dict, pos: torch.Tensor,
                 active: Optional[torch.Tensor]):
    """x: (B, 1, d); pos: (B,).  Per-op words; returns x."""
    h = apply_norm(cfg, x, up.get("norm1"))
    if unit.mixer == "attn":
        x = x + _attn_decode(cfg, h, up, sh, cache, pos, active)
    else:
        x = x + rwkv_block(cfg, h, up["rwkv"], sh, cache["rwkv"], active)
    return _unit_ffn(cfg, x, up, unit, sh)


def _fused_norm_args(cfg: ModelConfig, up: dict, key: str):
    """(norm params, kernel norm kind): nonparametric_ln is a layernorm
    with no affine operands."""
    if cfg.norm == "nonparametric_ln":
        return None, "layernorm"
    return up.get(key), cfg.norm


def _unit_decode_fused(cfg: ModelConfig, x, up: dict, unit: UnitDesc,
                       sh: PEContext, cache: dict, pos: torch.Tensor,
                       active: Optional[torch.Tensor]):
    """The unit as ONE fused-decode word.

    On the cuda backend an attention unit runs as one ``fused_attn_unit``
    call (kernels/decode_fused.py); an rwkv6 unit keeps its recurrence on
    its per-op path (a state word, as the reference keeps it) and runs
    its FF half as one ``fused_ffn`` call; a MoE unit runs its attention
    half as one ``fused_attn_unit`` call without the FF (five launches)
    and then norm2 and the MoE block per op.  On the reference backend the
    fused composition is the per-op primitive sequence itself, so fused
    decode is bit-identical per request to the per-op loop.
    """
    if sh.backend == "reference":
        return _unit_decode(cfg, x, up, unit, sh, cache, pos, active)
    n1, nk = _fused_norm_args(cfg, up, "norm1")
    n2, _ = _fused_norm_args(cfg, up, "norm2")
    if unit.mixer == "rwkv6":
        h = apply_norm(cfg, x, up.get("norm1"))
        x = x + rwkv_block(cfg, h, up["rwkv"], sh, cache["rwkv"], active)
        y = pe_fused_ffn(x[:, 0].contiguous(), norm2=n2,
                         w_in=up["ffn"]["ffn_in"], w_out=up["ffn"]["ffn_out"],
                         norm_kind=nk, act=cfg.act, word=sh.word("ffn_in"))
        return y[:, None]
    a = cfg.attention
    dense = unit.ffn == "dense"
    y = pe_fused_attn_unit(
        x[:, 0].contiguous(), cache["attn"], pos, norm1=n1,
        qkv_w=up["attn"]["qkv"], qkv_bias=up["attn"].get("qkv_bias"),
        o_w=up["attn"]["o"], norm2=n2 if dense else None,
        w_in=up["ffn"]["ffn_in"] if dense else None,
        w_out=up["ffn"]["ffn_out"] if dense else None, heads=a.n_heads,
        kv_heads=a.n_kv_heads, head_dim=a.head_dim, rope_theta=a.rope_theta,
        window=a.window, norm_kind=nk, act=cfg.act, with_ffn=dense,
        word=sh.word("attn_qkv"), active=active)
    if dense:
        return y[:, None]
    return _unit_ffn(cfg, y[:, None], up, unit, sh)


def _unit_chunk(cfg: ModelConfig, x, up: dict, unit: UnitDesc,
                sh: PEContext, cache: dict, pos: torch.Tensor):
    """Chunked-prefill unit step.  x: (B, T, d); pos: (B, T).  The rwkv6
    recurrence consumes the whole chunk from the carried state."""
    h = apply_norm(cfg, x, up.get("norm1"))
    if unit.mixer == "attn":
        x = x + _attn_chunk(cfg, h, up, sh, cache, pos)
    else:
        x = x + rwkv_block(cfg, h, up["rwkv"], sh, cache["rwkv"])
    return _unit_ffn(cfg, x, up, unit, sh)


def _attn_chunk(cfg: ModelConfig, h, up: dict, sh: PEContext, cache: dict,
                pos: torch.Tensor):
    """The attention mixer of a chunk: h (B, T, d) -> (B, T, d)."""
    a = cfg.attention
    qkv = sh.dot("attn_qkv", h, up["attn"]["qkv"])
    q, k, v = split_qkv(a, qkv, up["attn"].get("qkv_bias"))
    B, T = h.shape[:2]
    K_, G, hd = q.shape[2:]
    q = apply_rope(q.reshape(B, T, K_ * G, hd), pos,
                   a.rope_theta).reshape(B, T, K_, G, hd)
    k = apply_rope(k, pos, a.rope_theta)
    c = cache["attn"]
    if a.window is not None:
        # windowed ring: a later in-chunk token may overwrite a slot an
        # earlier query still needs — insert + attend token by token
        outs = []
        for t in range(T):
            update_cache(c, k[:, t], v[:, t], pos[:, t])
            outs.append(decode_attend(q[:, t], c["k"], c["v"], c["pos"],
                                      pos[:, t], window=a.window))
        out = torch.stack(outs, dim=1)
    else:
        update_cache_chunk(c, k, v, pos)
        out = chunk_attend(q, c["k"], c["v"], c["pos"], pos)
    return sh.dot("attn_o", out.reshape(B, T, -1), up["attn"]["o"])


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def chunk_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               cache: dict, pos0: torch.Tensor, sh: PEContext, *,
               compute_dtype=torch.bfloat16):
    """T prompt tokens against the caches.  tokens: (B, T); pos0: (B,).

    Returns (logits (B, T, V) f32, cache) — the cache updated in place.
    """
    pattern = layer_pattern(cfg)
    T = tokens.shape[1]
    pos = pos0.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=tokens.device)[None]
    x = embed(tokens, params["embed"]["table"]).to(compute_dtype)
    for g in range(n_groups(cfg)):
        gp = _tree_index(params["groups"], g)
        gc = _tree_index(cache, g)
        for i, unit in enumerate(pattern):
            x = _unit_chunk(cfg, x, gp[f"u{i}"], unit, sh, gc[f"u{i}"], pos)
    x = apply_norm(cfg, x, params.get("final_norm"))
    return lm_logits(x, cfg, params, sh), cache


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor, sh: PEContext, *,
                compute_dtype=torch.bfloat16, fused: bool = False,
                active: Optional[torch.Tensor] = None):
    """One serve step.  tokens: (B, 1); pos: (B,).  Returns (logits
    (B, 1, V) f32, cache); the cache is updated in place on the rows
    `active` selects (None = all rows)."""
    pattern = layer_pattern(cfg)
    unit_fn = _unit_decode_fused if fused else _unit_decode
    pos = pos.to(torch.int32)
    x = embed(tokens, params["embed"]["table"]).to(compute_dtype)
    for g in range(n_groups(cfg)):
        gp = _tree_index(params["groups"], g)
        gc = _tree_index(cache, g)
        for i, unit in enumerate(pattern):
            x = unit_fn(cfg, x, gp[f"u{i}"], unit, sh, gc[f"u{i}"], pos,
                        active)
    x = apply_norm(cfg, x, params.get("final_norm"))
    return lm_logits(x, cfg, params, sh), cache
