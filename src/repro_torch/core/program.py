"""iBuffer: the compiled per-layer program for a model (§4, Fig 12).

:func:`compile_program` extracts the weight-bearing ops from a
``ModelConfig``, plans them (core/dataflow.py), attaches the precision
policy and emits a :class:`Program` whose :meth:`Program.pe_word` is the
executable word the engine dispatches on.  A serving program compiled
with ``speculative=True`` carries the DRAFT column too (the speculative
draft model's width-1 step).  Single-device subset: the autotuner's
tilings are not ported yet (words carry the kernels' default tiles).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.dataflow import (DataflowPlan, MeshSpec, OpSpec,
                                       SINGLE_DEVICE, Strategy, plan_model)
from repro_torch.core.phases import Phase
from repro_torch.core.precision import (PrecisionPolicy, dtype_name,
                                        get_policy)


def _ffn_in_width(cfg: ModelConfig, hidden: int) -> int:
    return 2 * hidden if cfg.act in ("swiglu", "geglu") else hidden


def _attn_ops(cfg: ModelConfig, n_layers: int) -> list:
    a = cfg.attention
    d = cfg.d_model
    q_out = a.n_heads * a.head_dim
    kv_out = 2 * a.n_kv_heads * a.head_dim
    return [
        OpSpec("attn_qkv", (d, q_out + kv_out), "proj_in",
               n_layers=n_layers, act_in_features=d,
               act_out_features=q_out + kv_out,
               flops_per_token=2 * d * (q_out + kv_out)),
        OpSpec("attn_o", (q_out, d), "proj_out", n_layers=n_layers,
               act_in_features=q_out, act_out_features=d,
               flops_per_token=2 * q_out * d),
    ]


def _ffn_ops(cfg: ModelConfig, n_layers: int) -> list:
    d, f = cfg.d_model, cfg.d_ff
    fin = _ffn_in_width(cfg, f)
    return [
        OpSpec("ffn_in", (d, fin), "proj_in", n_layers=n_layers,
               act_in_features=d, act_out_features=fin,
               flops_per_token=2 * d * fin),
        OpSpec("ffn_out", (f, d), "proj_out", n_layers=n_layers,
               act_in_features=f, act_out_features=d,
               flops_per_token=2 * f * d),
    ]


def _moe_ops(cfg: ModelConfig, n_layers: int) -> list:
    """The router (a 'state' op: VPU routing math, never a MAC kernel)
    and the expert tables; gate and up are separate tables."""
    m = cfg.moe
    d, fe = cfg.d_model, m.d_expert
    frac = m.top_k / m.n_experts
    ops = [
        OpSpec("moe_router", (d, m.n_experts), "state", n_layers=n_layers,
               act_in_features=d, act_out_features=m.n_experts,
               flops_per_token=2 * d * m.n_experts),
        OpSpec("moe_experts_in", (m.n_experts, d, fe), "expert_in",
               n_layers=n_layers, act_in_features=d, act_out_features=fe,
               flops_per_token=2 * d * fe * m.n_experts * frac,
               top_k=m.top_k),
        OpSpec("moe_experts_out", (m.n_experts, fe, d), "expert_out",
               n_layers=n_layers, act_in_features=fe, act_out_features=d,
               flops_per_token=2 * fe * d * m.n_experts * frac,
               top_k=m.top_k),
    ]
    if cfg.act in ("swiglu", "geglu"):
        ops.append(OpSpec("moe_experts_gate", (m.n_experts, d, fe),
                          "expert_in", n_layers=n_layers, act_in_features=d,
                          act_out_features=fe,
                          flops_per_token=2 * d * fe * m.n_experts * frac,
                          top_k=m.top_k))
    return ops


def _ssm_ops(cfg: ModelConfig, n_layers: int) -> list:
    """An SSM mixer's words.  RWKV6: the fused r, k, v, g projection
    feeding the WKV6 recurrence, the data-dependent decay and the output.
    Mamba: the (x, z) input projection, the depthwise conv (a 'state'
    op: VPU work, never a MAC kernel), the (dt, B, C) projection, dt's
    rank-r expansion and the output."""
    s, d = cfg.ssm, cfg.d_model
    if s.kind == "rwkv6":
        return [
            OpSpec("rwkv_rkvg", (d, 4 * d), "proj_in", n_layers=n_layers,
                   act_in_features=d, act_out_features=4 * d,
                   flops_per_token=8 * d * d),
            OpSpec("rwkv_decay", (d, d), "proj_in", n_layers=n_layers,
                   act_in_features=d, act_out_features=d,
                   flops_per_token=2 * d * d),
            OpSpec("rwkv_o", (d, d), "proj_out", n_layers=n_layers,
                   act_in_features=d, act_out_features=d,
                   flops_per_token=2 * d * d),
        ]
    di, r, N = s.inner(d), s.rank(d), s.d_state
    return [
        OpSpec("mamba_in", (d, 2 * di), "proj_in", n_layers=n_layers,
               act_in_features=d, act_out_features=2 * di,
               flops_per_token=4 * d * di),
        OpSpec("mamba_conv", (di, s.d_conv), "state", n_layers=n_layers),
        OpSpec("mamba_xproj", (di, r + 2 * N), "proj_in", n_layers=n_layers,
               act_in_features=di, act_out_features=r + 2 * N,
               flops_per_token=2 * di * (r + 2 * N)),
        OpSpec("mamba_dt", (r, di), "proj_in", n_layers=n_layers,
               act_in_features=r, act_out_features=di,
               flops_per_token=2 * r * di),
        OpSpec("mamba_out", (di, d), "proj_out", n_layers=n_layers,
               act_in_features=di, act_out_features=d,
               flops_per_token=2 * di * d),
    ]


def extract_ops(cfg: ModelConfig) -> list:
    """Weight-bearing op list, one OpSpec per layer class, in the
    reference's order: embed / head, attention, SSM mixer, MoE, dense FF
    (counted per layer kind; a dense residual adds the MoE layers to the
    dense FF's count)."""
    if cfg.family not in ("dense", "ssm", "moe", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense, ssm, moe and hybrid models "
            f"only")
    d, V = cfg.d_model, cfg.vocab_size
    L = cfg.n_layers
    ops = [OpSpec("embed", (V, d), "embed", act_in_features=0,
                  act_out_features=d, flops_per_token=0.0)]
    if not cfg.tie_embeddings:
        ops.append(OpSpec("lm_head", (d, V), "lm_head", act_in_features=d,
                          act_out_features=V, flops_per_token=2 * d * V))
    n_attn = sum(1 for i in range(L) if cfg.is_attention_layer(i))
    n_moe = sum(1 for i in range(L) if cfg.is_moe_layer(i))
    n_dense_ffn = L - n_moe
    if n_attn:
        ops += _attn_ops(cfg, n_attn)
    if L > n_attn:
        ops += _ssm_ops(cfg, L - n_attn)
    if n_moe:
        ops += _moe_ops(cfg, n_moe)
        if cfg.moe.dense_residual:
            n_dense_ffn += n_moe
    if n_dense_ffn:
        ops += _ffn_ops(cfg, n_dense_ffn)
    return ops


@dataclass(frozen=True)
class PEWord:
    """Executable PE program word for one op (Table 4's PE entry): which
    kernel runs each phase and at what precision / rounding."""
    op: str
    strategy: str = "replicate"
    ff_dtype: str = "bfloat16"
    bp_dtype: str = "bfloat16"
    update_rounding: str = "nearest"
    ff_kernel: str = "sr_matmul"
    bp_kernel: str = "sr_matmul_t"
    up_kernel: str = "outer_accum"
    prefill_kernel: str = "sr_matmul"
    decode_kernel: str = "matvec"
    draft_kernel: str = "matvec"
    # per-phase tiles: (("FF", (tm, tn, tk)), ...); empty = kernel defaults
    tiling: tuple = ()

    def tiling_for(self, phase: Phase) -> Optional[tuple]:
        for ph, tile in self.tiling:
            if ph == str(phase):
                return tuple(tile)
        return None

    def kernel_for(self, phase: Phase) -> str:
        if phase == Phase.FF:
            return self.ff_kernel
        if phase == Phase.BP:
            return self.bp_kernel
        if phase == Phase.PREFILL:
            return self.prefill_kernel
        if phase == Phase.DECODE:
            return self.decode_kernel
        if phase == Phase.DRAFT:
            return self.draft_kernel
        return self.up_kernel


_VPU_WORD_KERNELS = dict(ff_kernel="vpu", bp_kernel="vpu", up_kernel="vpu",
                         prefill_kernel="vpu", decode_kernel="vpu",
                         draft_kernel="vpu")


@dataclass
class Program:
    """Everything the runtime needs for one (model, shape) cell."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh_spec: MeshSpec
    policy: PrecisionPolicy
    plan: DataflowPlan
    ops: list
    # serving modes: fused_decode selects the ``decode_fused`` DECODE word
    # for the per-layer projections; speculative adds the DRAFT column
    fused_decode: bool = False
    speculative: bool = False

    def op_spec(self, op_name: str) -> Optional[OpSpec]:
        for op in self.ops:
            if op.name == op_name:
                return op
        return None

    def pe_word(self, op_name: str) -> PEWord:
        """The executable program word the engine dispatches on.

        fused_decode: the per-layer projections (proj_in / proj_out roles)
        run inside one fused-decode launch per layer, so their DECODE word
        selects ``decode_fused``; embed, head and the expert tables stay
        ``matvec``.
        """
        spec = self.op_spec(op_name)
        strategy = (str(self.plan[op_name].strategy)
                    if op_name in self.plan.ops else str(Strategy.REPLICATE))
        if spec is not None and spec.role == "state":
            return PEWord(op=op_name, strategy=strategy,
                          ff_dtype="float32", bp_dtype="float32",
                          update_rounding="nearest", **_VPU_WORD_KERNELS)
        decode_kernel = "matvec"
        if self.fused_decode and spec is not None \
                and spec.role in ("proj_in", "proj_out"):
            decode_kernel = "decode_fused"
        return PEWord(
            op=op_name, strategy=strategy,
            ff_dtype=dtype_name(self.policy.compute_dtype(Phase.FF)),
            bp_dtype=dtype_name(self.policy.compute_dtype(Phase.BP)),
            update_rounding=self.policy.update_rounding,
            decode_kernel=decode_kernel)

    def ibuffer_entries(self) -> list:
        """The per-(op x phase) program words — the iBuffer image."""
        if self.shape.kind == "train":
            phases = [Phase.FF, Phase.BP, Phase.UP]
        elif self.shape.kind == "prefill":
            phases = [Phase.PREFILL]
        elif self.speculative:
            phases = [Phase.PREFILL, Phase.DECODE, Phase.DRAFT]
        else:
            phases = [Phase.PREFILL, Phase.DECODE]
        out = []
        for name in sorted(self.plan.ops):
            w = self.pe_word(name)
            for ph in phases:
                out.append({"op": name, "phase": str(ph),
                            "strategy": w.strategy,
                            "dtype": (w.bp_dtype if ph in (Phase.BP, Phase.UP)
                                      else w.ff_dtype),
                            "rounding": (w.update_rounding
                                         if ph == Phase.UP else "nearest"),
                            "kernel": w.kernel_for(ph)})
        return out


def compile_program(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_spec: MeshSpec = SINGLE_DEVICE, *,
                    precision: str = "paper_sr_bf16",
                    fused_decode: bool = False,
                    speculative: bool = False) -> Program:
    """The 'host' step of Fig 12 on one device: model -> program words.
    fused_decode: the per-layer projections' DECODE word is
    ``decode_fused``; speculative: the iBuffer image carries the DRAFT
    word column (the draft step stays the per-op matvec)."""
    policy = get_policy(precision)
    ops = extract_ops(cfg)
    plan = plan_model(ops, mesh_spec, kind=shape.kind)
    return Program(cfg=cfg, shape=shape, mesh_spec=mesh_spec, policy=policy,
                   plan=plan, ops=ops, fused_decode=fused_decode,
                   speculative=speculative)
