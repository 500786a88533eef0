"""The PE dispatch seam: every weight-bearing matmul runs through here.

``pe_dot(x, w, word=...)`` issues one PE program word (§4, Fig 12): the
compiled :class:`~repro_torch.core.program.PEWord` says which kernel each
phase uses.  Training runs the three-phase word as one
``torch.autograd.Function`` (the reference's ``_pe_matmul`` custom_vjp):

  FF — the ``sr_matmul`` MAC-array kernel at the word's FF dtype (f32
       accumulation),
  BP — dX = dY . W^T through ``sr_matmul`` with ``trans_b``: W is read
       transposed by the kernel, never materialised transposed,
  UP — dW = X^T dY through the ``outer_accum`` kernel, with the SR-bf16
       writeback fused when the word's rounding is sr / sr_lo and W is
       stored bf16.  Its entropy is drawn in backward only (a remat
       recompute of FF draws nothing), from a generator seeded by
       :func:`up_key` of the op's :func:`op_key` — or from an injected
       ``entropy(op, dY)`` hook, so tests can feed the reference's bits.

Serving phases dispatch forward-only words:

  PREFILL — the ``sr_matmul`` MAC-array kernel on a prompt chunk
            (f32 accumulation, no SR entropy),
  DECODE  — the bandwidth-oriented matvec word: one weight read per
            token, f32 accumulation (``torch.matmul`` on f32 operands,
            as the reference leaves this product to XLA),

A 3-D weight (E, K, N) is a batched expert table, with x of shape
(E, C, K): one program word for all E experts (the reference runs its
kernels under ``jax.vmap``: one ``pallas_call`` with an expert axis in
its grid).  PREFILL runs it as ONE ``sr_matmul_batched`` launch, DECODE
as one batched f32 ``torch.matmul``, and training through the same
``_PEMatmul`` Function as a 2-D weight: FF and BP one
``sr_matmul_batched`` launch each, UP one ``outer_accum_batched``
launch whose SR bits are one (E, D, F) draw from one generator seeded
by :func:`up_key` of the table's whole dY (the reference splits the key
per expert instead; each expert here reads its own part of the one
stream).  A bf16 word's launches take the kernels' sm90 path, an f32
word's (the ``fp32`` preset) their f32 path, whose UP has no SR.

plus :func:`pe_fused_attn_unit`, the ``decode_fused`` word that runs a
whole attention unit as one fused kernel call, and :func:`pe_fused_ffn`,
its FF half alone (norm2 + FF + residual) for units whose mixer stays
per-op (rwkv6).  A ``decode_fused`` word
that reaches the per-op seam executes as the plain matvec.

Backends:

  reference — plain torch (the CPU oracle).  Products accumulate in
              float64, where a sum of bf16 products is exact, so a row's
              result does not depend on how many rows share the call —
              chunked prefill and token-by-token decode then agree bit
              for bit, the engine's invariant.  Training differentiates
              it with autograd.
  cuda      — the hand-written kernels (their plain versions when the
              tensors lie on the CPU).
"""
from __future__ import annotations

import struct
import zlib
from typing import Callable, Optional

import torch

from repro_torch.core.phases import Phase
from repro_torch.core.precision import dtype_from_name
from repro_torch.core.program import PEWord
from repro_torch.core.rounding import fold_key, make_rbits
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import outer_accum as koa
from repro_torch.kernels import sr_matmul as kmm

BACKENDS = ("reference", "cuda")
SERVING_PHASES = (Phase.PREFILL, Phase.DECODE, Phase.DRAFT)
DEFAULT_WORD = PEWord(op="dot")


def op_key(key: Optional[int], op_name: str) -> int:
    """Per-op entropy stream: the op name's crc32 folded into the step
    key (crc32, not hash(): reproducible across processes)."""
    return fold_key(0 if key is None else key,
                    zlib.crc32(op_name.encode()) & 0x7FFFFFFF)


def up_key(key: int, dy: torch.Tensor) -> int:
    """The UP draw's seed: the op key folded with the f32 bit pattern of
    sum(dY).  The (step, op) pair alone recurs for every layer of the
    stack, every microbatch and every same-shaped slice of a fused
    weight; folding the gradient's content decorrelates those draws.
    (One host read of the sum per UP op.)"""
    s = float(dy.to(torch.float32).sum())
    return fold_key(key, struct.unpack("<I", struct.pack("<f", s))[0])


def _up_rbits(word: PEWord, dyt: torch.Tensor, shape: tuple,
              key: Optional[int], entropy: Optional[Callable]
              ) -> torch.Tensor:
    if entropy is not None:
        return entropy(word.op, dyt).to(dyt.device)
    gen = torch.Generator(device=dyt.device)
    gen.manual_seed(up_key(0 if key is None else key, dyt))
    return make_rbits(shape, gen, device=dyt.device,
                      lo=word.update_rounding == "sr_lo")


def _operand(t: torch.Tensor, dt_name: str, batched: bool) -> torch.Tensor:
    """t at the word's dtype `dt_name`, as the kernels take it.  A 2-D
    weight's operands go through ``kmm.operand`` (a column slice, such as
    rwkv6's rkvg quarters, is read in place, with no contiguous copy); an
    expert table's, bf16 or f32, are contiguous, as the batched kernels
    take them."""
    dt = dtype_from_name(dt_name)
    if not batched:
        return kmm.operand(t.to(dt))
    return t.to(dt).contiguous()


def _matmul(a: torch.Tensor, b: torch.Tensor, trans_b: bool,
            rows: Optional[torch.Tensor], out_dtype: torch.dtype
            ) -> torch.Tensor:
    """a @ b (or a @ b.T) with f32 accumulation, in out_dtype: ``sr_matmul``
    for a 2-D weight (f32 out, then cast), ONE ``sr_matmul_batched``
    launch over all experts for an expert table, which writes out_dtype
    itself and computes only each expert's `rows` live rows."""
    if b.dim() == 3:
        return kmm.sr_matmul_batched(a, b, trans_b=trans_b, rows=rows,
                                     out_dtype=out_dtype)
    return kmm.sr_matmul(a, b, None, trans_b=trans_b).to(out_dtype)


def _ff(x: torch.Tensor, w: torch.Tensor, word: PEWord, transpose_w: bool,
        rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    batched = w.dim() == 3
    return _matmul(_operand(x, word.ff_dtype, batched),
                   _operand(w, word.ff_dtype, batched), transpose_w, rows,
                   x.dtype)


class _PEMatmul(torch.autograd.Function):
    """The FF / BP / UP program word of one weight matmul: x (M, K) with
    a 2-D weight, or x (E, C, K) with an expert table (E, K, N) (or
    (E, N, K) with transpose_w), each phase then ONE launch over all E
    experts, which FF, BP and UP run over each expert's `rows` live rows
    (the remat FF and the backward see the same counts)."""

    @staticmethod
    def forward(ctx, x, w, word: PEWord, transpose_w: bool,
                key: Optional[int], entropy: Optional[Callable],
                rows: Optional[torch.Tensor]):
        ctx.save_for_backward(x, w)
        ctx.cfg = (word, transpose_w, key, entropy, rows)
        return _ff(x, w, word, transpose_w, rows)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        word, transpose_w, key, entropy, rows = ctx.cfg
        batched = w.dim() == 3
        gb = _operand(g, word.bp_dtype, batched)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # BP: f32 accumulation, no SR (the gradient signal is
            # transient, not persistent state)
            dx = _matmul(gb, _operand(w, word.bp_dtype, batched),
                         not transpose_w, rows, x.dtype)
        if ctx.needs_input_grad[1]:
            xb = _operand(x, word.bp_dtype, batched)
            xt, dyt = (gb, xb) if transpose_w else (xb, gb)
            sr = (word.update_rounding in ("sr", "sr_lo")
                  and w.dtype == torch.bfloat16)
            shape = (*xt.shape[:-2], xt.shape[-1], dyt.shape[-1])
            rbits = (_up_rbits(word, dyt, shape, key, entropy) if sr
                     else None)
            dw = (koa.outer_accum_batched(xt, dyt, rbits=rbits, rows=rows)
                  if batched else koa.outer_accum(xt, dyt, rbits=rbits))
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None, None


def _wt(w: torch.Tensor, transpose_w: bool) -> torch.Tensor:
    """w as (K, N), or (E, K, N) for an expert table: a view."""
    return w.transpose(-1, -2) if transpose_w else w


def _reference_dot(x: torch.Tensor, w: torch.Tensor,
                   transpose_w: bool) -> torch.Tensor:
    """float64 products (per expert for a 3-D table), rounded to f32 and
    then to x.dtype."""
    wt = _wt(w.to(x.dtype), transpose_w)
    y = torch.matmul(x.to(torch.float64), wt.to(torch.float64))
    return y.to(torch.float32).to(x.dtype)


def _matvec(x: torch.Tensor, w: torch.Tensor, word: PEWord,
            transpose_w: bool) -> torch.Tensor:
    """The DECODE word: operands at the FF dtype, f32 accumulation."""
    dt = dtype_from_name(word.ff_dtype)
    wt = _wt(w.to(dt), transpose_w)
    y = torch.matmul(x.to(dt).to(torch.float32), wt.to(torch.float32))
    return y.to(x.dtype)


def _prefill(x: torch.Tensor, w: torch.Tensor, word: PEWord,
             transpose_w: bool, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The PREFILL word: the sr_matmul kernel over the chunk's rows; for
    an expert table, one batched launch over every expert's live rows."""
    if w.dim() == 3:
        return _ff(x, w, word, transpose_w, rows)
    y = _ff(x.reshape(-1, x.shape[-1]), w, word, transpose_w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def pe_dot(x: torch.Tensor, w: torch.Tensor, *,
           word: Optional[PEWord] = None, backend: str = "reference",
           transpose_w: bool = False, phase: Phase = Phase.PREFILL,
           key: Optional[int] = None,
           entropy: Optional[Callable] = None,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch one weight-bearing matmul through its PE program word.

    x: (..., K); w: (K, N), or (N, K) with transpose_w, or an expert
    table (E, K, N) / (E, N, K) with x (E, C, K).  Returns (..., N) in
    x.dtype.  `phase` selects the word's column: FF (or BP /
    UP) runs the differentiable three-phase word, the serving phases the
    forward-only words.  `key` seeds the UP phase's SR entropy (the op's
    :func:`op_key`); `entropy(op, dY) -> rbits` replaces that draw (for
    an expert table dY is (E, C, F) and rbits (E, D, F)).  `rows` (E,)
    int32, for an expert table only: each expert's live rows of x (the
    rest are zero, as the MoE dispatch builds them); the cuda backend's
    batched launches (PREFILL, FF, BP, UP; bf16 and f32) compute only
    those, for the same result.  The reference backend and the DECODE
    matvec ignore it.
    """
    word = word or DEFAULT_WORD
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"one of {BACKENDS}")
    kern = word.kernel_for(phase)
    if backend == "reference" or kern == "vpu":
        return _reference_dot(x, w, transpose_w)
    if phase not in SERVING_PHASES:
        if w.dim() == 3:
            return _PEMatmul.apply(x, w, word, transpose_w, key, entropy,
                                   rows)
        lead = x.shape[:-1]
        y2 = _PEMatmul.apply(x.reshape(-1, x.shape[-1]), w, word,
                             transpose_w, key, entropy, None)
        return y2.reshape(*lead, y2.shape[-1])
    if kern in ("matvec", "decode_fused"):
        return _matvec(x, w, word, transpose_w)
    return _prefill(x, w, word, transpose_w, rows)


def fused_block_n(word: Optional[PEWord], default: int = 256) -> int:
    """The fused unit's FF column tile from the word's DECODE tiling."""
    if word is None:
        return default
    t = word.tiling_for(Phase.DECODE)
    return t[1] if t is not None else default


def pe_fused_attn_unit(x, cache: dict, pos, *, norm1: Optional[dict],
                       qkv_w, qkv_bias, o_w, norm2: Optional[dict] = None,
                       w_in=None, w_out=None, heads: int, kv_heads: int,
                       head_dim: int, rope_theta: float, window=None,
                       norm_kind: str, act: str, with_ffn: bool = True,
                       word: Optional[PEWord] = None, active=None):
    """Issue ONE fused-decode word for a whole attention unit.

    x: (B, d); cache: {"k", "v", "pos"} arena rows, updated in place on
    active rows; pos: (B,).  Returns y (B, d).
    """
    def nrm(p, key):
        return p.get(key) if p else None
    return kdf.fused_attn_unit(
        x, cache["k"], cache["v"], cache["pos"], pos,
        norm1_scale=nrm(norm1, "scale"), norm1_bias=nrm(norm1, "bias"),
        qkv_w=qkv_w, qkv_bias=qkv_bias, o_w=o_w,
        norm2_scale=nrm(norm2, "scale"), norm2_bias=nrm(norm2, "bias"),
        w_in=w_in, w_out=w_out, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, rope_theta=rope_theta, window=window,
        norm_kind=norm_kind, act=act, with_ffn=with_ffn,
        block_n=fused_block_n(word), active=active)


def pe_fused_ffn(x, *, norm2: Optional[dict], w_in, w_out, norm_kind: str,
                 act: str, word: Optional[PEWord] = None):
    """Issue ONE fused-decode word for a unit's FF half: x (B, d) ->
    x + FF(norm2(x)) (B, d)."""
    return kdf.fused_ffn(
        x, norm2_scale=norm2.get("scale") if norm2 else None,
        norm2_bias=norm2.get("bias") if norm2 else None, w_in=w_in,
        w_out=w_out, norm_kind=norm_kind, act=act,
        block_n=fused_block_n(word))
