"""The PE dispatch seam: every weight-bearing matmul runs through here.

``pe_dot(x, w, word=...)`` issues one PE program word (§4, Fig 12): the
compiled :class:`~repro_torch.core.program.PEWord` says which kernel each
phase uses.  This slice ports the forward-only serving words:

  PREFILL — the ``sr_matmul`` MAC-array kernel on a prompt chunk
            (f32 accumulation, no SR entropy),
  DECODE  — the bandwidth-oriented matvec word: one weight read per
            token, f32 accumulation (``torch.matmul`` on f32 operands,
            as the reference leaves this product to XLA),

plus :func:`pe_fused_attn_unit`, the ``decode_fused`` word that runs a
whole attention unit as one fused kernel call.  A ``decode_fused`` word
that reaches the per-op seam executes as the plain matvec.

Backends:

  reference — plain torch (the CPU oracle).  Products accumulate in
              float64, where a sum of bf16 products is exact, so a row's
              result does not depend on how many rows share the call —
              chunked prefill and token-by-token decode then agree bit
              for bit, the engine's invariant.
  cuda      — the hand-written kernels (their plain versions when the
              tensors lie on the CPU).

The training words (FF / BP / UP with the custom backward) come with the
training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.phases import Phase
from repro_torch.core.precision import dtype_from_name
from repro_torch.core.program import PEWord
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import sr_matmul as kmm

BACKENDS = ("reference", "cuda")
SERVING_PHASES = (Phase.PREFILL, Phase.DECODE, Phase.DRAFT)
DEFAULT_WORD = PEWord(op="dot")


def _reference_dot(x: torch.Tensor, w: torch.Tensor,
                   transpose_w: bool) -> torch.Tensor:
    wt = w.to(x.dtype)
    y = torch.matmul(x.to(torch.float64),
                     (wt.t() if transpose_w else wt).to(torch.float64))
    return y.to(torch.float32).to(x.dtype)


def _matvec(x: torch.Tensor, w: torch.Tensor, word: PEWord,
            transpose_w: bool) -> torch.Tensor:
    """The DECODE word: operands at the FF dtype, f32 accumulation."""
    dt = dtype_from_name(word.ff_dtype)
    wt = w.to(dt)
    y = torch.matmul(x.to(dt).to(torch.float32),
                     (wt.t() if transpose_w else wt).to(torch.float32))
    return y.to(x.dtype)


def _prefill(x: torch.Tensor, w: torch.Tensor, word: PEWord,
             transpose_w: bool) -> torch.Tensor:
    """The PREFILL word: the sr_matmul kernel over the chunk's rows."""
    dt = dtype_from_name(word.ff_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(dt).contiguous()
    y = kmm.sr_matmul(x2, w.to(dt).contiguous(), None, trans_b=transpose_w)
    n = w.shape[0] if transpose_w else w.shape[-1]
    return y.to(x.dtype).reshape(*lead, n)


def pe_dot(x: torch.Tensor, w: torch.Tensor, *,
           word: Optional[PEWord] = None, backend: str = "reference",
           transpose_w: bool = False,
           phase: Phase = Phase.PREFILL) -> torch.Tensor:
    """Dispatch one weight-bearing matmul through its PE program word.

    x: (..., K); w: (K, N), or (N, K) with transpose_w.  Returns
    (..., N) in x.dtype.
    """
    word = word or DEFAULT_WORD
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"one of {BACKENDS}")
    kern = word.kernel_for(phase)
    if backend == "reference" or kern == "vpu":
        return _reference_dot(x, w, transpose_w)
    if phase not in SERVING_PHASES:
        raise NotImplementedError(
            f"{phase} words come with the training slice of the port")
    if kern in ("matvec", "decode_fused"):
        return _matvec(x, w, word, transpose_w)
    return _prefill(x, w, word, transpose_w)


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
