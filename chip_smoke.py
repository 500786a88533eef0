#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only ``torch`` and the
port (``src/repro_torch``), never JAX or the JAX package, and:

1. builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, concurrently), prints the build seconds and
   each kernel's registers and spills;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes qwen2-0.5b's serving and training paths give it, and times
   kernel, plain version and, where one exists, the one torch call
   computing the same function: sr_matmul at the PREFILL shapes (each
   product's plan — sm90 or generic path, tiles, splits — rows 0..4 of
   a chunk bit-equal to a 5-row call, device time in a CUDA graph, the
   host's share of a call), and at the FF and BP shapes of a training
   step (K up to 151936, split-K calls bit-equal twice) with bf16 and
   with f32 operands (the f32 ones also in a CUDA graph);
   fused_attn_unit (device time in a CUDA graph, the host's share split
   into wrapper and ctypes call, two calls bit-equal, rows independent
   of B, and a full-width head_dim-128 case at olmo-1b's
   shapes; each of its seven launches' share of the device time comes
   from launch/bench_decode.py in a process of its own, at the end);
   outer_accum at the five UP
   shapes of a step, both operand types; sr_round on the largest
   optimizer leaf; the generic path on operands the TMA cannot describe;
3. serves a seeded Poisson trace through qwen2-0.5b at full width
   (random weights from a seed) with the continuous-batching engine on
   the cuda backend — PREFILL through sr_matmul's sm90 path, fused
   DECODE through fused_attn_unit — counting each kernel's launches in
   that run (the generic path's must stay 0), and serves the same trace
   again with the per-op decode words; then teacher-forces fused and
   per-op decode on one token stream and holds both against an f32
   truth;
4. the same for rwkv6-1.6b at full width: sr_matmul at its PREFILL
   shapes (the r, k, v, g quarters as column views of the fused table),
   wkv6 (a PREFILL chunk and a DECODE step from a carried state, a
   ragged chunk, 257 tokens, near-total decay; each with bf16 r, k, v
   as served and with f32 ones; two calls bit-equal; cold in L2 in a
   CUDA graph) and fused_ffn (timed and checked as
   fused_attn_unit is) against their plain
   versions; the trace served fused (PREFILL through sr_matmul, the
   recurrence through wkv6, each layer's FF half through fused_ffn) and
   per-op; the teacher-forced comparison; and, layer by layer, fused_ffn
   and the per-op FF against the f32 FF on the same input;
5. serves granite-moe-1b-a400m at full width (24 layers, 32 experts,
   top-8): sr_matmul's batched mode — each expert table's PREFILL
   product over all 32 experts in one launch — at layer 0's three tables
   and C = 8, 32, 40 rows an expert against its plain version (two calls
   bit-equal; at C = 32 event, CUDA-graph, plain and torch.bmm times
   beside the bound), fused_attn_unit without its FF (five launches a
   call) at granite's widths, the trace served fused and per-op with the
   batched launches counted (the generic path's must stay 0), and one
   chunk on the cuda backend beside the reference backend; then the
   trace through olmo-1b and minitron-4b at full width on the dense
   path, each with its chunk beside the reference backend;
   jamba-v0.1-52b at full width and one period of its layer pattern (8
   of 32 layers: attention with a 4096 window at unit 0, Mamba at 1-7,
   a MoE FF of 16 experts top-2 on every second unit; all 32 layers do
   not fit the card; its parameters from a generator of their own):
   sr_matmul at every 2-D PREFILL shape of a chunk (layer 0's attention
   and FF, layer 1's Mamba projections with mamba_dt reading rows of 256
   at a row stride of 288, the head) and the batched form at unit 1's
   expert tables (C 8 and 32, and a routed chunk), each against the
   plain version and timed beside its bound;
   selective_scan (Mamba's recurrence, a kernel that
   replaces no TPU kernel) against its plain version at di 8192, N 16,
   bf16 and f32 x, one slot's 1, 7, 32 and 512 tokens, a 32-slot
   DECODE step and jamba training's forward (4 x 256), from a nonzero
   state, timed beside its bound, with selective_scan_plan's layout;
   fused_attn_unit at unit 0 with its dense FF and fused_ffn at unit 2;
   the trace served fused and per-op with every kernel of the path
   counted (selective_scan, sr_matmul on the sm90 path and batched,
   fused_attn_unit, fused_ffn; the generic path's 0) and the peak
   memory; a chunk and 8 decode steps on the cuda backend against the
   reference backend with routing held; the served ring (window 64, 4
   requests of 96-200 prompt tokens) fused, per-op and on the reference
   backend, and the same comparison over a 150-token prompt; the
   reduced arctic-480b's chunk (a MoE FF with the dense FF beside it)
   against the reference backend at four seeds of its own, and a control
   with the dense FF left out that must read above the gate;
   speculative serving (k = 4, the default one-layer draft with its own
   seed) of the same trace at 8 layers, each beside the same trace
   without speculation at 8 layers, through qwen2-0.5b (fused and
   per-op), rwkv6-1.6b and granite-moe-1b-a400m (fused): verify chunks of k rows
   and replays of 1 to k rows through sr_matmul, wkv6 and
   sr_matmul_batched, counted by chunk kind and rows; the verify held to
   leave the arena bit-identical, every first token equal to the
   non-speculative run's at the same depth; a self-draft of qwen2 at
   full width; the three
   models at 4 layers on the reference backend, speculative ==
   non-speculative bit for bit; and a burst of 64 requests on 32 slots
   with eviction (qwen2 at full width): without speculation at 24 and
   at 8 layers, with it at 8; sr_matmul at 1 to k rows of every qwen2
   and rwkv6 PREFILL product and wkv6 at 1 to k tokens of one slot,
   each against its plain version;
6. trains: four full-width layers under ``fp32`` for two steps on the
   cuda backend against the reference backend (TF32 off); all 24 layers
   under ``fp32`` (adamw, remat block, B=4, S=256) for 3 steps through
   ``launch.train``, every product on the f32 path (sgemm_sm90.cuh);
   then all 24 layers under ``paper_sr_bf16`` for 8 steps — FF / BP
   through sr_matmul, UP through outer_accum, the optimizer's SR
   writeback through sr_round — counting each kernel's launches per
   step (every bf16 product on the sm90 path, none on the generic one);
7. trains the paper's own networks at full width on the cuda backend
   (``runtime/paper_step.py``): AlexNet at 227^2 (B=128), VGG-16 at
   224^2 (B=32), MLP0 (B=256), GRU0 (T=64, B=32) and the captioning
   CNN -> GRU (T=100, B=8), 4 SGD steps each — FC, MLP and GRU products
   through sr_matmul and outer_accum (bf16 on the sm90 path, the GRUs'
   f32 on the f32 path), counted per step and by shape — after holding
   each net's step-0 gradients on the cuda backend against the reference
   backend; holds each product shape of those steps against its plain
   version and times it in a CUDA graph beside its bound and
   torch.matmul; runs conv_up_as_matmul (Fig 6: one f32 outer_accum word
   a conv tap) at AlexNet's five convs and VGG-16's first at full
   resolution against autograd's conv dW; prints each net's step time,
   throughput, TFLOP/s and peak memory, and Fig 16's std/mean of
   TFLOP/s across the five;
8. trains rwkv6-1.6b: holds wkv6_bwd (the recurrence's gradient,
   ``csrc/wkv6_bwd.cu``) against its plain version at the training shape
   (B=4, S=256, 32 heads of 64, bf16 r, k, v), at head_dim 16 and 32, at
   S = 1, 5, 9 and 33, at B=3 with 7 heads and under near-total decay,
   two calls bit-equal, and times it; four full-width layers under
   ``fp32``, step-0 loss and every gradient leaf on the cuda backend
   against the reference backend; then all 24 layers under
   ``paper_sr_bf16`` for 8 steps through ``launch.train`` — FF / BP / UP
   through sr_matmul and outer_accum, the recurrence through wkv6 and
   wkv6_bwd, the writeback through sr_round — counting each kernel's
   launches per step;
9. trains granite-moe-1b-a400m: outer_accum's batched mode (a MoE
   table's UP over all 32 experts in one launch, each expert's SR bits
   at its own offset) at layer 0's three tables and C = 8, 40, 2560 and
   1024 rows an expert against its plain version (SR bit-equal to the plain
   cast of its own f32 result, two calls bit-equal; at C = 1024 event,
   CUDA-graph warm and cold in L2, plain, torch.bmm and bound times),
   and sr_matmul's batched mode at the same tables' FF and BP (trans_b)
   at C = 1024; four full-width layers under ``paper_sr_bf16``, step-0
   loss and every gradient leaf on the cuda backend against the
   reference backend with the expert selection held, then the same
   step-0 gradients under remat none and remat block, bit-equal; the
   same two checks on two layers at B=2, S=4096, whose 8192 tokens take
   the MoE's capacity branch (C = 2560 rows an expert) rather than the
   dropless one; then all 24 layers for 8 steps through ``launch.train``
   (adamw, remat block, B=4, S=256) — each expert table's FF, remat FF
   and BP one sr_matmul_batched launch each, its UP one
   outer_accum_batched launch — holding the launches of each step to
   exact counts and the run's peak memory to a gate; then the peak
   memory of that step's forward and backward apart from its adamw
   update's (gated), and the same split for rwkv6-1.6b;
10. trains granite-moe-1b-a400m under ``fp32``: the f32 batched mode
   of sr_matmul (FF, BP) and outer_accum (UP, with a scale) at layer
   0's three tables and C = 8, 40 and 1024 rows an expert against the
   plain versions (two calls bit-equal, split-K plans included; at
   C = 1024 event, CUDA-graph, plain and torch.bmm times beside the
   bound); four full-width layers, step-0 loss and every gradient leaf
   on the cuda backend against the reference backend with the expert
   selection held; then all 24 layers for 3 steps through
   ``launch.train`` — every expert table's FF, remat FF and BP one f32
   sr_matmul_batched launch each, its UP one f32 outer_accum_batched
   launch — holding each step's launches to exact counts;
11. trains jamba-v0.1-52b, cut to one card by ``launch.train``'s
   ``one_card_train_config`` (one period, 8 of 32 layers, at full width
   with 4 of its 16 experts, top-2: 4.84 B parameters): holds
   selective_scan_bwd (the scan's gradient, ``csrc/selective_scan_bwd.cu``)
   against its plain version at jamba training's shape (B=4, S=256, di
   8192, N 16) in bf16 and f32 x, at the step-0 check's 2 x 64, at S = 1
   and 5, under decay so strong that exp(dt A) is 0 and at ragged widths
   with N 4 and 8, two calls bit-equal, and times it; step-0 loss and
   every gradient leaf of the cut (B=2, S=64, paper_sr_bf16 and fp32,
   weights from three seeds) on the cuda backend against the reference
   backend, the expert selection held; 8 steps through ``launch.train`` (adamw, remat block, B=4,
   S=256, no checkpoint) — FF / BP / UP through sr_matmul, its batched
   mode and outer_accum, the scan through selective_scan (twice a Mamba
   layer) and selective_scan_bwd (once), the writeback through sr_round
   — holding each step's launches to exact counts; then the peak memory
   of a step's forward and backward apart from its adamw update's.

It prints the time targets of the sm90 redesign, of the fused decode
words' redesign, of the f32 mainloop's, of wkv6's and of wkv6_bwd's (met
or missed; a miss is reported, not failed), a ``{"kernels": [...]}``
line, the card's name and power limit, and as its last line ``{"ok":
true, "device": {...}}``.  Any failed check exits nonzero.  Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.monotonic()

# sr_matmul f32 path, from tests/test_kernels.py: the blocked f32
# accumulation runs in another order than the plain product — a few ulp
# of the sum of |terms|, hence the relative part plus a small absolute.
MM_RTOL, MM_ATOL = 5e-4, 1e-4
# SR path: one ulp of f32 order difference can move the SR-rounded bf16
# result by one bf16 step (2^-8 relative) on a few elements.
SR_RTOL = 1.2e-2
# fused_attn_unit, from tests/test_decode_fused.py:155-164: bf16 outputs
# of f32-accumulated products in another order (2e-2), and cache entries
# that are single bf16 dot products of near-cancelling terms (6e-2).
Y_TOL, CACHE_TOL = 2e-2, 6e-2
# outer_accum's f32 result takes sr_matmul's bound (another order of the
# same f32 sums, operands scaled so results are O(1)); its SR result and
# sr_round are held bit for bit.
# The fp32 training comparison, cuda against reference backend: one step
# of f32 arithmetic in another order (1e-4), then the second step's loss
# after an adamw update that amplifies it (1e-3).  The step-0 gradients,
# which the loss barely sees, are held leaf by leaf: the largest
# difference within 1e-4 of the leaf's largest value (the fp32 bound of
# tests/test_torch_training.py), and the gradient norm within 1e-5.
TRAIN_RTOL = (1e-4, 1e-3)
GRAD_REL, GNORM_RTOL = 1e-4, 1e-5
# training runs: batch 4 x 256 tokens (T = 1024 rows per weight op)
TRAIN_B, TRAIN_S = 4, 256


# the served engine's arena: rows (slots) and positions a row; the fused
# decode phases check fused_attn_unit at these shapes
SERVE_SLOTS, SERVE_LEN = 32, 528
# the speculation window: a verify chunk's rows, and the most rows of a
# replay; sr_matmul and wkv6 are checked at 1..SPEC_K rows / tokens
SPEC_K = 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# H100 variants by marketing name: (bytes/s of device memory, dense bf16
# tensor-core flop/s, f32 flop/s outside the tensor cores) from NVIDIA's
# data sheets.
_PEAKS = (("NVL", 3.9e12, 835e12, 60e12), ("PCIe", 2.0e12, 756e12, 51e12),
          ("H100", 3.35e12, 989e12, 67e12))


def card_peaks(name: str) -> tuple:
    for key, bw, flops, f32 in _PEAKS:
        if key in name:
            return bw, flops, f32
    return 3.35e12, 989e12, 67e12


def bound(nbytes: float, flops: float, peaks: tuple,
          f32: bool = False) -> tuple:
    """(least ms, what bounds it): bytes over the memory rate against
    flops over the bf16 tensor-core peak (or the f32 peak)."""
    tb = nbytes / peaks[0] * 1e3
    tf = flops / (peaks[2] if f32 else peaks[1]) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so the host's time per call drops out (time_ms measures
    back-to-back calls, which a short kernel's host time can bound)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def errs(got, want) -> tuple:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), float((d / w.abs().clamp_min(1e-6)).max())


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill bytes stored, spill bytes loaded) per
    entry function of an -Xptxas -v log; gemm_sm90.cuh's mainloop is
    named by its template arguments <BN, A_MN, B_MN>, gemm_sm90_batched.cuh's
    by <BN, A_MN, B_MN, OUT> (OUT 0 f32, 1 bf16, 2 SR), sgemm_sm90.cuh's
    and sgemm_sm90_batched.cuh's by <A_MN, B_MN>, wkv6.cu's by <hd,
    columns a block, columns a thread, bf16 r/k/v>, wkv6_bwd.cu's by
    <hd, bf16 r/k/v>, selective_scan.cu's by <N, bf16 x, a thread's
    share of a tile, several tiles>, selective_scan_bwd.cu's by <N,
    bf16 x>."""
    import re
    rows, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            cur = m.group(1)
            g = re.search(r"gemm_kernelILi(\d+)ELb(\d)ELb(\d)E", cur)
            if g:
                cur = f"gemm_kernel<{','.join(g.groups())}>"
            g = re.search(r"batched_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d)E",
                          cur)
            if g:
                cur = f"batched_kernel<{','.join(g.groups())}>"
            g = re.search(r"sgemm_(batched_)?kernelILb(\d)ELb(\d)E", cur)
            if g:
                cur = (f"sgemm_{g.group(1) or ''}kernel<"
                       f"{','.join(g.groups()[1:])}>")
            g = re.search(r"wkv6_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E",
                          cur)
            if g:
                cur = f"wkv6_kernel<{','.join(g.groups())}>"
            g = re.search(r"wkv6_bwd_kernelILi(\d+)ELb(\d)E", cur)
            if g:
                cur = f"wkv6_bwd_kernel<{','.join(g.groups())}>"
            g = re.search(r"selective_scan_kernelILi(\d+)ELb(\d)ELi(\d+)"
                          r"ELb(\d)E", cur)
            if g:
                cur = f"selective_scan_kernel<{','.join(g.groups())}>"
            g = re.search(r"selective_scan_bwd_kernelILi(\d+)ELb(\d)E", cur)
            if g:
                cur = f"selective_scan_bwd_kernel<{','.join(g.groups())}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            rows.append((cur, int(m.group(1)), *spill))
            spill = (0, 0)
    return rows


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    secs = build.build()
    print(f"[build] {len(secs)} libraries in {time.monotonic() - t0:.1f}s "
          f"({', '.join(f'{n} {s:.1f}s' for n, s in secs.items())})")
    for n in build.SOURCES:
        log = build.BUILD_DIR / f"{n}.log"
        if log.exists():
            for kern, regs, st, ld in ptxas_report(log.read_text()):
                print(f"[build] {n}: {kern}: {regs} registers, spill "
                      f"stores {st} B, spill loads {ld} B")


def qwen2_prefill_shapes(params) -> list:
    """(name, W, trans_b) of qwen2-0.5b's PREFILL products: one layer's
    four and the tied LM head (the embedding table, read transposed)."""
    g0 = {k: v[0] for k, v in params["groups"]["u0"]["attn"].items()}
    f0 = {k: v[0] for k, v in params["groups"]["u0"]["ffn"].items()}
    return [("attn_qkv", g0["qkv"], False), ("attn_o", g0["o"], False),
            ("ffn_in", f0["ffn_in"], False), ("ffn_out", f0["ffn_out"], False),
            ("lm_head", params["embed"]["table"], True)]


def rwkv6_prefill_shapes(cfg, params) -> list:
    """rwkv6-1.6b's PREFILL products: the four quarters of the fused r, k,
    v, g table (column views, read in place as on the main path), decay,
    output, the FF pair and the untied LM head."""
    d = cfg.d_model
    r0 = {k: v[0] for k, v in params["groups"]["u0"]["rwkv"].items()}
    f0 = {k: v[0] for k, v in params["groups"]["u0"]["ffn"].items()}
    quarters = [(f"rkvg[{i}]", r0["rkvg"][:, i * d:(i + 1) * d], False)
                for i in range(4)]
    return quarters + [("decay", r0["decay"], False), ("rwkv_o", r0["o"], False),
                       ("ffn_in", f0["ffn_in"], False),
                       ("ffn_out", f0["ffn_out"], False),
                       ("lm_head", params["lm_head"], False)]


def jamba_prefill_shapes(cfg, params) -> list:
    """jamba-v0.1-52b's PREFILL products: layer 0's attention and dense
    FF, layer 1's Mamba mixer (mamba_dt reads its A operand as the main
    path does: the first dt_rank columns of the (dt, B, C) projection, a
    view of rows of dt_rank at a row stride of dt_rank + 2 d_state) and
    the untied LM head.  The MoE tables' products are
    phase_sr_matmul_experts'."""
    a0 = _layer0(params["groups"]["u0"]["attn"])
    f0 = _layer0(params["groups"]["u0"]["ffn"])
    m1 = _layer0(params["groups"]["u1"]["mamba"])
    proj = m1["xproj"].shape[1]
    return [("attn_qkv", a0["qkv"], False), ("attn_o", a0["o"], False),
            ("ffn_in", f0["ffn_in"], False), ("ffn_out", f0["ffn_out"], False),
            ("mamba_in", m1["in"], False), ("mamba_xproj", m1["xproj"], False),
            ("mamba_dt", m1["dt"], False, proj),
            ("mamba_out", m1["out"], False),
            ("lm_head", params["lm_head"], False)]


def plan_txt(p) -> str:
    return f"plan ({p.path}, bm {p.bm}, bn {p.bn}, splits {p.splits})"


def path_counts(counter_map: dict) -> dict:
    return {k: c.n for k, c in counter_map.items()}


def phase_sr_matmul(label: str, arch: str, shapes: list, peaks, *,
                    ragged: bool = False,
                    products: str = "one layer's products") -> dict:
    """sr_matmul at every PREFILL shape of a 32-token chunk of `arch`
    ((name, B, trans_b) or (name, B, trans_b, A's row stride): A is then
    a view of the first K columns of wider rows, as the main path passes
    it): the sm90 path against the plain version, the SR epilogue bit-equal to the
    plain SR cast of the kernel's own product, rows 0..4 of the chunk
    bit-equal to a 5-row call of the same rows, and calls of 1..SPEC_K
    rows (the speculative verify and replay chunks) held against the
    plain version and bit-equal to their rows of the chunk; then the host's share of
    a call (the TMA maps, encoded alone) and, with `ragged`, the generic
    path on operands the TMA cannot describe."""
    import torch
    from repro_torch.core.rounding import sr_cast_bf16
    from repro_torch.kernels import sr_matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(1)
    M = 32
    worst_abs = worst_rel = 0.0
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "dev": 0.0,
           "lib_dev": 0.0}
    by_ms = {"bytes": 0.0, "operations": 0.0}
    plans = {}
    for name, w, tb, *lda in shapes:
        K = w.shape[1] if tb else w.shape[0]
        N = w.shape[0] if tb else w.shape[1]
        rows = torch.randn((M, lda[0] if lda else K), generator=gen,
                           device="cuda").to(torch.bfloat16)
        # the first m rows in a buffer of their own, at A's row stride
        first = lambda m: rows[:m].clone()[:, :K]  # noqa: E731
        a = rows[:, :K]
        p = kmm.operands_plan(a, w, tb)
        plans[name] = p
        check(p.path == "sm90", f"sr_matmul {name}: {plan_txt(p)}, want sm90")
        before = path_counts(kmm.PATH_COUNTERS)
        got = kmm.sr_matmul(a, w, trans_b=tb)
        after = path_counts(kmm.PATH_COUNTERS)
        check(after["sm90"] == before["sm90"] + 1
              and after["generic"] == before["generic"],
              f"sr_matmul {name} did not launch the sm90 path once")
        want = kmm.sr_matmul_plain(a, w, trans_b=tb)
        torch.cuda.synchronize()
        ea, er = errs(got, want)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"sr_matmul {name} ({M}x{K}x{N}, trans_b={tb}) f32 path: "
              f"max abs err {ea:.3g}")
        rows5 = kmm.sr_matmul(first(5), w, trans_b=tb)
        check(torch.equal(rows5, got[:5]),
              f"sr_matmul {name}: rows 0..4 of the 32-row call differ from "
              f"a 5-row call of the same rows")
        # the speculative chunks' rows: a verify of SPEC_K rows and
        # replays of 1..SPEC_K, each on the sm90 path, against the plain
        # version and bit-equal to the same rows of the 32-row call
        for m in range(1, SPEC_K + 1):
            am = first(m)
            pm = kmm.operands_plan(am, w, tb)
            check(pm.path == "sm90", f"sr_matmul {name} M={m}: "
                  f"{plan_txt(pm)}, want sm90")
            got_m = kmm.sr_matmul(am, w, trans_b=tb)
            want_m = kmm.sr_matmul_plain(am, w, trans_b=tb)
            check(torch.allclose(got_m, want_m, rtol=MM_RTOL, atol=MM_ATOL),
                  f"sr_matmul {name} ({m}x{K}x{N}, trans_b={tb}): max abs "
                  f"err {errs(got_m, want_m)[0]:.3g}")
            check(torch.equal(got_m, got[:m]),
                  f"sr_matmul {name}: an {m}-row call differs from rows "
                  f"0..{m - 1} of the 32-row call")
            ea = max(ea, errs(got_m, want_m)[0])
        rb = torch.randint(-2**31, 2**31, (M, N), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        got_sr = kmm.sr_matmul(a, w, rb, trans_b=tb)
        check(torch.equal(got_sr.view(torch.int16),
                          sr_cast_bf16(got, rb).view(torch.int16)),
              f"sr_matmul {name}: SR epilogue is not bit-equal to the plain "
              f"SR cast of the kernel's own f32 product")
        want_sr = kmm.sr_matmul_plain(a, w, rb, trans_b=tb)
        check(torch.allclose(got_sr.float(), want_sr.float(), rtol=SR_RTOL,
                             atol=MM_ATOL),
              f"sr_matmul {name}: SR product outside rtol {SR_RTOL}")
        worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
        ms = time_ms(lambda: kmm.sr_matmul(a, w, trans_b=tb))
        plain = time_ms(lambda: kmm.sr_matmul_plain(a, w, trans_b=tb))
        wt = w.t() if tb else w
        lib = time_ms(lambda: torch.matmul(a, wt))
        dev = time_graph_ms(lambda: kmm.sr_matmul(a, w, trans_b=tb))
        lib_dev = time_graph_ms(lambda: torch.matmul(a, wt))
        b_ms, by = bound(2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K,
                         peaks)
        by_ms[by] += b_ms
        print(f"[{label}] {name:<8} M={M} K={K} N={N} trans_b={int(tb)} "
              f"lda={kmm.row_stride(a)} "
              f"{plan_txt(p)}: kernel {ms:.4f}ms plain {plain:.4f}ms "
              f"torch.matmul {lib:.4f}ms bound {b_ms:.4f}ms; in a CUDA "
              f"graph: kernel {dev:.4f}ms torch.matmul {lib_dev:.4f}ms  "
              f"max_abs_err {ea:.3g}  rows 0..4 = 5-row call; M=1..{SPEC_K} "
              f"calls held against the plain version and = their rows")
        tot["ms"] += ms
        tot["plain"] += plain
        tot["lib"] += lib
        tot["bound"] += b_ms
        tot["dev"] += dev
        tot["lib_dev"] += lib_dev
    # the host's share of one call, on the host clock, at the first
    # shape: the cached plan lookup, the stream query, a ctypes call that
    # only encodes the sm90 path's two TMA maps, and the whole call
    from repro_torch.kernels import build
    name, w, tb = shapes[0][:3]
    K = w.shape[1] if tb else w.shape[0]
    N = w.shape[0] if tb else w.shape[1]
    a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    lda, ldb = kmm.row_stride(a), kmm.row_stride(w)
    p = kmm.launch_geometry(M, N, K, "k", "k" if tb else "n", lda, ldb,
                            kmm.aligned16(a, w))[0]
    maps = build.load("sr_matmul").sr_matmul_sm90_maps
    check(maps(build.ptr(a), build.ptr(w), M, N, K, lda, ldb, int(tb),
               p.bn) == 0, f"sr_matmul {name}: the TMA maps were refused")
    host = {}
    for what, f in (
            ("plan", lambda: kmm.launch_geometry(
                M, N, K, "k", "k" if tb else "n", lda, ldb,
                kmm.aligned16(a, w))),
            ("stream", lambda: build.stream_ptr(a.device)),
            ("maps", lambda: maps(build.ptr(a), build.ptr(w), M, N, K, lda,
                                  ldb, int(tb), p.bn)),
            ("call", lambda: kmm.sr_matmul(a, w, trans_b=tb))):
        for _ in range(20):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        host[what] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    print(f"[{label}] host time per call at {name} (ms): plan lookup "
          f"{host['plan']:.4f}, stream query {host['stream']:.4f}, a ctypes "
          f"call encoding the two TMA maps {host['maps']:.4f}, whole call "
          f"{host['call']:.4f}")
    # ragged edges of M, N and K on both layouts (masking, no overreads);
    # B's 666-byte rows (trans_b=0) take the generic path
    for tb in ((False, True) if ragged else ()):
        a = torch.randn((37, 1000), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((333, 1000) if tb else (1000, 333), generator=gen,
                        device="cuda").to(torch.bfloat16)
        p = kmm.operands_plan(a, w, tb)
        check(p.path == ("sm90" if tb else "generic"),
              f"sr_matmul ragged trans_b={tb}: {plan_txt(p)}")
        before = path_counts(kmm.PATH_COUNTERS)
        got = kmm.sr_matmul(a, w, trans_b=tb)
        after = path_counts(kmm.PATH_COUNTERS)
        check(after[p.path] == before[p.path] + 1,
              f"sr_matmul ragged trans_b={tb}: {p.path} counter did not move")
        want = kmm.sr_matmul_plain(a, w, trans_b=tb)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"sr_matmul ragged 37x1000x333 trans_b={tb} ({p.path}): max "
              f"abs err {errs(got, want)[0]:.3g}")
        print(f"[{label}] ragged 37x1000x333 trans_b={int(tb)} {plan_txt(p)}"
              f": max_abs_err {errs(got, want)[0]:.3g}")
    print(f"[{label}] one PREFILL chunk's {len(shapes)} products: kernel "
          f"{tot['ms']:.4f}ms plain {tot['plain']:.4f}ms torch.matmul "
          f"{tot['lib']:.4f}ms bound {tot['bound']:.4f}ms; in a CUDA graph: "
          f"kernel {tot['dev']:.4f}ms torch.matmul {tot['lib_dev']:.4f}ms")
    return {"name": label, "route": "cuda",
            "source": "src/repro_torch/csrc/gemm_sm90.cuh",
            "entry": "src/repro_torch/csrc/sr_matmul.cu",
            "replaces": "src/repro/kernels/sr_matmul.py:96",
            "tpu_kernel": "repro/kernels/sr_matmul.py::sr_matmul",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain"],
            "library_ms": tot["lib"], "bound_ms": tot["bound"],
            "bound_by": max(by_ms, key=by_ms.get),
            "graph_ms": tot["dev"], "library_graph_ms": tot["lib_dev"],
            "host_ms": host,
            "plans": {n: list(p) for n, p in plans.items()},
            "shapes": f"{arch}, one 32-token PREFILL chunk: "
                      f"{', '.join(sh[0] for sh in shapes)} ({products} "
                      f"+ the LM head)"}


# fused_attn_unit_bf16 / fused_ffn_bf16 argument positions of y and the
# workspace (csrc/decode_fused.cu), for timing the ctypes call alone
_DECODE_Y_WS = {"fused_attn_unit_bf16": (16, 17), "fused_ffn_bf16": (5, 6)}


def decode_host_ms(call, entry: str, ws_bytes: int, y_shape) -> dict:
    """Host time of one fused word call on the host clock (no
    synchronisation; 200 calls after 20): the whole wrapper, and its
    ctypes call alone with the same arguments (a workspace and y of its
    own), so the wrapper's Python is their difference."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_fused as kdf
    real = kdf._entry(build.load("decode_fused"), entry)
    seen = {}

    def spy(*a):
        seen["args"] = list(a)
        return real(*a)
    orig = kdf._entry
    kdf._entry = lambda lib, name: spy if name == entry else orig(lib, name)
    try:
        call()
    finally:
        kdf._entry = orig
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device="cuda")
    y = torch.empty(y_shape, dtype=torch.bfloat16, device="cuda")
    args = seen["args"]
    iy, iws = _DECODE_Y_WS[entry]
    args[iy], args[iws] = build.ptr(y), build.ptr(ws)
    host = {}
    for what, f in (("call", call), ("ctypes", lambda: real(*args))):
        for _ in range(20):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        host[what] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    host["wrapper"] = host["call"] - host["ctypes"]
    return host


def _launch_txt(parts: dict) -> str:
    return ", ".join(f"{k} {ms:.4f}ms x{n:g}" for k, (ms, n) in parts.items())


def _traced_parts(plan) -> dict:
    """The launches of one call of a decode word by kind, as bench_decode
    names them, from its plan: one norm (norm1, or fused_ffn's norm2),
    then QKV, attention, o and the residual + norm2 pass where there is
    attention, then each FF product."""
    parts = {"norm": 1}
    if plan.attn_nsplit:
        parts.update(qkv=1, attention=1, o=1, o_sum_norm2=1)
    parts.update({n: 1 for n in ("ffn_in", "ffn_out") if n in plan.products})
    check(sum(parts.values()) == plan.launches,
          f"decode plan of {plan.launches} launches, kinds {parts}")
    return parts


def phase_decode_launches(rows: dict) -> None:
    """Each launch's share of the fused words' device time, and the
    launches of each kind per call that the device ran, from a traced
    CUDA-graph replay in a process of its own (launch/bench_decode.py at
    the same shapes: one qwen2-0.5b layer, one rwkv6-1.6b FF), so that no
    torch.profiler runs in this process and the serving phases' host time
    is not inflated by it.  The traced kinds and counts must be the
    plan's.  Beside them, bench_decode's times of the same weight
    products through sr_matmul's sm90 path."""
    from repro_torch.kernels import decode_fused as kdf
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench_decode"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    check(proc.returncode == 0,
          f"bench_decode failed ({proc.returncode}): {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])["words"]
    plans = {"fused_attn_unit": kdf.decode_plan(
                 32, 896, f=4864, gated=True, heads=14, kv_heads=2,
                 head_dim=64, S=528),
             "fused_ffn": kdf.decode_plan(32, 2048, f=7168, gated=False,
                                          attention=False)}
    for word, plan in plans.items():
        parts = res[word]["parts"]
        traced = {k: round(n, 6) for k, (_, n) in parts.items()}
        want = _traced_parts(plan)
        check(traced == want,
              f"{word}: the traced replay ran {traced} launches a call, "
              f"the plan {want}")
        sm90 = res[word]["sm90_products_ms"]
        print(f"[{word}] per launch, in a traced CUDA-graph replay (device "
              f"ms by which each extends the timeline, per call; launches "
              f"per call): {_launch_txt(parts)}; graph "
              f"{res[word]['graph_ms']:.4f}ms (bench_decode's weights); "
              f"{sum(traced.values()):g} launches a call traced, as "
              f"planned")
        print(f"[{word}] its weight products {res[word]['products_ms']:.4f}"
              f"ms; the same products through sr_matmul's sm90 path "
              f"(gemm_sm90.cuh, 32-row A box, f32 out, no decode epilogue) "
              f"one after another in a CUDA graph {sm90:.4f}ms")
        rows[word]["per_launch_ms"] = {k: v[0] for k, v in parts.items()}
        rows[word]["traced_launches_per_call"] = sum(traced.values())
        rows[word]["products_ms"] = res[word]["products_ms"]
        rows[word]["sm90_products_ms"] = sm90


def check_deterministic(call, rows5, label: str) -> None:
    """Two calls on the same inputs give the same bits, and rows 0..4 of
    the B-row call equal a 5-row call of the same rows.  `call()` and
    `rows5()` each return a list of tensors (y first)."""
    import torch
    a, b, c = call(), call(), rows5()
    check(all(torch.equal(u, v) for u, v in zip(a, b)),
          f"{label}: two calls on the same inputs differ")
    check(all(torch.equal(u[:5], v) for u, v in zip(a, c)),
          f"{label}: rows 0..4 differ from a 5-row call of the same rows")


def _fused_case(B, S, d, H, K, hd, f, gen, w=None):
    """Synthetic decode inputs: caches half filled per row (random fill,
    -1 past it), weights scaled by fan-in^-0.5 unless given."""
    import torch
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    qn = (H + 2 * K) * hd
    if w is None:
        w = dict(qkv_w=(rnd(d, qn) * d ** -0.5).bfloat16(),
                 qkv_bias=0.1 * rnd(qn),
                 o_w=(rnd(H * hd, d) * (H * hd) ** -0.5).bfloat16(),
                 w_in=(rnd(d, 2 * f) * d ** -0.5).bfloat16(),
                 w_out=(rnd(f, d) * f ** -0.5).bfloat16(),
                 norm1_scale=1 + 0.1 * rnd(d), norm2_scale=1 + 0.1 * rnd(d))
    ck = (rnd(B, S, K, hd) * 2).to(torch.bfloat16)
    cv = rnd(B, S, K, hd).to(torch.bfloat16)
    fill = torch.randint(0, S - 3, (B,), generator=gen, device="cuda")
    sidx = torch.arange(S, device="cuda")[None]
    cpos = torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32)
    return w, [ck, cv, cpos], fill


def _check_fused_steps(w, cache, fill, kw, active, gen, label: str,
                       steps: int = 3) -> tuple:
    """`steps` decode steps of fused_attn_unit against its plain version
    on copies of the same caches; returns (max abs err, max rel err)."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels.decode_fused import _vec
    B, d = cache[0].shape[0], w["o_w"].shape[1]
    with_ffn = "w_out" in w
    f = w["w_out"].shape[0] if with_ffn else 0
    qn = w["qkv_w"].shape[1]
    kern = [c.clone() for c in cache]
    plain = [c.clone() for c in cache]
    pkw = dict(n1s=_vec(w.get("norm1_scale"), d, 1.0, "cuda"),
               n1b=_vec(w.get("norm1_bias"), d, 0.0, "cuda"),
               qkv_w=w["qkv_w"],
               qkv_b=_vec(w.get("qkv_bias"), qn, 0.0, "cuda"), o_w=w["o_w"],
               n2s=_vec(w.get("norm2_scale"), d, 1.0, "cuda"),
               n2b=_vec(w.get("norm2_bias"), d, 0.0, "cuda"),
               w_in=w.get("w_in"), w_out=w.get("w_out"), window=None,
               tn=kdf._clip_block_n(256, f) if with_ffn else 1,
               with_ffn=with_ffn, active=active)
    pkw.update((k, v) for k, v in kw.items() if k != "with_ffn")
    worst_abs = worst_rel = 0.0
    for t in range(steps):
        x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
        pos = (fill + t).to(torch.int32)
        y = kdf.fused_attn_unit(x, *kern, pos, active=active, **w, **kw)
        yp = kdf.fused_attn_unit_plain(x, *plain, pos, **pkw)
        torch.cuda.synchronize()
        ea, er = errs(y, yp)
        worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
        check(torch.allclose(y.float(), yp.float(), atol=Y_TOL, rtol=Y_TOL),
              f"{label} step {t}: y max abs err {ea:.3g}")
        for got, want in zip(kern[:2], plain[:2]):
            check(torch.allclose(got.float(), want.float(), atol=CACHE_TOL,
                                 rtol=CACHE_TOL),
                  f"{label} step {t}: cache max abs err "
                  f"{errs(got, want)[0]:.3g}")
        check(torch.equal(kern[2], plain[2]), f"{label}: cache pos differ")
    for got, orig in zip(kern, cache):
        check(torch.equal(got[~active], orig[~active]),
              f"{label} wrote an inactive arena row")
    return worst_abs, worst_rel


def phase_fused(cfg, params, peaks) -> dict:
    """fused_attn_unit at B=32 arena rows, S=528, over 3 decode steps, on
    qwen2-0.5b's layer 0; its times (events, CUDA graph, host, each
    launch), two calls bit-equal, rows independent of B; then a
    full-width hd-128 case at olmo-1b's shapes."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    a = cfg.attention
    B, S, d, f = 32, 528, cfg.d_model, cfg.d_ff
    H, K, hd = a.n_heads, a.n_kv_heads, a.head_dim
    u = params["groups"]["u0"]
    w = dict(qkv_w=u["attn"]["qkv"][0], qkv_bias=u["attn"]["qkv_bias"][0],
             o_w=u["attn"]["o"][0], w_in=u["ffn"]["ffn_in"][0],
             w_out=u["ffn"]["ffn_out"][0],
             norm1_scale=u["norm1"]["scale"][0],
             norm2_scale=u["norm2"]["scale"][0])
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=a.rope_theta,
              norm_kind="rmsnorm", act="swiglu")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _, cache, fill = _fused_case(B, S, d, H, K, hd, f, gen, w)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[5] = active[17] = False
    worst_abs, worst_rel = _check_fused_steps(w, cache, fill, kw, active,
                                              gen, "fused_attn_unit")
    plan = kdf.decode_plan(B, d, f=f, gated=True, heads=H, kv_heads=K,
                           head_dim=hd, S=S)
    x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = (fill + 3).to(torch.int32)
    kern = [c.clone() for c in cache]
    call = lambda: kdf.fused_attn_unit(x, *kern, pos, active=active, **w,
                                       **kw)
    c0, l0 = kdf.COUNTER.n, kdf.LAUNCHES.n
    call()
    per_call = kdf.LAUNCHES.n - l0
    check(kdf.COUNTER.n == c0 + 1 and per_call == plan.launches == 7,
          f"fused_attn_unit: {per_call} launches in a call, plan "
          f"{plan.launches}")

    def two(rows):
        c = [t[:rows].clone() for t in cache]
        y = kdf.fused_attn_unit(x[:rows].contiguous(), *c,
                                pos[:rows].contiguous(),
                                active=active[:rows].contiguous(), **w, **kw)
        return [y, *c]
    check_deterministic(lambda: two(B), lambda: two(5), "fused_attn_unit")
    ms = time_ms(call)
    dev_ms = time_graph_ms(call)
    host = decode_host_ms(call, "fused_attn_unit_bf16", plan.ws_bytes, (B, d))
    plain = [c.clone() for c in cache]
    from repro_torch.kernels.decode_fused import _vec
    qn = (H + 2 * K) * hd
    pkw = dict(n1s=_vec(w["norm1_scale"], d, 1.0, "cuda"),
               n1b=_vec(None, d, 0.0, "cuda"), qkv_w=w["qkv_w"],
               qkv_b=_vec(w["qkv_bias"], qn, 0.0, "cuda"), o_w=w["o_w"],
               n2s=_vec(w["norm2_scale"], d, 1.0, "cuda"),
               n2b=_vec(None, d, 0.0, "cuda"), w_in=w["w_in"],
               w_out=w["w_out"], window=None, tn=kdf._clip_block_n(256, f),
               with_ffn=True, active=active, **kw)
    plain_ms = time_ms(lambda: kdf.fused_attn_unit_plain(x, *plain, pos,
                                                         **pkw))
    # yardstick only: torch.matmul on the same four weight products at
    # M = 32 (the port never calls it)
    ins = [torch.randn((B, w_.shape[0]), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
           for w_ in (w["qkv_w"], w["o_w"], w["w_in"], w["w_out"])]
    mm_ms = time_graph_ms(lambda: [torch.matmul(i, w_) for i, w_ in zip(
        ins, (w["qkv_w"], w["o_w"], w["w_in"], w["w_out"]))])
    weights = 2 * (d * qn + H * hd * d + d * 2 * f + f * d) + 2 * (qn + 2 * d)
    valid = int((fill + 4).sum())                 # cached positions attended
    kv = valid * K * hd * 2 * 2 + B * S * 4
    io = 2 * 2 * B * d + B * (K * hd * 2 * 2 + 4) + 2 * B * 4 + B
    flops = 2 * B * (d * qn + H * hd * d + 2 * d * f + f * d) \
        + 4 * H * hd * valid
    b_ms, by = bound(weights + kv + io, flops, peaks)
    print(f"[fused_attn_unit] B={B} S={S}: kernel {ms:.4f}ms plain "
          f"{plain_ms:.4f}ms bound {b_ms:.4f}ms ({by}); in a CUDA graph "
          f"{dev_ms:.4f}ms (torch.matmul on the four weight products, a "
          f"yardstick: {mm_ms:.4f}ms)  max_abs_err {worst_abs:.3g}; "
          f"{per_call} launches a call; 2 calls bit-equal; rows 0..4 = "
          f"5-row call")
    print(f"[fused_attn_unit] host time per call (ms): whole call "
          f"{host['call']:.4f}, ctypes call {host['ctypes']:.4f}, wrapper "
          f"Python {host['wrapper']:.4f}")
    plans = {n: [p.tiles, p.splits] for n, p in plan.products.items()}
    print(f"[fused_attn_unit] plan (column tiles, splits): {plans}, "
          f"attention splits {plan.attn_nsplit} of {kdf.ATTN_SPLIT}, "
          f"workspace {plan.ws_bytes} bytes")
    olmo = phase_fused_hd128(peaks)
    return {"name": "fused_attn_unit", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_fused.cu",
            "replaces": "src/repro/kernels/decode_fused.py:272",
            "tpu_kernel": "repro/kernels/decode_fused.py::fused_attn_unit",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "graph_ms": dev_ms, "matmul_graph_ms": mm_ms, "host_ms": host,
            "launches_per_call": per_call, "plans": plans, "hd128": olmo,
            "shapes": f"qwen2-0.5b layer 0, B={B} rows, S={S}"}


def phase_fused_hd128(peaks) -> dict:
    """fused_attn_unit at olmo-1b's full width, head_dim 128: d 2048, 16
    heads of 128, 16 KV heads, d_ff 8192 swiglu, B=32, S=528, weights
    from a seed, against the plain version."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    B, S, d, H, K, hd, f = 32, 528, 2048, 16, 16, 128, 8192
    gen = torch.Generator(device="cuda").manual_seed(12)
    w, cache, fill = _fused_case(B, S, d, H, K, hd, f, gen)
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=1e4,
              norm_kind="rmsnorm", act="swiglu")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[3] = False
    ea, _ = _check_fused_steps(w, cache, fill, kw, active, gen,
                               "fused_attn_unit hd128", steps=2)
    x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = (fill + 2).to(torch.int32)
    kern = [c.clone() for c in cache]
    dev_ms = time_graph_ms(lambda: kdf.fused_attn_unit(
        x, *kern, pos, active=active, **w, **kw))
    qn = (H + 2 * K) * hd
    weights = 2 * (d * qn + H * hd * d + 3 * d * f)
    valid = int((fill + 3).sum())
    b_ms, by = bound(weights + valid * K * hd * 4, 2 * B * (
        d * qn + H * hd * d + 3 * d * f) + 4 * H * hd * valid, peaks)
    print(f"[fused_attn_unit:hd128] olmo-1b shapes (d {d}, {H} heads of "
          f"{hd}, {K} KV heads, d_ff {f} swiglu) B={B} S={S}: max_abs_err "
          f"{ea:.3g} within Y_TOL/CACHE_TOL; in a CUDA graph {dev_ms:.4f}ms "
          f"bound {b_ms:.4f}ms ({by})")
    del w, cache, kern
    torch.cuda.empty_cache()
    return {"max_abs_err": ea, "graph_ms": dev_ms, "bound_ms": b_ms}


def _rbits(gen, shape):
    import torch
    return torch.randint(-2**31, 2**31, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _train_ops(cfg) -> list:
    """(name, rows, P, Q, transposed) of the weight ops of one training
    step: W (P, Q) in y = x . W, or y = x . W^T for the tied head.  The
    layers run at T = B*S rows; the head runs per loss chunk (T/4 rows,
    lm_loss_chunked's four chunks at B=4, S=256)."""
    a, d, f = cfg.attention, cfg.d_model, cfg.d_ff
    T = TRAIN_B * TRAIN_S
    qkv = (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
    return [("attn_qkv", T, d, qkv, False),
            ("attn_o", T, a.n_heads * a.head_dim, d, False),
            ("ffn_in", T, d, 2 * f, False), ("ffn_out", T, f, d, False),
            ("embed(head)", T // 4, cfg.vocab_size, d, True)]


def phase_sr_matmul_train(cfg, peaks) -> dict:
    """sr_matmul in its two training roles at a step's shapes, with bf16
    and with f32 operands: FF (y = x . W; the tied head's logits x .
    table^T through trans_b) and BP (dX = dY . W^T through trans_b; the
    head's dX = g . table with K = vocab).  Split-K calls must give the
    same bits twice.  Returns the bf16 row and the f32 row (with device
    times in a CUDA graph)."""
    import torch
    from repro_torch.kernels import sr_matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst_abs = 0.0
    tot = {role: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
                  "graph": 0.0, "lib_graph": 0.0}
           for role in ("ff", "bp", "f32")}
    by_ms = {"bytes": 0.0, "operations": 0.0}
    f32_by = dict(by_ms)
    f32_abs = 0.0
    head_bp_ms = None
    for name, M, P, Q, tw in _train_ops(cfg):
        # (role, K, N, trans_b): the product (M, K) . B -> (M, N)
        roles = (("ff", Q if tw else P, P if tw else Q, tw),
                 ("bp", P if tw else Q, Q if tw else P, not tw))
        for role, K, N, tb in roles:
            for dt in (torch.bfloat16, torch.float32):
                f32 = dt == torch.float32
                a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
                b = (torch.randn((N, K) if tb else (K, N), generator=gen,
                                 device="cuda") * K ** -0.5).to(dt)
                p = kmm.operands_plan(a, b, tb)
                check(p.path == ("f32" if f32 else "sm90"),
                      f"sr_matmul {role} {name} {dt}: {plan_txt(p)}")
                got = kmm.sr_matmul(a, b, trans_b=tb)
                want = kmm.sr_matmul_plain(a, b, trans_b=tb)
                torch.cuda.synchronize()
                ea, _ = errs(got, want)
                if f32:
                    f32_abs = max(f32_abs, ea)
                else:
                    worst_abs = max(worst_abs, ea)
                check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
                      f"sr_matmul {role} {name} ({M}x{K}x{N}, trans_b={tb}, "
                      f"{dt}): max abs err {ea:.3g}")
                det = ""
                if p.splits > 1:
                    check(torch.equal(kmm.sr_matmul(a, b, trans_b=tb), got),
                          f"sr_matmul {role} {name}: two split-K calls "
                          f"differ")
                    det = "  split-K: 2 calls bit-equal"
                ms = time_ms(lambda: kmm.sr_matmul(a, b, trans_b=tb),
                             iters=10)
                plain = time_ms(lambda: kmm.sr_matmul_plain(a, b,
                                                            trans_b=tb),
                                iters=10)
                wt = b.t() if tb else b
                lib = time_ms(lambda: torch.matmul(a, wt), iters=10)
                b_ms, by = bound(a.element_size() * (M * K + K * N)
                                 + 4 * M * N, 2 * M * N * K, peaks, f32=f32)
                t = tot["f32" if f32 else role]
                t["ms"] += ms
                t["plain"] += plain
                t["lib"] += lib
                t["bound"] += b_ms
                label = f"f32:{role}" if f32 else role
                graph = ""
                if f32:
                    f32_by[by] += b_ms
                    g_ms = time_graph_ms(
                        lambda: kmm.sr_matmul(a, b, trans_b=tb), iters=5,
                        replays=3)
                    g_lib = time_graph_ms(lambda: torch.matmul(a, wt),
                                          iters=5, replays=3)
                    t["graph"] += g_ms
                    t["lib_graph"] += g_lib
                    graph = (f" (in a CUDA graph: kernel {g_ms:.4f}ms, "
                             f"torch.matmul {g_lib:.4f}ms)")
                else:
                    by_ms[by] += b_ms
                    if role == "bp" and tw:
                        head_bp_ms = ms
                print(f"[sr_matmul:{label}] {name:<11} M={M} K={K} N={N} "
                      f"trans_b={int(tb)} {plan_txt(p)}: kernel {ms:.4f}ms "
                      f"plain {plain:.4f}ms torch.matmul {lib:.4f}ms bound "
                      f"{b_ms:.4f}ms ({by}){graph}  max_abs_err "
                      f"{ea:.3g}{det}")
                del a, b, got, want
    for role in ("ff", "bp"):
        t = tot[role]
        print(f"[sr_matmul:{role}] a step's five {role.upper()} shapes (head: "
              f"one of 4 chunks): kernel {t['ms']:.4f}ms plain "
              f"{t['plain']:.4f}ms torch.matmul {t['lib']:.4f}ms bound "
              f"{t['bound']:.4f}ms")
    t = tot["f32"]
    print(f"[sr_matmul:f32] the same FF and BP shapes, f32 operands: kernel "
          f"{t['ms']:.4f}ms plain {t['plain']:.4f}ms torch.matmul (no TF32) "
          f"{t['lib']:.4f}ms bound {t['bound']:.4f}ms (f32 peak); in a CUDA "
          f"graph: kernel {t['graph']:.4f}ms, torch.matmul "
          f"{t['lib_graph']:.4f}ms")
    ff, bp = tot["ff"], tot["bp"]
    f32_row = {"name": "sr_matmul:f32", "route": "cuda",
               "source": "src/repro_torch/csrc/sgemm_sm90.cuh",
               "entry": "src/repro_torch/csrc/sr_matmul.cu",
               "replaces": "src/repro/kernels/sr_matmul.py:96",
               "tpu_kernel": "repro/kernels/sr_matmul.py::sr_matmul",
               "max_abs_err": f32_abs, "ms": t["ms"], "kernel_ms": t["ms"],
               "graph_ms": t["graph"], "plain_ms": t["plain"],
               "library_ms": t["lib"], "library_graph_ms": t["lib_graph"],
               "bound_ms": t["bound"],
               "bound_by": max(f32_by, key=f32_by.get),
               "shapes": "the same ten FF and BP products, f32 operands "
                         "(the fp32 preset)"}
    row = {"name": "sr_matmul:train", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm_sm90.cuh",
            "entry": "src/repro_torch/csrc/sr_matmul.cu",
            "replaces": "src/repro/kernels/sr_matmul.py:96",
            "tpu_kernel": "repro/kernels/sr_matmul.py::sr_matmul",
            "max_abs_err": worst_abs, "ms": ff["ms"] + bp["ms"],
            "kernel_ms": ff["ms"] + bp["ms"],
            "plain_ms": ff["plain"] + bp["plain"],
            "library_ms": ff["lib"] + bp["lib"],
            "bound_ms": ff["bound"] + bp["bound"],
            "bound_by": max(by_ms, key=by_ms.get),
            "ff_ms": ff["ms"], "bp_ms": bp["ms"], "head_bp_ms": head_bp_ms,
            "shapes": "FF and BP of one layer's four weight ops at "
                      f"T={TRAIN_B * TRAIN_S} + one tied-head loss chunk "
                      f"(T/4; BP with K=vocab), bf16 operands"}
    return [row, f32_row]


def phase_outer_accum(cfg, peaks) -> dict:
    """outer_accum at the five UP shapes of a full-width step: one
    layer's four at T = 1024 rows and one tied-head loss chunk (T/4),
    with bf16 operands (SR epilogue and f32 output) and f32 operands
    (with device times in a CUDA graph).  Returns the bf16 row and the
    f32 row."""
    import torch
    from repro_torch.core.rounding import sr_cast_bf16
    from repro_torch.kernels import outer_accum as koa
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst_abs = 0.0
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
           "f32_ms": 0.0, "f32_plain": 0.0, "f32_lib": 0.0, "f32_bound": 0.0,
           "f32_graph": 0.0, "f32_lib_graph": 0.0}
    by_ms = {"bytes": 0.0, "operations": 0.0}
    f32_by = dict(by_ms)
    f32_abs = 0.0
    for name, T, D, F, _ in _train_ops(cfg):
        # dW (D, F) = X (T, D)^T . dY (T, F); for the head X is g (T, V)
        x = torch.randn((T, D), generator=gen, device="cuda").bfloat16()
        dy = (torch.randn((T, F), generator=gen, device="cuda")
              * T ** -0.5).bfloat16()
        p = koa.up_plan(x, dy)
        check(p.path == "sm90", f"outer_accum {name}: {plan_txt(p)}, want "
              f"sm90")
        got = koa.outer_accum(x, dy)
        want = koa.outer_accum_plain(x, dy)
        torch.cuda.synchronize()
        ea, _ = errs(got, want)
        worst_abs = max(worst_abs, ea)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"outer_accum {name} (T={T}, D={D}, F={F}) f32 path: max abs "
              f"err {ea:.3g}")
        rb = _rbits(gen, (D, F))
        got_sr = koa.outer_accum(x, dy, rbits=rb)
        check(torch.equal(got_sr.view(torch.int16),
                          sr_cast_bf16(got, rb).view(torch.int16)),
              f"outer_accum {name}: SR epilogue is not bit-equal to the "
              f"plain SR cast of the kernel's own f32 product")
        del got, want
        f32_out = time_ms(lambda: koa.outer_accum(x, dy), iters=10)
        ms = time_ms(lambda: koa.outer_accum(x, dy, rbits=rb), iters=10)
        plain = time_ms(lambda: koa.outer_accum_plain(x, dy, rbits=rb),
                        iters=10)
        xt = x.t()
        lib = time_ms(lambda: torch.matmul(xt, dy), iters=10)
        b_ms, by = bound(2 * T * (D + F) + (4 + 2) * D * F, 2 * T * D * F,
                         peaks)
        by_ms[by] += b_ms
        print(f"[outer_accum] {name:<11} T={T} D={D} F={F} (SR) "
              f"{plan_txt(p)}: kernel {ms:.4f}ms (f32 out, no SR bits: "
              f"{f32_out:.4f}ms) plain {plain:.4f}ms torch.matmul "
              f"{lib:.4f}ms bound {b_ms:.4f}ms ({by})  max_abs_err {ea:.3g}")
        tot["ms"] += ms
        tot["plain"] += plain
        tot["lib"] += lib
        tot["bound"] += b_ms
        del rb, got_sr
        # the fp32 preset's f32-operand path at the same shape
        x, dy = x.float(), dy.float()
        p = koa.up_plan(x, dy)
        check(p.path == "f32", f"outer_accum {name} f32: {plan_txt(p)}")
        got = koa.outer_accum(x, dy)
        want = koa.outer_accum_plain(x, dy)
        torch.cuda.synchronize()
        ea, _ = errs(got, want)
        f32_abs = max(f32_abs, ea)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"outer_accum {name} (T={T}, D={D}, F={F}) f32 operands: max "
              f"abs err {ea:.3g}")
        det = ""
        if p.splits > 1:
            check(torch.equal(koa.outer_accum(x, dy), got),
                  f"outer_accum {name} f32: two split-K calls differ")
            det = "  split-K: 2 calls bit-equal"
        del got, want
        ms = time_ms(lambda: koa.outer_accum(x, dy), iters=10)
        plain = time_ms(lambda: koa.outer_accum_plain(x, dy), iters=10)
        xt = x.t()
        lib = time_ms(lambda: torch.matmul(xt, dy), iters=10)
        g_ms = time_graph_ms(lambda: koa.outer_accum(x, dy), iters=5,
                             replays=3)
        g_lib = time_graph_ms(lambda: torch.matmul(xt, dy), iters=5,
                              replays=3)
        b_ms, by = bound(4 * T * (D + F) + 4 * D * F, 2 * T * D * F, peaks,
                         f32=True)
        f32_by[by] += b_ms
        print(f"[outer_accum:f32] {name:<11} T={T} D={D} F={F} "
              f"{plan_txt(p)}: kernel {ms:.4f}ms plain {plain:.4f}ms "
              f"torch.matmul (no TF32) {lib:.4f}ms bound {b_ms:.4f}ms ({by}) "
              f"(in a CUDA graph: kernel {g_ms:.4f}ms, torch.matmul "
              f"{g_lib:.4f}ms)  max_abs_err {ea:.3g}{det}")
        tot["f32_ms"] += ms
        tot["f32_plain"] += plain
        tot["f32_lib"] += lib
        tot["f32_bound"] += b_ms
        tot["f32_graph"] += g_ms
        tot["f32_lib_graph"] += g_lib
        del x, dy
    # ragged T, D and F on both operand types
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((1000, 333), generator=gen, device="cuda").to(dt)
        dy = (torch.randn((1000, 77), generator=gen, device="cuda")
              * 1000 ** -0.5).to(dt)
        path = koa.up_plan(x, dy).path
        check(path == ("f32" if dt == torch.float32 else "generic"),
              f"outer_accum ragged {dt}: planned onto the {path} path")
        before = koa.PATH_COUNTERS[path].n
        got = koa.outer_accum(x, dy, scale=0.5)
        check(koa.PATH_COUNTERS[path].n == before + 1,
              f"outer_accum ragged: the {path} counter did not move")
        want = koa.outer_accum_plain(x, dy, scale=0.5)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"outer_accum ragged 1000x333x77 {dt} ({path}): max abs err "
              f"{errs(got, want)[0]:.3g}")
        print(f"[outer_accum] ragged T=1000 D=333 F=77 {dt} ({path} path): "
              f"max_abs_err {errs(got, want)[0]:.3g}")
    print(f"[outer_accum] a step's five UP shapes (head: one of 4 chunks), "
          f"SR: kernel {tot['ms']:.4f}ms plain {tot['plain']:.4f}ms "
          f"torch.matmul {tot['lib']:.4f}ms bound {tot['bound']:.4f}ms")
    print(f"[outer_accum:f32] the same shapes, f32 operands: kernel "
          f"{tot['f32_ms']:.4f}ms plain {tot['f32_plain']:.4f}ms torch.matmul "
          f"(no TF32) {tot['f32_lib']:.4f}ms bound {tot['f32_bound']:.4f}ms "
          f"(f32 peak); in a CUDA graph: kernel {tot['f32_graph']:.4f}ms, "
          f"torch.matmul {tot['f32_lib_graph']:.4f}ms")
    f32_row = {"name": "outer_accum:f32", "route": "cuda",
               "source": "src/repro_torch/csrc/sgemm_sm90.cuh",
               "entry": "src/repro_torch/csrc/outer_accum.cu",
               "replaces": "src/repro/kernels/outer_accum.py:80",
               "tpu_kernel": "repro/kernels/outer_accum.py::outer_accum",
               "max_abs_err": f32_abs, "ms": tot["f32_ms"],
               "kernel_ms": tot["f32_ms"], "graph_ms": tot["f32_graph"],
               "plain_ms": tot["f32_plain"], "library_ms": tot["f32_lib"],
               "library_graph_ms": tot["f32_lib_graph"],
               "bound_ms": tot["f32_bound"],
               "bound_by": max(f32_by, key=f32_by.get),
               "shapes": "the same five UP products, f32 operands (the "
                         "fp32 preset), f32 out"}
    row = {"name": "outer_accum", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm_sm90.cuh",
            "entry": "src/repro_torch/csrc/outer_accum.cu",
            "replaces": "src/repro/kernels/outer_accum.py:80",
            "tpu_kernel": "repro/kernels/outer_accum.py::outer_accum",
            "max_abs_err": worst_abs, "ms": tot["ms"], "kernel_ms": tot["ms"],
            "plain_ms": tot["plain"], "library_ms": tot["lib"],
            "bound_ms": tot["bound"], "bound_by": max(by_ms, key=by_ms.get),
            "shapes": f"the five UP products of a step, SR epilogue: one "
                      f"layer's four at T={TRAIN_B * TRAIN_S} + one tied-head "
                      f"loss chunk (T/4)"}
    return [row, f32_row]


def phase_sr_round(cfg, peaks) -> dict:
    """sr_round: bit-exact on random and edge bit patterns, timed on the
    largest optimizer leaf (the stacked ffn_in, 24 x 896 x 9728)."""
    import torch
    from repro_torch.kernels import sr_round as ksr
    gen = torch.Generator(device="cuda").manual_seed(5)
    edge = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                         -0.0, 1e-45, 1e-40, -1e-40, 3.4028235e38,
                         -3.4028235e38, 1.0, -1.0], device="cuda")
    for n, off in ((1 << 20, 0), (1001, 0), (4096, 1)):
        raw = torch.randint(-2**31, 2**31, (n + off,), generator=gen,
                            device="cuda", dtype=torch.int32)
        raw[off:off + edge.numel()] = edge.view(torch.int32)
        x = raw.view(torch.float32)[off:]
        rb = _rbits(gen, (n + off,))[off:]
        got = ksr.sr_round(x, rb)
        check(torch.equal(got.view(torch.int16),
                          ksr.sr_round_plain(x, rb).view(torch.int16)),
              f"sr_round: not bit-exact on {n} random/edge patterns "
              f"(offset {off})")
    shape = (cfg.n_layers, cfg.d_model, 2 * cfg.d_ff)
    x = torch.randn(shape, generator=gen, device="cuda") * 0.03
    rb = _rbits(gen, shape)
    got = ksr.sr_round(x, rb)
    check(torch.equal(got.view(torch.int16),
                      ksr.sr_round_plain(x, rb).view(torch.int16)),
          f"sr_round: not bit-exact on the {shape} leaf")
    del got
    ms = time_ms(lambda: ksr.sr_round(x, rb), iters=10)
    plain = time_ms(lambda: ksr.sr_round_plain(x, rb), iters=3, warmup=1)
    n = x.numel()
    b_ms, by = bound(n * (4 + 4 + 2), 2 * n, peaks)
    print(f"[sr_round] leaf {shape} ({n} elements): kernel {ms:.4f}ms plain "
          f"{plain:.4f}ms bound {b_ms:.4f}ms ({by})  bit-exact")
    return {"name": "sr_round", "route": "cuda",
            "source": "src/repro_torch/csrc/sr_round.cu",
            "replaces": "src/repro/kernels/sr_round.py:36",
            "tpu_kernel": "repro/kernels/sr_round.py::sr_round",
            "max_abs_err": 0.0, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "shapes": f"the largest optimizer leaf {shape}, f32 -> bf16"}


# wkv6 against its plain version: an f32 recurrence with fused
# multiply-adds and another summation order, values O(1)
# (tests/test_torch_cuda.py).
WKV_TOL = 1e-4


def phase_wkv6(peaks) -> dict:
    """wkv6 at rwkv6-1.6b's serving shapes (32 heads of 64): a 32-token
    PREFILL chunk of one slot from a nonzero carried state, a DECODE step
    of 32 slots, a ragged 100-token chunk (four token tiles), 257 tokens
    (nine) and near-total decay; each with bf16 r, k, v (the serving
    path's projections, read in place) and with f32 ones.  The bf16
    chunk and step are the main shapes (timed cold in L2, as served).
    Then, untimed, one slot's speculative verify and replay chunks of
    1..SPEC_K tokens from a nonzero state, against the plain version."""
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    H, hd = 32, 64
    gen = torch.Generator(device="cuda").manual_seed(6)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    tot = {"ms": 0.0, "graph": 0.0, "plain": 0.0, "bound": 0.0}
    per_shape = {}
    worst = 0.0
    by_ms = {"bytes": 0.0, "operations": 0.0}
    for (name, B, S, decay, main), rkv in itertools.product(
            (("prefill", 1, 32, None, True), ("decode", 32, 1, None, True),
             ("ragged", 1, 100, None, False), ("long", 1, 257, None, False),
             ("strong", 1, 32, 1e-6, False)),
            (torch.bfloat16, torch.float32)):
        main = main and rkv == torch.bfloat16
        r, k, v = (0.5 * rnd(B, S, H, hd) for _ in range(3))
        r, k, v = (t.to(rkv) for t in (r, k, v))
        w = (torch.full((B, S, H, hd), decay, device="cuda") if decay
             else 0.45 + 0.5 * torch.sigmoid(rnd(B, S, H, hd)))
        u = 0.1 * rnd(H, hd)
        s0 = 0.3 * rnd(B, H, hd, hd)
        state = s0.clone()
        y, s = kwkv.wkv6_bshd(r, k, v, w, u, state)
        yp, sp = kwkv.wkv6_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err = max(float((y - yp).abs().max()), float((s - sp).abs().max()))
        tag = f"{name} {str(rkv).split('.')[-1]}"
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"wkv6 {tag}: non-finite output")
        check(torch.allclose(y, yp, atol=WKV_TOL, rtol=WKV_TOL)
              and torch.allclose(s, sp, atol=WKV_TOL, rtol=WKV_TOL),
              f"wkv6 {tag} (B={B} S={S}): max abs err {err:.3g}")
        # two calls on the same inputs: the same bits
        s2 = s0.clone()
        y2, _ = kwkv.wkv6_bshd(r, k, v, w, u, s2)
        check(torch.equal(y2, y) and torch.equal(s2, s),
              f"wkv6 {tag}: two calls differ")
        worst = max(worst, err)
        ms = time_ms(lambda: kwkv.wkv6_bshd(r, k, v, w, u, state))
        g_ms = time_graph_ms(lambda: kwkv.wkv6_bshd(r, k, v, w, u, state))
        plain = time_ms(lambda: kwkv.wkv6_plain(r, k, v, w, u, s0), iters=3,
                        warmup=1)
        n_tok = B * S * H * hd
        # r, k, v in their type; w in, y out f32; u; the state in and out
        nbytes = (3 * r.element_size() * n_tok + 8 * n_tok + 4 * H * hd
                  + 8 * B * H * hd * hd)
        flops = 7 * B * S * H * hd * hd
        b_ms, by = bound(nbytes, flops, peaks, f32=True)
        # served, a layer's state and inputs are cold in L2 (32 slots'
        # state is 403 MB over the 24 layers): the same call on distinct
        # copies that together exceed the 50 MB L2, one after another
        sets = [tuple(t.clone() for t in (r, k, v, w, state))
                for _ in range(max(2, math.ceil((64 << 20) / nbytes)))]
        cyc = itertools.cycle(sets)

        def cold_call():
            rr, kk, vv, ww, ss = next(cyc)
            kwkv.wkv6_bshd(rr, kk, vv, ww, u, ss)

        g_cold = time_graph_ms(cold_call, iters=len(sets), replays=5)
        del sets
        p = kwkv.wkv6_plan(B, H, S, hd)
        print(f"[wkv6] {tag:<15} B={B} S={S} H={H} hd={hd} from state: "
              f"kernel {ms:.4f}ms (in a CUDA graph {g_ms:.4f}ms; cold in L2 "
              f"{g_cold:.4f}ms) plain {plain:.4f}ms bound {b_ms:.4f}ms "
              f"({by})  max_abs_err {err:.3g}; 2 calls bit-equal; plan "
              f"{p.grid} blocks x {p.threads} threads, {p.cols} columns, "
              f"tile {p.tile} x {p.stages}")
        if main:
            tot["ms"] += ms
            tot["graph"] += g_cold
            tot["plain"] += plain
            tot["bound"] += b_ms
            by_ms[by] += b_ms
            per_shape["step" if S == 1 else "chunk"] = {
                "B": B, "S": S, "ms": ms, "warm_graph_ms": g_ms,
                "graph_ms": g_cold, "bound_ms": b_ms}
    # the speculative chunks of one slot: a verify of SPEC_K tokens and
    # replays of 1..SPEC_K, from a nonzero carried state (untimed)
    for S, rkv in itertools.product(range(1, SPEC_K + 1),
                                    (torch.bfloat16, torch.float32)):
        r, k, v = (0.5 * rnd(1, S, H, hd) for _ in range(3))
        r, k, v = (t.to(rkv) for t in (r, k, v))
        w = 0.45 + 0.5 * torch.sigmoid(rnd(1, S, H, hd))
        u = 0.1 * rnd(H, hd)
        s0 = 0.3 * rnd(1, H, hd, hd)
        state = s0.clone()
        y, s = kwkv.wkv6_bshd(r, k, v, w, u, state)
        yp, sp = kwkv.wkv6_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err = max(float((y - yp).abs().max()), float((s - sp).abs().max()))
        tag = f"spec S={S} {str(rkv).split('.')[-1]}"
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"wkv6 {tag}: non-finite output")
        check(torch.allclose(y, yp, atol=WKV_TOL, rtol=WKV_TOL)
              and torch.allclose(s, sp, atol=WKV_TOL, rtol=WKV_TOL),
              f"wkv6 {tag} (B=1): max abs err {err:.3g}")
        worst = max(worst, err)
        p = kwkv.wkv6_plan(1, H, S, hd)
        print(f"[wkv6] {tag:<15} B=1 S={S} H={H} hd={hd} from state: "
              f"max_abs_err {err:.3g}; plan {p.grid} blocks x {p.threads} "
              f"threads, {p.cols} columns, tile {p.tile} x {p.stages}")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:98",
            "tpu_kernel": "repro/kernels/wkv6.py::wkv6",
            "max_abs_err": worst, "ms": tot["ms"], "kernel_ms": tot["ms"],
            "graph_ms": tot["graph"], "plain_ms": tot["plain"],
            "library_ms": None, "bound_ms": tot["bound"],
            "bound_by": max(by_ms, key=by_ms.get), "per_shape": per_shape,
            "shapes": "rwkv6-1.6b: a 32-token PREFILL chunk of one slot "
                      "(B*H = 32) + a DECODE step of 32 slots (B*H = 1024, "
                      "S = 1), hd 64, bf16 r, k, v, from a carried state"}


def phase_fused_ffn(cfg, params, peaks) -> dict:
    """fused_ffn at the rwkv6-1.6b decode shape: 32 rows, layer 0's FF
    (layernorm with random scale and bias, relu^2); its times (events,
    CUDA graph, host, each launch), two calls bit-equal, rows independent
    of B."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    B, d, f = 32, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = dict(w_in=params["groups"]["u0"]["ffn"]["ffn_in"][0],
             w_out=params["groups"]["u0"]["ffn"]["ffn_out"][0],
             norm2_scale=1 + 0.3 * torch.randn(d, generator=gen, device="cuda"),
             norm2_bias=0.2 * torch.randn(d, generator=gen, device="cuda"))
    kw = dict(norm_kind=cfg.norm, act=cfg.act)
    n2s, n2b = w["norm2_scale"], w["norm2_bias"]
    x = (4 * torch.randn((B, d), generator=gen, device="cuda")).bfloat16()
    c0, l0 = kdf.FFN_COUNTER.n, kdf.FFN_LAUNCHES.n
    y = kdf.fused_ffn(x, **w, **kw)
    per_call = kdf.FFN_LAUNCHES.n - l0
    plan = kdf.decode_plan(B, d, f=f, gated=False, attention=False)
    check(kdf.FFN_COUNTER.n == c0 + 1 and per_call == plan.launches == 3,
          f"fused_ffn: {per_call} launches in a call, plan {plan.launches}")
    tn = kdf._clip_block_n(256, f)
    yp = kdf.fused_ffn_plain(x, n2s=n2s, n2b=n2b, w_in=w["w_in"],
                             w_out=w["w_out"], tn=tn, **kw)
    torch.cuda.synchronize()
    ea, _ = errs(y, yp)
    check(torch.allclose(y.float(), yp.float(), atol=Y_TOL, rtol=Y_TOL),
          f"fused_ffn B={B} d={d} f={f}: max abs err {ea:.3g}")
    call = lambda: kdf.fused_ffn(x, **w, **kw)
    check_deterministic(lambda: [call()],
                        lambda: [kdf.fused_ffn(x[:5].contiguous(), **w,
                                               **kw)], "fused_ffn")
    ms = time_ms(call)
    dev_ms = time_graph_ms(call)
    host = decode_host_ms(call, "fused_ffn_bf16", plan.ws_bytes, (B, d))
    plain = time_ms(lambda: kdf.fused_ffn_plain(
        x, n2s=n2s, n2b=n2b, w_in=w["w_in"], w_out=w["w_out"], tn=tn, **kw))
    hf = torch.randn((B, f), generator=gen, device="cuda").bfloat16()
    mm_ms = time_graph_ms(lambda: (torch.matmul(x, w["w_in"]),
                                   torch.matmul(hf, w["w_out"])))
    nbytes = 2 * (2 * d * f) + 2 * 2 * B * d + 4 * 2 * d
    b_ms, by = bound(nbytes, 2 * B * 2 * d * f, peaks)
    plans = {n: [p.tiles, p.splits] for n, p in plan.products.items()}
    print(f"[fused_ffn] B={B} d={d} f={f} {cfg.act} {cfg.norm}: kernel "
          f"{ms:.4f}ms plain {plain:.4f}ms bound {b_ms:.4f}ms ({by}); in a "
          f"CUDA graph {dev_ms:.4f}ms (torch.matmul on the two weight "
          f"products, a yardstick: {mm_ms:.4f}ms)  max_abs_err {ea:.3g}; "
          f"{per_call} launches a call; 2 calls bit-equal; rows 0..4 = "
          f"5-row call; plan (column tiles, splits) {plans}")
    print(f"[fused_ffn] host time per call (ms): whole call "
          f"{host['call']:.4f}, ctypes call {host['ctypes']:.4f}, wrapper "
          f"Python {host['wrapper']:.4f}")
    return {"name": "fused_ffn", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_fused.cu",
            "replaces": "src/repro/kernels/decode_fused.py:315",
            "tpu_kernel": "repro/kernels/decode_fused.py::fused_ffn",
            "max_abs_err": ea, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "graph_ms": dev_ms, "matmul_graph_ms": mm_ms, "host_ms": host,
            "launches_per_call": per_call, "plans": plans,
            "shapes": f"rwkv6-1.6b, one layer's FF: B={B}, d={d}, f={f}"}


# granite-moe-1b-a400m's PREFILL expert products: C rows an expert for a
# chunk of T tokens (C = T rounded up to 8: 32 for the served 32-token
# chunk; 8 and 40 for a short tail and a ragged row tile)
EXPERT_CS = (8, 32, 40)


def _expert_plan_sweep(name: str, a, w, layers, want,
                       label: str = "sr_matmul:experts") -> dict:
    """The batched product a @ w under 64- and 128-wide column tiles, each
    with and without a split of K: each within MM_RTOL / MM_ATOL of
    `want`, timed in a CUDA graph warm in L2 (w again and again) and cold
    (`layers`' tables in turn); the tile width and split that plan()
    picks for a MoE chunk rest on these times.  {"<bn>x<splits>":
    {"warm": ms, "cold": ms}}."""
    import torch
    from repro_torch.kernels import sr_matmul as kmm
    E, C, K = a.shape
    N = w.shape[2]
    chosen = kmm.plan(C, N, K, "k", "n", experts=E)
    out = torch.empty((E, C, N), dtype=torch.float32, device="cuda")
    res = {}
    for bn, splits in itertools.product((64, 128), (1, 2)):
        p = kmm.Plan("sm90", kmm.SM90_BM, bn, kmm.SM90_BK, splits)
        kmm._batched_call(a, w, out, p, False)
        torch.cuda.synchronize()
        check(torch.allclose(out, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"{label} {bn}-wide, {splits} splits (K={K}, N={N}): "
              f"max abs err {errs(out, want)[0]:.3g}")
        warm = time_graph_ms(lambda: kmm._batched_call(a, w, out, p, False))
        cold = time_graph_ms(lambda: [kmm._batched_call(a, wl, out, p, False)
                                      for wl in layers],
                             iters=2) / len(layers)
        res[f"{bn}x{splits}"] = {"warm": warm, "cold": cold}
    print(f"[{label}] {name:<12} K={K} N={N} plan sweep, graph "
          f"ms warm / cold in L2 (planned {chosen.bn}x{chosen.splits}): "
          + ", ".join(
              f"{k} {v['warm']:.4f} / {v['cold']:.4f}"
              for k, v in res.items()))
    return res


def _routed_rows(gcfg, router_w, T: int, gen) -> tuple:
    """A MoE layer's routing of T tokens (T <= 4096: dropless, C = T
    rounded up to 8) as models/moe.py makes it, on the card: the router
    (_route, reference backend) on seeded activations x (T, d), the
    dispatch into the (E, C, d) bf16 buffer of x's rows, and each
    expert's live rows (_expert_rows).  Returns (rows, buffer), the
    buffer f32 (the bf16 words cast it)."""
    import torch
    from repro_torch.engine.context import PEContext
    from repro_torch.models import moe
    E, k, d = gcfg.moe.n_experts, gcfg.moe.top_k, gcfg.d_model
    x = torch.randn((T, d), generator=gen, device="cuda")
    _, topi, _ = moe._route(x, router_w.float(), k, PEContext())
    C = max(8, -(-T // 8) * 8)
    slot, keep = moe._dispatch_indices(topi.reshape(-1), E, C)
    tok = torch.arange(T, device="cuda").repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), device="cuda")
    buf.index_copy_(0, slot, x[tok] * keep[:, None])
    return moe._expert_rows(topi, E, C), buf[:-1].reshape(E, C, d)


def _live_buffer(rows, C: int, width: int, gen, scale: float = 1.0,
                 f32: bool = False):
    """(E, C, width) bf16 (f32 with `f32`), random below each expert's
    live rows, zero past them (as the dispatch leaves a buffer)."""
    import torch
    from repro_torch.kernels import sr_matmul as kmm
    r = torch.randn((rows.numel(), C, width), generator=gen, device="cuda")
    buf = torch.where(kmm.live_rows(rows, C)[..., None], r * scale, 0.0)
    return buf if f32 else buf.bfloat16()


def _expert_role(tag: str, role: str, tables: list, rows, C: int, peaks,
                 variants) -> dict:
    """One role of a MoE layer's bf16 batched products over its three
    tables, as the main path runs them: `tables` holds (name, routed, full)
    with three operand sets each — routed: every expert's rows past
    `rows` zero; full: every row live (the skewed worst case) — as (a, w)
    (role prefill, ff: a . w; bp: a . w^T, trans_b) or (x, dy, rbits)
    (up: SR x^T dy).  Gates each table's routed product: its f32 form
    within MM_RTOL / MM_ATOL of the plain version, its bf16 out (FF, BP,
    PREFILL) bit-equal to that f32 out rounded to nearest even, its SR
    out (UP) bit-equal to the plain SR cast of that f32 out, and each
    equal to the all-live kernel's on the same buffers (up to the sign of
    a zero).  Times in a CUDA graph, warm in L2 (set 0 again and again)
    and cold (the three sets in turn): the parent-equivalent all-live
    form (FF / BP / PREFILL: every row, f32 out, then the cast to bf16;
    UP: every token), the all-live bf16 form, the routed form (also in
    CUDA events) and torch.bmm on the routed buffers; the bounds over the
    full C and over the live rows (the inputs' live rows, every table an
    expert with a live row reads, the whole output; UP: the whole bits
    and dW); the routed form's mainloop / epilogue split
    (launch/ablate_experts.py's variants, warm).  Returns the sums over
    the three tables."""
    import torch
    from repro_torch.core.rounding import sr_cast_bf16
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import sr_matmul as kmm
    from repro_torch.launch import ablate_experts as ablate
    bf = torch.bfloat16
    E, live_n, busy = rows.numel(), int(rows.sum()), int((rows > 0).sum())
    keys = ("ms", "plain", "lib", "graph", "cold", "lib_graph", "lib_cold",
            "parent_graph", "parent_cold", "all_live_graph",
            "all_live_cold", "bound", "bound_full")
    tot = {k: 0.0 for k in keys}
    split, by_ms, worst = {}, {"bytes": 0.0, "operations": 0.0}, 0.0
    for name, routed, full in tables:
        if role == "up":
            x, dy, rb = routed[0]
            K, N = x.shape[2], dy.shape[2]
            run = lambda o: koa.outer_accum_batched(o[0], o[1], rbits=o[2],
                                                    rows=rows)
            every = lambda o: koa.outer_accum_batched(o[0], o[1],
                                                      rbits=o[2])
            parent = every
            lib = lambda o: torch.bmm(o[0].transpose(1, 2), o[1])
            f32 = koa.outer_accum_batched(x, dy, rows=rows)
            want = koa.outer_accum_batched_plain(x, dy)
            got = run(routed[0])
            check(torch.equal(got.view(torch.int16),
                              sr_cast_bf16(f32, rb).view(torch.int16)),
                  f"{tag} up {name}: the SR epilogue is not the plain SR "
                  f"cast of the kernel's own f32 product")
            plain = lambda: koa.outer_accum_batched_plain(x, dy, rbits=rb,
                                                          rows=rows)
            out_elems, red = E * K * N, (K + N)
            nb_live = 2 * live_n * red + 6 * out_elems
            nb_full = 2 * E * C * red + 6 * out_elems
            fl_live, fl_full = 2 * live_n * K * N, 2 * E * C * K * N
        else:
            a, w = routed[0]
            trans_b = role == "bp"
            run = lambda o: kmm.sr_matmul_batched(
                o[0], o[1], trans_b=trans_b, rows=rows, out_dtype=bf)
            every = lambda o: kmm.sr_matmul_batched(
                o[0], o[1], trans_b=trans_b, out_dtype=bf)
            parent = lambda o: kmm.sr_matmul_batched(
                o[0], o[1], trans_b=trans_b).to(bf)
            lib = lambda o: torch.bmm(o[0], o[1].transpose(1, 2) if trans_b
                                      else o[1])
            f32 = kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=rows)
            want = kmm.sr_matmul_batched_plain(a, w, trans_b=trans_b,
                                               rows=rows)
            got = run(routed[0])
            check(torch.equal(got.view(torch.int16),
                              f32.to(bf).view(torch.int16)),
                  f"{tag} {role} {name}: the bf16 epilogue is not the f32 "
                  f"out rounded to nearest even")
            plain = lambda: kmm.sr_matmul_batched_plain(
                a, w, trans_b=trans_b, rows=rows, out_dtype=bf)
            kr, (kw, nw) = a.shape[2], w.shape[1:]
            n_out = kw if trans_b else nw
            nb_live = 2 * live_n * kr + 2 * busy * kw * nw + 2 * E * C * n_out
            nb_full = 2 * E * C * kr + 2 * E * kw * nw + 2 * E * C * n_out
            fl_live, fl_full = 2 * live_n * kw * nw, 2 * E * C * kw * nw
        torch.cuda.synchronize()
        ea, _ = errs(f32, want)
        worst = max(worst, ea)
        check(torch.allclose(f32, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"{tag} {role} {name} (routed, C={C}): max abs err {ea:.3g}")
        check(torch.equal(got, every(routed[0])),
              f"{tag} {role} {name}: the live rows' result differs from the "
              f"all-live kernel's on the same buffers")
        if role != "up":
            a_all, w_all = full[0]
            check(torch.allclose(
                kmm.sr_matmul_batched(a_all, w_all, trans_b=trans_b),
                kmm.sr_matmul_batched_plain(a_all, w_all, trans_b=trans_b),
                rtol=MM_RTOL, atol=MM_ATOL),
                f"{tag} {role} {name}: every row live, out of tolerance")
        del f32, want, got
        b_live, by = bound(nb_live, fl_live, peaks)
        b_full, _ = bound(nb_full, fl_full, peaks)
        t = {"ms": time_ms(lambda: run(routed[0])),
             "plain": time_ms(plain, iters=3, warmup=1),
             "lib": time_ms(lambda: lib(routed[0])),
             "graph": time_graph_ms(lambda: run(routed[0])),
             "cold": time_graph_ms(lambda: [run(o) for o in routed],
                                   iters=2) / len(routed),
             "lib_graph": time_graph_ms(lambda: lib(routed[0])),
             "lib_cold": time_graph_ms(lambda: [lib(o) for o in routed],
                                       iters=2) / len(routed),
             "parent_graph": time_graph_ms(lambda: parent(full[0])),
             "parent_cold": time_graph_ms(lambda: [parent(o) for o in full],
                                          iters=2) / len(full),
             "all_live_graph": time_graph_ms(lambda: every(full[0])),
             "all_live_cold": time_graph_ms(lambda: [every(o) for o in full],
                                            iters=2) / len(full),
             "bound": b_live, "bound_full": b_full}
        sp = ablate.times(variants, lambda: run(routed[0]), time_graph_ms)
        for k, v in t.items():
            tot[k] += v
        for k, v in sp.items():
            split[k] = split.get(k, 0.0) + v
        by_ms[by] += b_live
        print(f"[{tag}] {role} {name:<12} C={C} ({live_n} of {E * C} rows "
              f"live): graph warm / cold: routed {t['graph']:.4f} / "
              f"{t['cold']:.4f}, all-live {t['all_live_graph']:.4f} / "
              f"{t['all_live_cold']:.4f}, parent-equivalent all-live "
              f"{t['parent_graph']:.4f} / {t['parent_cold']:.4f}, torch.bmm "
              f"{t['lib_graph']:.4f} / {t['lib_cold']:.4f}; bound live rows "
              f"{b_live:.4f} ({by}), full C {b_full:.4f}; events: routed "
              f"{t['ms']:.4f}, plain {t['plain']:.4f}, torch.bmm "
              f"{t['lib']:.4f}; split: {ablate.split_txt(sp)}; max_abs_err "
              f"{ea:.3g}; == all-live kernel")
    print(f"[{tag}] {role}, one layer's three tables at C={C}, graph warm / "
          f"cold: routed {tot['graph']:.4f} / {tot['cold']:.4f}, all-live "
          f"{tot['all_live_graph']:.4f} / {tot['all_live_cold']:.4f}, "
          f"parent-equivalent all-live {tot['parent_graph']:.4f} / "
          f"{tot['parent_cold']:.4f}, torch.bmm {tot['lib_graph']:.4f} / "
          f"{tot['lib_cold']:.4f}; bound live rows {tot['bound']:.4f}, full "
          f"C {tot['bound_full']:.4f}; split: {ablate.split_txt(split)}")
    return {**tot, "split": split, "max_abs_err": worst,
            "bound_by": max(by_ms, key=by_ms.get), "live_rows": live_n,
            "rows": E * C}


def phase_sr_matmul_experts(gcfg, gparams, peaks, unit: str = "u0",
                            label: str = "sr_matmul:experts",
                            cs: tuple = EXPERT_CS) -> dict:
    """sr_matmul's batched mode at a MoE model's full-width PREFILL
    shapes (granite: 32 experts, in and gate 1024 -> 512, out 512 ->
    1024; jamba's unit u1: 16 experts, 4096 -> 14336 and 14336 -> 4096):
    the first layer of `unit`'s three expert tables at C in `cs` rows an
    expert, every row random, each call one launch on the sm90 path,
    within MM_RTOL / MM_ATOL of the plain version and bit-equal over two
    calls, with the plan sweep at the served C = 32; then the served
    chunk as the main path runs it (_expert_role: a 32-token chunk routed
    by that layer's router, timed in a CUDA graph warm and cold in L2,
    each call on another layer's table of the unit (granite: as a
    chunk's 24 layers read them, 24 x 33.5 MB a table, the L2 50 MB;
    jamba: 1.9 GB a table, no layer's table fits the L2))."""
    import torch
    from repro_torch.kernels import sr_matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(21)
    moe = gparams["groups"][unit]["moe"]
    tables = [(n, moe[n][0]) for n in ("experts_in", "experts_gate",
                                       "experts_out")]
    E = gcfg.moe.n_experts
    worst_abs = worst_rel = 0.0
    plans, sweep = {}, {}
    for C in cs:
        for name, w in tables:
            _, K, N = w.shape
            a = torch.randn((E, C, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            p = kmm.plan(C, N, K, "k", "n", experts=E)
            check(p.path == "sm90", f"{label} {name} C={C}: "
                  f"{plan_txt(p)}, want sm90")
            before = {k: c.n for k, c in (("batched", kmm.BATCHED_COUNTER),
                                          ("all", kmm.COUNTER),
                                          *kmm.PATH_COUNTERS.items())}
            got = kmm.sr_matmul_batched(a, w)
            after = {k: c.n for k, c in (("batched", kmm.BATCHED_COUNTER),
                                         ("all", kmm.COUNTER),
                                         *kmm.PATH_COUNTERS.items())}
            moved = {k: after[k] - before[k] for k in after}
            check(moved == {"batched": 1, "all": 1, "sm90": 1, "generic": 0,
                            "f32": 0},
                  f"{label} {name} C={C}: counters moved {moved}, "
                  f"want one sm90 launch")
            want = kmm.sr_matmul_batched_plain(a, w)
            again = kmm.sr_matmul_batched(a, w)
            torch.cuda.synchronize()
            ea, er = errs(got, want)
            check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
                  f"{label} {name} ({E}x{C}x{K}x{N}): max abs err "
                  f"{ea:.3g}")
            check(torch.equal(got, again),
                  f"{label} {name} C={C}: two calls differ")
            worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
            print(f"[{label}] {name:<12} E={E} C={C} K={K} "
                  f"N={N} {plan_txt(p)}: max_abs_err {ea:.3g}; 2 calls "
                  f"bit-equal; one launch")
            if C == 32:
                plans[name] = list(p)
                sweep[name] = _expert_plan_sweep(
                    name, a, w, moe[name].unbind(0), want, label)
    # the main path's chunk: the first layer's router on a seeded
    # 32-token chunk, its dispatched buffer and live rows, bf16 out;
    # cold: the unit's first three layers' tables in turn
    from repro_torch.launch import ablate_experts
    variants = ablate_experts.build_variants()
    rows, xb = _routed_rows(gcfg, moe["router"][0], 32, gen)
    xb = xb.bfloat16()
    tabs = []
    for name, w in tables:
        a = xb if w.shape[1] == gcfg.d_model else _live_buffer(
            rows, 32, w.shape[1], gen)
        full = torch.randn((E, 32, w.shape[1]), generator=gen,
                           device="cuda").bfloat16()
        layers = moe[name].unbind(0)[:3]
        tabs.append((name, [(a, wl) for wl in layers],
                     [(full, wl) for wl in layers]))
    r = _expert_role(f"{label}:routed", "prefill", tabs, rows, 32,
                     peaks, variants)
    return {"name": label, "counter": "sr_matmul:batched",
            "route": "cuda", "source": "src/repro_torch/csrc/"
                                       "gemm_sm90_batched.cuh",
            "entry": "src/repro_torch/csrc/sr_matmul.cu",
            "replaces": "src/repro/kernels/sr_matmul.py:96",
            "tpu_kernel": "repro/kernels/sr_matmul.py::sr_matmul under "
                          "jax.vmap (repro/engine/dispatch.py:198-199, "
                          "220-229)",
            "redesigned": "live rows, bf16 out by TMA store",
            "max_abs_err": max(worst_abs, r["max_abs_err"]),
            "max_rel_err": worst_rel,
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain"],
            "library_ms": r["lib"], "library": "torch.bmm",
            "bound_ms": r["bound"], "bound_by": r["bound_by"],
            "full_c_bound_ms": r["bound_full"], "graph_ms": r["graph"],
            "library_graph_ms": r["lib_graph"], "cold_graph_ms": r["cold"],
            "library_cold_graph_ms": r["lib_cold"],
            "all_live_graph_ms": r["all_live_graph"],
            "all_live_cold_graph_ms": r["all_live_cold"],
            "parent_equivalent_graph_ms": r["parent_graph"],
            "parent_equivalent_cold_graph_ms": r["parent_cold"],
            "split_graph_ms": r["split"], "live_rows": r["live_rows"],
            "plans": plans, "plan_sweep": sweep,
            "shapes": f"{gcfg.name} unit {unit}'s first layer, one "
                      f"32-token PREFILL chunk routed by its router: "
                      f"experts_in, experts_gate, experts_out, E={E}, C=32, "
                      f"bf16 out"}


def _layer0(tree):
    """Group 0's slice of every leaf of a stacked parameter tree."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def phase_fused_served(cfg, params, peaks, label: str,
                       unit: str = "u0") -> dict:
    """fused_attn_unit as `cfg`'s served decode calls it, at full width:
    the first layer of pattern unit `unit` (an attention unit), its norm
    kind (olmo's non-parametric LN is a layernorm with no affine
    operands) and activation, its FF (none on a MoE unit),
    B=SERVE_SLOTS rows, S=SERVE_LEN, 3 steps against the plain version;
    decode_plan's launches a call (7 with the FF, 5 without) as the C
    entry counts them; its CUDA-graph time beside its bound."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.models import transformer as tfm
    a = cfg.attention
    B, S, d = SERVE_SLOTS, SERVE_LEN, cfg.d_model
    H, K, hd = a.n_heads, a.n_kv_heads, a.head_dim
    u = _layer0(params["groups"][unit])
    dense = tfm.layer_pattern(cfg)[int(unit[1:])].ffn == "dense"
    n1, nk = tfm._fused_norm_args(cfg, u, "norm1")
    n2, _ = tfm._fused_norm_args(cfg, u, "norm2")
    w = dict(qkv_w=u["attn"]["qkv"], qkv_bias=u["attn"].get("qkv_bias"),
             o_w=u["attn"]["o"], norm1_scale=(n1 or {}).get("scale"),
             norm1_bias=(n1 or {}).get("bias"))
    if dense:
        w.update(w_in=u["ffn"]["ffn_in"], w_out=u["ffn"]["ffn_out"],
                 norm2_scale=(n2 or {}).get("scale"),
                 norm2_bias=(n2 or {}).get("bias"))
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=a.rope_theta,
              window=a.window, norm_kind=nk, act=cfg.act, with_ffn=dense)
    gen = torch.Generator(device="cuda").manual_seed(22)
    _, cache, fill = _fused_case(B, S, d, H, K, hd, 8, gen, w)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[B // 3] = False
    ea, er = _check_fused_steps(w, cache, fill, kw, active, gen, label)
    planned = launches_per_call(cfg)["fused_attn_unit"]
    x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = (fill + 3).to(torch.int32)
    kern = [c.clone() for c in cache]
    call = lambda: kdf.fused_attn_unit(x, *kern, pos, active=active, **w,
                                       **kw)
    l0 = kdf.LAUNCHES.n
    call()
    per_call = kdf.LAUNCHES.n - l0
    check(per_call == planned == (7 if dense else 5),
          f"{label}: {per_call} launches in a call, plan {planned}")
    dev_ms = time_graph_ms(call)
    qn = (H + 2 * K) * hd
    ff = w["w_in"].numel() + w["w_out"].numel() if dense else 0
    valid = int((fill + 4).sum())
    nbytes = 2 * (d * qn + H * hd * d + ff) + valid * K * hd * 4 \
        + B * S * 4 + 2 * 2 * B * d
    b_ms, by = bound(nbytes, 2 * B * (d * qn + H * hd * d + ff)
                     + 4 * H * hd * valid, peaks)
    ffn = (f"d_ff {cfg.d_ff} {cfg.act}" if dense else "without the FF")
    print(f"[{label}] {cfg.name} unit {unit} (d {d}, {H} heads of {hd}, {K} "
          f"KV heads, window {a.window}, {cfg.norm}, {ffn}) B={B} S={S}: "
          f"max_abs_err {ea:.3g} "
          f"within Y_TOL/CACHE_TOL over 3 steps; {per_call} launches a "
          f"call; in a CUDA graph {dev_ms:.4f}ms bound {b_ms:.4f}ms ({by})")
    del cache, kern
    torch.cuda.empty_cache()
    return {"max_abs_err": ea, "max_rel_err": er, "graph_ms": dev_ms,
            "bound_ms": b_ms, "bound_by": by, "launches_per_call": per_call}


def init_served(arch: str, gen) -> tuple:
    """(config, bf16 params) of `arch` at full width from `gen`, with
    random norm scales and biases where the model has them (init makes
    them 1 and 0)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    cfg = get_config(arch)
    t0 = time.monotonic()
    params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
    norms = [u[k] for u in params["groups"].values()
             for k in ("norm1", "norm2") if k in u]
    norms += [params["final_norm"]] if "final_norm" in params else []
    for norm in norms:
        for key, base in (("scale", 1.0), ("bias", 0.0)):
            if key in norm:
                norm[key].copy_(base + 0.1 * torch.randn(
                    norm[key].shape, generator=gen, device="cuda"))
    print(f"[init] {arch} {cfg.param_count()} params in "
          f"{time.monotonic() - t0:.1f}s")
    return cfg, params


@contextlib.contextmanager
def _routing(record: list = None, replay: list = None,
             own_weights: bool = False, near_ties: list = None):
    """Within it, each MoE routing call (models/moe.py `_route`, once a
    layer, again in a remat recompute) appends its (combine weights,
    experts) to `record`, or returns `replay`'s in call order: routing
    held fixed across two runs.  With own_weights only the experts are
    replayed, weighed by the call's own probabilities (training: the
    router keeps its gradient).  A replayed call appends (tokens whose
    own top-k set differs from the replayed one, tokens) to `record`.
    `near_ties` gets (tokens whose k + 1 largest router probabilities,
    in f64, lie nearer than TIE_GAP, tokens) from each call.  Neither
    record nor replay: free routing."""
    import torch
    from repro_torch.models import moe
    if record is None:
        yield
        return
    route, turns = moe._route, iter(replay or ())

    def held(x, router_w, top_k, sh):
        if near_ties is not None:
            with torch.no_grad():
                p = torch.softmax(x.detach().double()
                                  @ router_w.detach().double(), dim=-1)
                top = p.sort(dim=-1, descending=True)[0][:, :top_k + 1]
                gap = (top[:, :-1] - top[:, 1:]).min(dim=-1)[0]
                near_ties.append((int((gap < TIE_GAP).sum()), x.shape[0]))
        topv, topi, aux = route(x, router_w, top_k, sh)
        if replay is None:
            record.append((topv.detach(), topi))
            return topv, topi, aux
        fixed_v, fixed_i = next(turns)
        record.append((int((topi.sort(-1)[0] != fixed_i.sort(-1)[0])
                           .any(-1).sum()), topi.shape[0]))
        if own_weights:
            return route(x, router_w, top_k, sh, experts=fixed_i)
        return fixed_v, fixed_i, aux

    moe._route = held
    try:
        yield
    finally:
        moe._route = route


def _flips(record: list) -> str:
    """'n of m' from a replaying _routing's record."""
    return (f"{sum(n for n, _ in record)} of "
            f"{sum(t for _, t in record)}")


def phase_chunk_vs_reference(cfg, params, label: str, key: str = None,
                             prompt: int = 32, steps: int = 0,
                             ref_params=None, gate: bool = True) -> dict:
    """Teacher-forced on the card: 4 rows prefill `prompt` random tokens
    in 32-token chunks through chunk_step, then take `steps` decode steps
    per-op and fused, on the cuda backend and on the reference backend
    (float64 products): all finite, the first chunk's logits of shape
    (4, min(32, prompt), V).  On a MoE config every run takes the cuda
    per-op run's routing (experts and combine weights), so that a token
    whose top-k set flips between bf16 and f64 products does not hide a
    fault in the batched expert products; the other runs' own flips and
    the chunks' free-routing distance are printed.  Max |dlogit| / std of
    the reference's logits over the chunks, gated by CHUNK_MAX[key], and
    over the decode steps of each cuda run, gated by TF_MAX[key] (key:
    the config's name by default).  `ref_params`: the reference backend's
    own parameters (a control: the cuda runs take `params`); gate=False:
    printed and returned, not gated."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    t0 = time.monotonic()
    key = key or cfg.name
    B, L = 4, prompt + steps
    gen = torch.Generator(device="cuda").manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=gen,
                         device="cuda", dtype=torch.int32)
    moe = cfg.moe is not None

    def run(backend, fused=False, record=None, replay=None, n=steps):
        w = params if ref_params is None or backend == "cuda" else ref_params
        prog = compile_program(cfg, ShapeConfig("tf", L, B, "decode"),
                               fused_decode=fused)
        chunk = tl.make_chunk_step(cfg, prog, kernel_backend=backend)
        step = (tl.make_fused_decode_step if fused else tl.make_decode_step)(
            cfg, prog, kernel_backend=backend)
        cache = tfm.init_cache(cfg, B, L, device="cuda")
        at = lambda t: torch.full((B,), t, dtype=torch.int32,  # noqa: E731
                                  device="cuda")
        chunks, dec = [], []
        with torch.no_grad(), _routing(record if moe else None, replay):
            for c0 in range(0, prompt, 32):
                lg, _ = chunk(w, cache, toks[:, c0:min(c0 + 32, prompt)],
                              at(c0))
                chunks.append(lg.float())
            for t in range(prompt, prompt + n):
                lg, _ = step(w, cache, toks[:, t:t + 1], at(t))
                dec.append(lg.float())
        return chunks, dec

    routes, f_fused, f_ref = [], [], []
    per_op = run("cuda", record=routes)
    held = routes if moe else None
    fused = run("cuda", True, f_fused, held) if steps else ([], [])
    ref = run("reference", record=f_ref, replay=held)
    check(all(bool(torch.isfinite(x).all()) for r in (per_op, fused, ref)
              for part in r for x in part), f"{label}: non-finite logits")
    check(tuple(per_op[0][0].shape) == (B, min(32, prompt), cfg.vocab_size),
          f"{label}: chunk logits {tuple(per_op[0][0].shape)}")
    gap = lambda a, b: max(_gap(x, y)[0] for x, y in zip(a, b))  # noqa
    agree = lambda a, b: sum(_gap(x, y)[1] for x, y in zip(a, b))  # noqa
    res = {"gap": gap(per_op[0], ref[0]), "agree": agree(per_op[0], ref[0]),
           "flips": _flips(f_ref) if moe else None}
    routing = ""
    if moe:
        free = gap(per_op[0], run("reference", n=0)[0])
        routing = (f" with the cuda per-op run's routing (the reference's own"
                   f" top-k set differs on {_flips(f_ref)} token-layers"
                   + (f", the fused run's on {_flips(f_fused)}" if steps
                      else "") + f"; free routing: chunks {free:.4f})")
    txt = ""
    if steps:
        res.update({"per-op": gap(per_op[1], ref[1]),
                    "fused": gap(fused[1], ref[1]),
                    "fused-vs-per-op": gap(fused[1], per_op[1])})
        txt = (f", then {steps} decode steps: per-op {res['per-op']:.4f} "
               f"fused {res['fused']:.4f} (argmax agree "
               f"{agree(per_op[1], ref[1])} / {agree(fused[1], ref[1])} of "
               f"{B * steps}), fused vs per-op {res['fused-vs-per-op']:.4f}")
    print(f"[{label}] {cfg.name} {cfg.n_layers} layers, {B} rows: "
          f"{prompt}-token prompts in {len(ref[0])} chunks{txt}; cuda "
          f"against the reference backend (f64 products){routing}: max "
          f"|dlogit| / std chunks {res['gap']:.4f} (argmax agree "
          f"{res['agree']}/{B * prompt}); phase "
          f"{time.monotonic() - t0:.1f}s")
    if not gate:
        return res
    check(res["gap"] <= CHUNK_MAX[key], f"{label}: chunks {res['gap']:.4f} "
          f"std (gate {CHUNK_MAX[key]})")
    for m in ("per-op", "fused") if steps else ():
        check(res[m] <= TF_MAX[key], f"{label}: {m} decode {res[m]:.4f} std "
              f"(gate {TF_MAX[key]})")
    return res


def serve_counters(cfg) -> dict:
    """The launch counters of the kernels on `cfg`'s serving path, from
    its layer pattern: sr_matmul (and its batched mode with a MoE unit),
    wkv6 with an rwkv6 unit, selective_scan with a Mamba unit,
    fused_attn_unit with an attention unit, fused_ffn with an SSM unit
    whose FF is dense."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import selective_scan as kss
    from repro_torch.kernels import sr_matmul as kmm
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.models import transformer as tfm
    pattern = tfm.layer_pattern(cfg)
    mixers = {u.mixer for u in pattern}
    out = {"sr_matmul": kmm.COUNTER,
           **{f"sr_matmul:{p}": kmm.PATH_COUNTERS[p]
              for p in ("sm90", "generic")}}
    if cfg.moe is not None:
        out["sr_matmul:batched"] = kmm.BATCHED_COUNTER
    if "rwkv6" in mixers:
        out["wkv6"] = kwkv.COUNTER
        out.update({f"wkv6:{k}": c for k, c in kwkv.SHAPE_COUNTERS.items()})
    if "mamba" in mixers:
        out["selective_scan"] = kss.COUNTER
    if "attn" in mixers:
        out["fused_attn_unit"] = kdf.COUNTER
        out["fused_attn_unit:launches"] = kdf.LAUNCHES
    if any(u.mixer != "attn" and u.ffn == "dense" for u in pattern):
        out["fused_ffn"] = kdf.FFN_COUNTER
        out["fused_ffn:launches"] = kdf.FFN_LAUNCHES
    return out


def launches_per_call(cfg) -> dict:
    """{fused word: kernel launches a call} on `cfg`'s served decode
    (SERVE_SLOTS rows, SERVE_LEN positions), from decode_plan:
    fused_attn_unit 7 (5 without the FF, a MoE unit's), fused_ffn 3."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.models import transformer as tfm
    gated = cfg.act in ("swiglu", "geglu")
    pattern = tfm.layer_pattern(cfg)
    out = {}
    attn = {u.ffn for u in pattern if u.mixer == "attn"}
    check(len(attn) <= 1, f"{cfg.name}: attention units with both FF kinds")
    if attn:
        a, dense = cfg.attention, attn == {"dense"}
        out["fused_attn_unit"] = kdf.decode_plan(
            SERVE_SLOTS, cfg.d_model, f=cfg.d_ff if dense else 0,
            gated=gated, heads=a.n_heads, kv_heads=a.n_kv_heads,
            head_dim=a.head_dim, S=SERVE_LEN, with_ffn=dense).launches
    if any(u.mixer != "attn" and u.ffn == "dense" for u in pattern):
        out["fused_ffn"] = kdf.decode_plan(
            SERVE_SLOTS, cfg.d_model, f=cfg.d_ff, gated=gated,
            attention=False).launches
    return out


def serve_trace(cfg) -> list:
    """The served phases' seeded Poisson trace: 16 requests, prompts of
    16-512 tokens, 16 new tokens each."""
    from repro_torch.serving import poisson_trace
    return poisson_trace(16, vocab_size=cfg.vocab_size, prompt_lens=(16, 512),
                         gen_tokens=16, mean_interarrival_steps=2.0, seed=0)


def phase_serve(cfg, params, label: str) -> dict:
    """A main path: the engine serves the seeded trace on the cuda backend,
    fused decode and then per-op decode, counting each kernel's launches
    in each run, and the run's peak device memory.  Returns the fused
    run's counts."""
    import torch
    from repro_torch.serving import build_engine, latency_stats
    trace = serve_trace(cfg)
    counters = serve_counters(cfg)
    runs = {}
    for fused in (True, False):
        eng = build_engine(cfg, n_slots=SERVE_SLOTS, max_len=SERVE_LEN,
                           prefill_chunk=32, kernel_backend="cuda",
                           fused_decode=fused, device="cuda", params=params)
        for c in counters.values():
            c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with torch.no_grad():
            res = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {k: c.n for k, c in counters.items()}
        st = latency_stats(eng.events)
        mode = "fused" if fused else "per-op"
        print(f"[{label}:{mode}] {cfg.n_layers} layers: steps="
              f"{eng.step_count} generated="
              f"{st['tokens']} wall={wall:.3f}s tok/s={st['tokens'] / wall:.2f}"
              f" p50={st['p50_ms']:.3f}ms p99={st['p99_ms']:.3f}ms peak "
              f"{peak:.2f} GiB launches={counts} nonfinite_logits="
              f"{eng.nonfinite_logits}")
        check(eng.nonfinite_logits == 0, f"{label}:{mode}: non-finite logits")
        check(sum(len(v) for v in res.values()) == 16 * 16,
              f"{label}:{mode}: {sum(len(v) for v in res.values())} tokens, "
              f"want 256")
        # every bf16 product on the sm90 path, none on the generic one
        for k, n in counts.items():
            want = (k != "sr_matmul:generic"
                    and (fused or k.split(":")[0] not in (
                        "fused_ffn", "fused_attn_unit")))
            check((n > 0) == want, f"{label}:{mode} launched {k} {n} times")
        # each fused word call made its plan's launches, as its C entry
        # counted them
        for word, per in launches_per_call(cfg).items():
            check(counts[f"{word}:launches"] == per * counts[word],
                  f"{label}:{mode}: {counts[f'{word}:launches']} {word} "
                  f"kernel launches in {counts[word]} calls, {per} a call "
                  f"planned")
        runs[mode] = (res, counts)
        del eng
    a, b = runs["fused"][0], runs["per-op"][0]
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    print(f"[{label}] fused vs per-op decode, free-running: {same}/256 "
          f"generated tokens agree ({same / 256:.3f})")
    return runs["fused"][1]


# ---------------------------------------------------------------------------
# Speculative serving: the DRAFT word and the draft / verify / rollback loop
# ---------------------------------------------------------------------------

# the verifies whose arena is held bit for bit (a copy of the whole
# arena before each)
ARENA_CHECKS = 2


def _first(tree, n: int):
    """The first n layers of a stacked parameter subtree (views)."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def cut_model(cfg, params, layers: int) -> tuple:
    """(cfg, params) of the first `layers` layers of a model: the first
    layers / period scan groups of every stacked leaf (views)."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    ng = layers // len(tfm.layer_pattern(cfg))
    return dataclasses.replace(cfg, n_layers=layers), dict(params, groups={
        u: {k: _first(v, ng) for k, v in up.items()}
        for u, up in params["groups"].items()})


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _spec_spy(eng, counters: dict) -> tuple:
    """Wrap a speculative engine's chunk calls: each counter's launches by
    (kind, chunk rows) — kind "verify", "replay" or "prefill" — and, for
    the first ARENA_CHECKS verifies, the whole arena held bit for bit
    across the call.  Returns (histogram, state)."""
    import torch
    hist, state = {}, {"checked": 0}
    verify, chunk, replay = eng._verify, eng._chunk, eng._replay

    def count(kind, fn, tokens, *a):
        n0 = {k: c.n for k, c in counters.items()}
        out = fn(tokens, *a)
        d = hist.setdefault((kind, len(tokens)),
                            dict.fromkeys(["calls", *counters], 0))
        d["calls"] += 1
        for k, c in counters.items():
            d[k] += c.n - n0[k]
        return out

    def spy_verify(tokens, pos0, slot):
        before = None
        if state["checked"] < ARENA_CHECKS:
            before = [t.clone() for t in _tensors(eng.cache)]
        out = count("verify", verify, tokens, pos0, slot)
        if before is not None:
            same = all(torch.equal(a, b)
                       for a, b in zip(_tensors(eng.cache), before))
            check(same, f"a verify of {len(tokens)} rows at slot {slot} "
                  f"changed the arena")
            state["checked"] += 1
        return out

    eng._verify = spy_verify
    eng._chunk = functools.partial(count, "prefill", chunk)
    eng._replay = functools.partial(count, "replay", replay)
    return hist, state


def _hist_txt(hist: dict, key: str) -> str:
    """'verify M=4: n (calls c), ...' of one counter, by kind and rows."""
    parts = [f"{kind} M={m}: {d[key]} ({d['calls']} calls)"
             for (kind, m), d in sorted(hist.items()) if d[key]]
    return ", ".join(parts) or "none"


def _serve_once(eng, trace) -> tuple:
    """(tokens by request, wall seconds) of one engine run."""
    import torch
    t0 = time.monotonic()
    with torch.no_grad():
        res = eng.run(trace)
    torch.cuda.synchronize()
    return res, time.monotonic() - t0


def _check_served(res, trace, eng, label: str) -> None:
    """Every request got exactly its budget; no logit was inf / NaN."""
    got = {r.rid: len(res.get(r.rid, ())) for r in trace}
    check(all(got[r.rid] == r.max_new_tokens for r in trace),
          f"{label}: tokens per request {got}, want each its max_new_tokens")
    check(eng.nonfinite_logits == 0,
          f"{label}: {eng.nonfinite_logits} non-finite logits")


def _agree(res, want) -> tuple:
    """(tokens equal position for position, first tokens equal, tokens)."""
    same = sum(x == y for r in want for x, y in zip(res[r], want[r]))
    first = sum(res[r][0] == want[r][0] for r in want)
    return same, first, sum(len(v) for v in want.values())


def phase_serve_spec(cfg, params, label: str, modes=(True,)) -> dict:
    """The speculative main path at BURSTY_LAYERS layers (the first of
    `params`): the seeded trace served on the cuda backend with k =
    SPEC_K and the default draft (one layer, its own seed), fused decode
    (and per-op where `modes` asks), counting each kernel's launches in
    each run and by chunk kind and rows.  Before each, the same trace
    without speculation at the same depth and mode: every first token
    must equal its (both produce it on the same path), and the number of
    equal tokens is printed.  The first ARENA_CHECKS verifies must leave
    the arena bit-identical.  Returns the first run's counts and
    histogram."""
    from repro_torch.serving import build_engine, latency_stats
    cfg, params = cut_model(cfg, params, BURSTY_LAYERS)
    trace = serve_trace(cfg)
    counters = serve_counters(cfg)
    out = None
    for fused in modes:
        mode = "fused" if fused else "per-op"
        tag = f"{label}:{mode}"
        t0 = time.monotonic()
        eng = build_engine(cfg, n_slots=SERVE_SLOTS, max_len=SERVE_LEN,
                           prefill_chunk=32, kernel_backend="cuda",
                           fused_decode=fused, device="cuda", params=params)
        base, base_wall = _serve_once(eng, trace)
        _check_served(base, trace, eng, f"{tag}:non-speculative")
        st = latency_stats(eng.events)
        print(f"[{tag}:non-speculative] {cfg.n_layers} layers: steps="
              f"{eng.step_count} wall={base_wall:.3f}s tok/s="
              f"{st['tokens'] / base_wall:.2f} p50={st['p50_ms']:.3f}ms "
              f"p99={st['p99_ms']:.3f}ms")
        del eng
        eng = build_engine(cfg, n_slots=SERVE_SLOTS, max_len=SERVE_LEN,
                           prefill_chunk=32, kernel_backend="cuda",
                           fused_decode=fused, device="cuda", params=params,
                           speculative=SPEC_K)
        hist, state = _spec_spy(eng, counters)
        for c in counters.values():
            c.reset()
        res, wall = _serve_once(eng, trace)
        counts = {k: c.n for k, c in counters.items()}
        st = latency_stats(eng.events)
        sp = eng.spec_stats
        same, first, n = _agree(res, base)
        print(f"[{tag}] {cfg.n_layers} layers, k={SPEC_K} steps="
              f"{eng.step_count} generated="
              f"{st['tokens']} wall={wall:.3f}s tok/s="
              f"{st['tokens'] / wall:.2f} p50={st['p50_ms']:.3f}ms "
              f"p99={st['p99_ms']:.3f}ms verifies={sp['verifies']} "
              f"accepted={sp['accepted']} "
              f"({sp['accepted'] / max(1, sp['verifies']):.3f} accepted/"
              f"verify); against the non-speculative {mode} run: {same}/{n}"
              f" tokens, first tokens {first}/{len(trace)}; launches="
              f"{counts} nonfinite_logits={eng.nonfinite_logits}")
        bat = ["sr_matmul:batched"] if "sr_matmul:batched" in counts else []
        for key in ["sr_matmul", *bat] + (["wkv6"] if "wkv6" in counts
                                          else []):
            print(f"[{tag}] {key} launches by chunk: "
                  f"{_hist_txt(hist, key)}")
        _check_served(res, trace, eng, tag)
        check(sp["verifies"] > 0, f"{tag}: no verify")
        check(first == len(trace), f"{tag}: {first}/{len(trace)} first "
              f"tokens equal the non-speculative run's")
        check(state["checked"] >= 1, f"{tag}: no verify held the arena")
        for k, c in counts.items():
            want = (k != "sr_matmul:generic"
                    and (fused or k.split(":")[0] not in (
                        "fused_ffn", "fused_attn_unit")))
            check((c > 0) == want, f"{tag} launched {k} {c} times")
        for word, per in launches_per_call(cfg).items():
            check(counts[f"{word}:launches"] == per * counts[word],
                  f"{tag}: {counts[f'{word}:launches']} {word} kernel "
                  f"launches in {counts[word]} calls, {per} a call planned")
        print(f"[{tag}] held: every budget exact, every first token, "
              f"{state['checked']} verifies left the arena bit-identical; "
              f"phase {time.monotonic() - t0:.1f}s")
        if out is None:
            out = {"counts": counts, "hist": hist, "tok_s": st["tokens"] / wall,
                   "accepted_per_verify": sp["accepted"] / sp["verifies"]}
        del eng
    return out


def phase_spec_self_draft(cfg, params, label: str) -> None:
    """The full-acceptance oracle at full width: the draft is the big
    model with the same parameters (fused decode for the big model; the
    DRAFT word is the per-op f32 matvec, the verify the bf16 sr_matmul
    chunk, so near-ties may rank differently).  4 requests of 16-32
    prompt tokens (each prompt token is a 24-layer DRAFT step first).
    Prints accepted per verify beside the teacher-forced argmax agreement
    of the DRAFT step and the verify chunk on one 40-token stream; only
    the budgets and finite logits are gated."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    from repro_torch.serving import build_engine, latency_stats, poisson_trace
    t0 = time.monotonic()
    trace = poisson_trace(4, vocab_size=cfg.vocab_size, prompt_lens=(16, 32),
                          gen_tokens=16, mean_interarrival_steps=2.0, seed=0)
    eng = build_engine(cfg, n_slots=SERVE_SLOTS, max_len=SERVE_LEN,
                       prefill_chunk=32, kernel_backend="cuda",
                       fused_decode=True, device="cuda", params=params,
                       speculative=SPEC_K, draft_cfg=cfg, draft_params=params)
    res, wall = _serve_once(eng, trace)
    _check_served(res, trace, eng, label)
    sp = eng.spec_stats
    del eng
    L = 40
    gen = torch.Generator(device="cuda").manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (1, L), generator=gen,
                         device="cuda", dtype=torch.int32)
    prog = compile_program(cfg, ShapeConfig("tf", L, 1, "decode"),
                           speculative=True)
    draft = tl.make_draft_step(cfg, prog, kernel_backend="cuda")
    chunk = tl.make_chunk_step(cfg, prog, kernel_backend="cuda")
    dc, cc = tfm.init_cache(cfg, 1, L, device="cuda"), \
        tfm.init_cache(cfg, 1, L, device="cuda")
    with torch.no_grad():
        a = torch.cat([draft(params, dc, toks[:, t:t + 1],
                             torch.tensor([t], dtype=torch.int32,
                                          device="cuda"))[0][0].argmax(-1)
                       for t in range(L)])
        b = torch.cat([chunk(params, cc, toks[:, c:c + SPEC_K],
                             torch.tensor([c], dtype=torch.int32,
                                          device="cuda"))[0][0].argmax(-1)
                       for c in range(0, L, SPEC_K)])
    agree = int((a == b).sum())
    print(f"[{label}] self-draft (the big model, same parameters), k="
          f"{SPEC_K}, 4 requests of 16-32 prompt tokens: verifies="
          f"{sp['verifies']} accepted={sp['accepted']} "
          f"({sp['accepted'] / max(1, sp['verifies']):.3f} accepted/verify; "
          f"all accepted would be {sum(r.max_new_tokens - 1 for r in trace)})"
          f"; teacher-forced DRAFT step vs verify chunk argmax on one "
          f"{L}-token stream: {agree}/{L}; serve wall {wall:.3f}s, phase "
          f"{time.monotonic() - t0:.1f}s (not gated)")


SPEC_REF_LAYERS = 4


def phase_spec_reference(arch: str, gen, label: str) -> None:
    """The speculative loop on the port's reference backend on the card
    (float64 products, no kernel), SPEC_REF_LAYERS layers at full width:
    the speculative tokens equal the non-speculative ones request for
    request, with the default draft and with a self-draft, which accepts
    every proposal."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    from repro_torch.serving import build_engine, poisson_trace
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config(arch), n_layers=SPEC_REF_LAYERS)
    params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
    trace = poisson_trace(4, vocab_size=cfg.vocab_size, prompt_lens=(16, 48),
                          gen_tokens=8, mean_interarrival_steps=2.0, seed=0)
    kw = dict(n_slots=SERVE_SLOTS, max_len=SERVE_LEN, prefill_chunk=32,
              kernel_backend="reference", device="cuda", params=params)
    runs = {}
    for name, spec in (("non-speculative", {}),
                       ("draft", dict(speculative=SPEC_K)),
                       ("self-draft", dict(speculative=SPEC_K, draft_cfg=cfg,
                                           draft_params=params))):
        eng = build_engine(cfg, **kw, **spec)
        res, wall = _serve_once(eng, trace)
        _check_served(res, trace, eng, f"{label}:{name}")
        runs[name] = (res, dict(eng.spec_stats), wall)
        del eng
    want = runs["non-speculative"][0]
    all_in = sum(r.max_new_tokens - 1 for r in trace)
    txt = "; ".join(f"{name} {w:.2f}s verifies={s['verifies']} accepted="
                    f"{s['accepted']}" for name, (_, s, w) in runs.items())
    print(f"[{label}] {arch}, {SPEC_REF_LAYERS} layers at full width, "
          f"reference backend, 4 requests: {txt}; phase "
          f"{time.monotonic() - t0:.1f}s")
    for name in ("draft", "self-draft"):
        check(runs[name][0] == want, f"{label}: {arch} {name} tokens differ "
              f"from the non-speculative run's")
        check(runs[name][1]["verifies"] > 0, f"{label}: {name}: no verify")
    check(runs["self-draft"][1]["accepted"] == all_in,
          f"{label}: {arch} self-draft accepted "
          f"{runs['self-draft'][1]['accepted']}, want {all_in}")
    del params
    torch.cuda.empty_cache()


# the depth of the speculative runs: the bursty overload's 64 requests
# make ~960 speculative rounds, each two chunks through every layer (at
# full depth 152 s), and the four speculative runs of the served trace
# took 57-105 s each at 24 layers on a slow host; the runs without
# speculation are served at full depth too
BURSTY_LAYERS = 8


def phase_bursty(cfg, params, label: str) -> None:
    """Overload: one burst of 2 x SERVE_SLOTS requests (prompts of 16-128
    tokens, 16 new tokens) on the fused engine with evict_patience 4:
    without speculation at full depth, then without and with speculation
    at BURSTY_LAYERS layers (the first layers of `params`).  Every request
    finishes with its budget and something was evicted in each run; the
    speculative run's first tokens equal those of the run without it at
    its depth."""
    from repro_torch.serving import build_engine, bursty_trace, latency_stats
    t0 = time.monotonic()
    cut, cut_params = cut_model(cfg, params, BURSTY_LAYERS)
    trace = bursty_trace(2 * SERVE_SLOTS, vocab_size=cfg.vocab_size,
                         prompt_lens=(16, 128), gen_tokens=16,
                         burst_size=2 * SERVE_SLOTS, burst_gap_steps=8,
                         seed=0)
    counters = serve_counters(cfg)
    runs = {}
    for c_cfg, c_params, k in ((cfg, params, 0), (cut, cut_params, 0),
                               (cut, cut_params, SPEC_K)):
        tag = (f"{label}:{c_cfg.n_layers}L:"
               f"{'k=' + str(k) if k else 'non-speculative'}")
        eng = build_engine(c_cfg, n_slots=SERVE_SLOTS, max_len=SERVE_LEN,
                           prefill_chunk=32, kernel_backend="cuda",
                           fused_decode=True, device="cuda", params=c_params,
                           evict_patience=4, speculative=k)
        for c in counters.values():
            c.reset()
        res, wall = _serve_once(eng, trace)
        counts = {n: c.n for n, c in counters.items()}
        st = latency_stats(eng.events)
        ev = sum(s.evictions for s in eng.sched.finished.values())
        sp = eng.spec_stats
        print(f"[{tag}] {len(trace)} requests in one burst, "
              f"{SERVE_SLOTS} slots, {c_cfg.n_layers} layers, evict_patience "
              f"4: steps="
              f"{eng.step_count} generated={st['tokens']} wall={wall:.3f}s "
              f"tok/s={st['tokens'] / wall:.2f} p50={st['p50_ms']:.3f}ms "
              f"p99={st['p99_ms']:.3f}ms evictions={ev} verifies="
              f"{sp['verifies']} accepted={sp['accepted']} launches={counts}")
        _check_served(res, trace, eng, tag)
        check(ev > 0, f"{tag}: nothing was evicted")
        check(counts["sr_matmul:generic"] == 0 and counts["sr_matmul"] > 0,
              f"{tag}: sr_matmul launches {counts}")
        if k:
            check(sp["verifies"] > 0, f"{tag}: no verify")
        runs[(c_cfg.n_layers, k)] = res
        del eng
    same, first, n = _agree(runs[(BURSTY_LAYERS, SPEC_K)],
                            runs[(BURSTY_LAYERS, 0)])
    print(f"[{label}] {BURSTY_LAYERS} layers, speculative vs "
          f"non-speculative: {same}/{n} tokens, first tokens "
          f"{first}/{len(trace)}; phase {time.monotonic() - t0:.1f}s")
    check(first == len(trace), f"{label}: {first}/{len(trace)} first tokens "
          f"equal")


def _f32_tree(tree):
    """Every bf16 leaf of a nested dict as f32 (new tensors)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.dtype.is_floating_point else tree.clone()


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _gap(a, b) -> tuple:
    """(max |a - b| / std(b), argmax agreement count) of two steps'
    (rows, 1, V) logits."""
    d = float((a - b).abs().max() / b.std())
    agree = int((a.argmax(-1) == b.argmax(-1)).sum())
    return d, agree


def phase_fused_vs_perop(cfg, params, label: str, prompt: int = 32) -> dict:
    """Teacher-forced: 32 rows prefill `prompt` random tokens each (in
    32-token chunks), then fused and per-op decode run the same 8 tokens
    per row.
    Per step: max |logit difference| over rows and vocabulary in units of
    the per-op logits' std, and the argmax agreement (256 in all).  Each
    bf16 path is also held against an f32 truth: the per-op words with f32
    weights, activations and caches.  A fault in the fused word shows as
    a fused path farther from the truth than the per-op path.  A MoE
    config has no such truth (the batched expert word takes bf16 only):
    fused against per-op alone, the fused run with the per-op run's
    routing (a token whose top-k set flips would hide the fused word's
    error behind another expert's)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    B, P, N, C = 32, prompt, 8, 32
    gen = torch.Generator(device="cuda").manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, P + N), generator=gen,
                         device="cuda", dtype=torch.int32)
    shape = ShapeConfig("tf", P + N, B, "decode")
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")

    def run(prog, prms, cache, fused):
        chunk = tl.make_chunk_step(cfg, prog, kernel_backend="cuda")
        step = (tl.make_fused_decode_step if fused else tl.make_decode_step)(
            cfg, prog, kernel_backend="cuda")
        out = []
        with torch.no_grad():
            for c0 in range(0, P, C):
                chunk(prms, cache, toks[:, c0:min(c0 + C, P)], zeros + c0)
            for t in range(N):
                lg, _ = step(prms, cache, toks[:, P + t:P + t + 1],
                             torch.full((B,), P + t, dtype=torch.int32,
                                        device="cuda"))
                out.append(lg.float())
        return out

    cache = tfm.init_cache(cfg, B, P + N, device="cuda")
    moe = cfg.moe is not None
    routes, flips = [], []
    with _routing(routes if moe else None):
        per_op = run(compile_program(cfg, shape), params, _clone_tree(cache),
                     False)
    with _routing(flips if moe else None, routes if moe else None):
        fused = run(compile_program(cfg, shape, fused_decode=True), params,
                    _clone_tree(cache), True)
    if moe:
        print(f"[{label}] teacher-forced fused decode with the per-op run's "
              f"routing: its own top-k set differs on {_flips(flips)} "
              f"token-layers (prompt and 8 steps)")
    pairs = [("fused-vs-per-op", fused, per_op)]
    truth = []
    if cfg.moe is None:
        truth = run(compile_program(cfg, shape, precision="fp32"),
                    _f32_tree(params), _f32_tree(cache), False)
        pairs += [("per-op-vs-f32", per_op, truth),
                  ("fused-vs-f32", fused, truth)]
    res = {}
    for name, a, b in pairs:
        gaps = [_gap(x, y) for x, y in zip(a, b)]
        ds = sorted(g[0] for g in gaps)
        res[name] = {"median": ds[len(ds) // 2], "max": ds[-1],
                     "agree": sum(g[1] for g in gaps)}
        print(f"[{label}] teacher-forced, {P}-token prompts, {name}: max "
              f"|dlogit| / std median "
              f"{res[name]['median']:.4f} max {res[name]['max']:.4f}; argmax "
              f"agree {res[name]['agree']}/{B * N}")
    check(all(torch.isfinite(x).all() for x in fused + per_op + truth),
          f"{label}: non-finite teacher-forced logits")
    return res


# The fused-versus-per-op gates.  A fused decode path with a fault lands
# farther from the f32 truth than the per-op path does: held within
# ACCURACY_RATIO of the per-op path's distance (max over the 8 steps),
# and per layer, fused_ffn's error against the f32 FF within
# FFN_LAYER_RATIO of the per-op FF's.  The fused-vs-per-op gaps
# themselves are held just above what the card gave (PERF.md): every
# kernel and torch call here is deterministic, so a run repeats them.
ACCURACY_RATIO = 1.1
FFN_LAYER_RATIO = 1.1
# (granite's and jamba's with routing held fixed; the served configs'
# limits are the card's gap x 1.1, rounded up to 0.01; jamba's are its
# per-op and fused decode steps against the reference backend, ":ring"
# with the window cut to 64)
TF_MAX = {"qwen2-0.5b": 0.1, "rwkv6-1.6b": 0.5, "rwkv6-1.6b:512": 0.6,
          "granite-moe-1b-a400m": 0.06, "olmo-1b": 0.1, "minitron-4b": 0.13,
          "jamba-v0.1-52b": 0.13, "jamba-v0.1-52b:ring": 0.13}
# one PREFILL chunk, cuda against reference backend (granite, jamba,
# arctic: routing held fixed), the card's gap x 1.1 rounded up to 0.01
# (PERF.md); jamba's ":ring" the largest of a 150-token prompt's chunks;
# arctic's the largest over ARCTIC_SEEDS
CHUNK_MAX = {"granite-moe-1b-a400m": 0.09, "olmo-1b": 0.1,
             "minitron-4b": 0.14, "jamba-v0.1-52b": 0.12,
             "jamba-v0.1-52b:ring": 0.13, "arctic-480b": 0.05}


def check_fused_vs_perop(tf: dict, worst_layer: float = None) -> None:
    """tf: {arch: phase_fused_vs_perop's result}; worst_layer:
    phase_ffn_bisect's, where it ran."""
    for arch, res in tf.items():
        if "fused-vs-f32" in res:
            fused = res["fused-vs-f32"]["max"]
            per_op = res["per-op-vs-f32"]["max"]
            check(fused <= ACCURACY_RATIO * per_op,
                  f"{arch}: fused decode is {fused:.4f} std from the f32 "
                  f"truth, the per-op decode {per_op:.4f} (gate: "
                  f"{ACCURACY_RATIO}x)")
        gap = res["fused-vs-per-op"]["max"]
        check(gap <= TF_MAX[arch], f"{arch} fused vs per-op decode: max "
              f"|dlogit| {gap:.4f} std (gate {TF_MAX[arch]})")
    if worst_layer is not None:
        check(worst_layer <= FFN_LAYER_RATIO,
              f"fused_ffn's error against the f32 FF is {worst_layer:.4f}x "
              f"the per-op FF's (gate {FFN_LAYER_RATIO}x)")


def phase_ffn_bisect(cfg, params) -> float:
    """rwkv6, layer by layer at one decode step of 32 rows: the fused_ffn
    kernel and the per-op FF words on the same input (the per-op path's
    residual after each mixer), each against the same FF in f32 (the
    plain version on f32 operands).  Returns the worst layer's ratio of
    the fused error to the per-op error (max |y - y_f32| each)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.phases import Phase
    from repro_torch.core.program import compile_program
    from repro_torch.engine.context import PEContext
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_norm, embed, mlp
    from repro_torch.models.ssm import rwkv_block
    B = 32
    prog = compile_program(cfg, ShapeConfig("bisect", 8, B, "decode"))
    sh = PEContext(prog, backend="cuda", phase=Phase.DECODE)
    gen = torch.Generator(device="cuda").manual_seed(10)
    cache = tfm.init_cache(cfg, B, 8, device="cuda")
    for leaf in (cache["u0"]["rwkv"]["wkv"], cache["u0"]["rwkv"]["shift"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device="cuda")
    x = embed(tok, params["embed"]["table"]).bfloat16()
    ratios, rows = [], []
    tn = kdf._clip_block_n(256, cfg.d_ff)
    with torch.no_grad():
        for g in range(cfg.n_layers):
            up = {k: {n: t[g] for n, t in v.items()}
                  for k, v in params["groups"]["u0"].items()}
            st = {k: v[g] for k, v in cache["u0"]["rwkv"].items()}
            n2, ff = up["norm2"], up["ffn"]
            h = apply_norm(cfg, x, up["norm1"])
            x = x + rwkv_block(cfg, h, up["rwkv"], sh, st)
            y_op = x + mlp(cfg, apply_norm(cfg, x, n2), ff["ffn_in"],
                           ff["ffn_out"], sh)
            y_fu = kdf.fused_ffn(x[:, 0].contiguous(), norm2_scale=n2["scale"],
                                 norm2_bias=n2["bias"], w_in=ff["ffn_in"],
                                 w_out=ff["ffn_out"], norm_kind=cfg.norm,
                                 act=cfg.act)
            y32 = kdf.fused_ffn_plain(
                x[:, 0].float(), n2s=n2["scale"].float(),
                n2b=n2["bias"].float(), w_in=ff["ffn_in"].float(),
                w_out=ff["ffn_out"].float(), norm_kind=cfg.norm, act=cfg.act,
                tn=tn)
            e_fu = float((y_fu.float() - y32).abs().max())
            e_op = float((y_op[:, 0].float() - y32).abs().max())
            ratios.append(e_fu / max(e_op, 1e-30))
            rows.append((float(x.float().std()),
                         float((y32 - x[:, 0].float()).std()), e_fu, e_op))
            x = y_op
    i = max(range(len(ratios)), key=ratios.__getitem__)
    print(f"[ffn_bisect] fused_ffn and per-op FF against the f32 FF on the "
          f"same input, per layer: fused error / per-op error median "
          f"{sorted(ratios)[len(ratios) // 2]:.4f}, worst {ratios[i]:.4f} "
          f"(layer {i})")
    for g in (0, len(rows) // 2, len(rows) - 1):
        xs, ds, ef, eo = rows[g]
        print(f"[ffn_bisect] layer {g}: residual std {xs:.4g}, FF delta std "
              f"{ds:.4g}, max |error| fused {ef:.4g} per-op {eo:.4g}")
    return ratios[i]


def _counters() -> dict:
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import selective_scan as kss
    from repro_torch.kernels import sr_matmul as kmm
    from repro_torch.kernels import sr_round as ksr
    from repro_torch.kernels import wkv6 as kwkv
    return {"sr_matmul": kmm.COUNTER, "outer_accum": koa.COUNTER,
            "sr_round": ksr.COUNTER, "fused_attn_unit": kdf.COUNTER,
            "wkv6": kwkv.COUNTER, "wkv6_bwd": kwkv.BWD_COUNTER,
            "selective_scan": kss.COUNTER,
            "selective_scan_bwd": kss.BWD_COUNTER,
            "sr_matmul:batched": kmm.BATCHED_COUNTER,
            "outer_accum:batched": koa.BATCHED_COUNTER,
            **{f"{mod}:{p}": c.PATH_COUNTERS[p]
               for mod, c in (("sr_matmul", kmm), ("outer_accum", koa))
               for p in kmm.PATHS}}


def _step0_grads(cfg, program, backend, params, batch, dtype,
                 remat: str = "block", f32: bool = True) -> tuple:
    """(loss, {leaf path: gradient}) of one forward and backward of the
    training loss (remat block unless `remat` says) on `backend`, as the
    training step takes them; each gradient cast to f32 unless `f32` is
    False (the training step hands the optimizer the params' dtype)."""
    import torch
    from repro_torch.core.phases import Phase
    from repro_torch.core.rounding import fold_key
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.engine.context import PEContext
    from repro_torch.models import transformer as tfm
    sh = PEContext(program, backend=backend, phase=Phase.FF)
    if backend == "cuda":
        sh = sh.with_key(fold_key(0, 1))
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(req)
    with torch.enable_grad():
        loss = tfm.loss_fn(cfg, req, batch, sh, compute_dtype=dtype,
                           remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return float(loss.detach()), {
        path: g.float() if f32 else g for (path, _), g in zip(leaves, grads)}


def _grad_rel(got: dict, want: dict) -> tuple:
    """(worst leaf, its max |got - want| / max |want|)."""
    rel = {k: float((got[k] - want[k]).abs().max()
                    / want[k].abs().max().clamp_min(1e-30)) for k in want}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def phase_train_fp32(cfg) -> None:
    """Four full-width layers, fp32, adamw, remat block: the cuda backend
    (f32 sr_matmul / outer_accum) against the reference backend
    (f64-accumulated plain torch), TF32 off, one initial state.  Per-leaf
    gradients of step 0, then two steps' losses and the gradient norm.
    A control with bf16 operands on the cuda backend must fail the
    gradient gate, so the gate is known to see a wrong BP or UP path."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    shape = ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train")
    program = compile_program(cfg4, shape, precision="fp32")
    pipe = SyntheticLM(cfg4, shape)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in pipe.batch_at(0).items()}
    losses, gnorms, grads = {}, {}, {}
    state0 = None
    for backend in ("reference", "cuda"):
        train = TrainConfig(precision="fp32", kernel_backend=backend,
                            remat="block")
        step_fn, opt = tl.make_train_step(cfg4, program, train)
        if state0 is None:
            state0 = tl.init_state(cfg4, program, train, gen, opt)
        t0 = time.monotonic()
        _, grads[backend] = _step0_grads(cfg4, program, backend,
                                         state0["params"], batch0,
                                         torch.float32)
        state, out = state0, []
        for s in range(2):
            state, met = step_fn(state, pipe.batch_at(s), s)
            out.append(float(met["loss"]))
            if s == 0:
                gnorms[backend] = float(met["grad_norm"])
        losses[backend] = out
        print(f"[train:fp32] {backend:<9} 4 layers B={TRAIN_B} S={TRAIN_S}: "
              f"losses {out} step-0 grad norm {gnorms[backend]!r} "
              f"({time.monotonic() - t0:.1f}s)")
        del state
    ref = grads["reference"]
    leaf, rel = _grad_rel(grads["cuda"], ref)
    # the control: the same state and batch through bf16 operands
    ctrl_prog = compile_program(cfg4, shape, precision="bf16_nearest")
    _, ctrl = _step0_grads(cfg4, ctrl_prog, "cuda", state0["params"],
                           batch0, torch.bfloat16)
    c_leaf, c_rel = _grad_rel(ctrl, ref)
    g_rel = abs(gnorms["cuda"] / gnorms["reference"] - 1)
    print(f"[train:fp32] cuda vs reference: step 1 rel "
          f"{abs(losses['cuda'][0] / losses['reference'][0] - 1):.3g}, "
          f"step 2 rel {abs(losses['cuda'][1] / losses['reference'][1] - 1):.3g}"
          f", grad norm rel {g_rel:.3g}, worst leaf gradient rel {rel:.3g} "
          f"({leaf}); control with bf16 operands: worst leaf rel "
          f"{c_rel:.3g} ({c_leaf})")
    for s, tol in enumerate(TRAIN_RTOL):
        r, c = losses["reference"][s], losses["cuda"][s]
        check(abs(c - r) <= tol * abs(r),
              f"fp32 training step {s + 1}: cuda loss {c} vs reference {r} "
              f"(rtol {tol})")
    check(g_rel <= GNORM_RTOL,
          f"fp32 step-0 gradient norm: cuda {gnorms['cuda']} vs reference "
          f"{gnorms['reference']} (rtol {GNORM_RTOL})")
    check(rel < GRAD_REL, f"fp32 step-0 gradient of {leaf}: rel {rel:.3g} "
          f"(gate {GRAD_REL})")
    check(c_rel >= GRAD_REL, f"the gradient gate ({GRAD_REL}) passes the "
          f"bf16-operand control (worst rel {c_rel:.3g}): it cannot see a "
          f"lower-precision gradient")


def phase_train(arch: str = "qwen2-0.5b", label: str = "train",
                per_step_exact: dict = None, ckpt_every: int = 1000,
                lr: float = None) -> dict:
    """The training main path: launch.train at full width (cut to fit the
    card where the model does not), paper_sr_bf16, counting each
    kernel's launches per step; ``per_step_exact`` {kernel: launches}
    also holds those kernels to exact counts in every step.
    ``ckpt_every`` 0 writes no checkpoint, not even the final one;
    ``lr`` replaces the CLI's default learning rate."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train as launch_train
    per_step_exact = per_step_exact or {}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    args = launch_train.parser().parse_args([
        "--arch", arch, "--kernel-backend", "cuda", "--device",
        "cuda", "--precision", "paper_sr_bf16", "--optimizer", "adamw",
        "--remat", "block", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
        "--steps", "8", "--log-every", "1", "--ckpt-every", str(ckpt_every),
        "--ckpt-dir", ckpt_dir] + (["--lr", str(lr)] if lr else []))
    counters = _counters()
    per_step = []
    last = {}

    def on_step(step, metrics, dt):
        now = {k: c.n for k, c in counters.items()}
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    try:
        res = launch_train.run(args, on_step=on_step)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.monotonic() - t0
    totals = {k: c.n for k, c in counters.items()}
    losses, secs = res["losses"], res["seconds"]
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    tok = TRAIN_B * TRAIN_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    tcfg = res["cfg"]
    experts = (f", {tcfg.moe.n_experts} experts top-{tcfg.moe.top_k}"
               if tcfg.moe is not None else "")
    print(f"[{label}] {arch} {tcfg.n_layers} layers{experts} "
          f"({tcfg.param_count()} params) paper_sr_bf16 adamw remat=block "
          f"B={TRAIN_B} S={TRAIN_S}: losses {[round(x, 4) for x in losses]}")
    print(f"[{label}] ms/step {[round(x * 1e3, 1) for x in secs]} median "
          f"(steps 1-7) {med * 1e3:.1f}ms, {tok / med:.1f} tokens/s; "
          f"wall {wall:.1f}s incl. init"
          f"{' and final checkpoint' if ckpt_every else ''}; peak memory "
          f"{peak:.2f} GiB, {peak - held0:.2f} above the {held0:.2f} GiB "
          f"that earlier phases still held")
    print(f"[{label}] launches per step {per_step[-1]}; in the run {totals}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(len(losses) == 8, f"{len(losses)} training steps, want 8")
    check(losses[-1] < losses[0],
          f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for k in ("sr_matmul", "outer_accum", "sr_round", "sr_matmul:sm90",
              "outer_accum:sm90", *per_step_exact):
        check(all(p[k] > 0 for p in per_step),
              f"a training step launched {k} no time: {per_step}")
    for k, n in per_step_exact.items():
        check(all(p[k] == n for p in per_step),
              f"a training step launched {k} other than {n} times: "
              f"{[p[k] for p in per_step]}")
    zero = ("sr_matmul:generic", "outer_accum:generic", "sr_matmul:f32",
            "outer_accum:f32")
    if not any(k.endswith(":batched") for k in per_step_exact):
        zero += ("sr_matmul:batched", "outer_accum:batched")
    for k in zero:
        check(totals[k] == 0, f"the training run launched {k} {totals[k]} "
              f"times (every bf16 product belongs on the sm90 path, and "
              f"no dense model has an expert table)")
    return {"counts": totals, "per_step": per_step[-1],
            "ms_per_step": med * 1e3, "tokens_per_s": tok / med,
            "peak_gib": peak, "held_gib": held0}


def phase_train_fp32_full(arch: str = "qwen2-0.5b",
                          label: str = "train:fp32:full",
                          per_step_exact: dict = None) -> dict:
    """The fp32 preset's main path at full width: launch.train, all 24
    layers of `arch`, adamw, remat block, B=4, S=256, 3 steps on the
    cuda backend — every FF and BP through sr_matmul's f32 path, every
    UP through outer_accum's, none on a bf16 path; ``per_step_exact``
    {kernel: launches} also holds those kernels to exact counts in every
    step.  ms/step is the median of steps 2-3."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train as launch_train
    per_step_exact = per_step_exact or {}
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_fp32_")
    args = launch_train.parser().parse_args([
        "--arch", arch, "--kernel-backend", "cuda", "--device",
        "cuda", "--precision", "fp32", "--optimizer", "adamw", "--remat",
        "block", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
        "3", "--log-every", "1", "--ckpt-every", "1000", "--ckpt-dir",
        ckpt_dir])
    counters = _counters()
    per_step, last = [], {}

    def on_step(step, metrics, dt):
        now = {k: c.n for k, c in counters.items()}
        per_step.append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    try:
        res = launch_train.run(args, on_step=on_step)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.monotonic() - t0
    counts = {k: c.n for k, c in counters.items()}
    losses, secs = res["losses"], res["seconds"]
    check(len(losses) == 3, f"{len(losses)} fp32 training steps, want 3")
    med = (secs[1] + secs[2]) / 2       # the median of steps 2 and 3
    tok = TRAIN_B * TRAIN_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] {arch} 24 layers fp32 adamw remat=block "
          f"B={TRAIN_B} S={TRAIN_S}: losses {losses}")
    print(f"[{label}] ms/step {[round(x * 1e3, 1) for x in secs]} "
          f"median (steps 2-3) {med * 1e3:.1f}ms, {tok / med:.1f} tokens/s; "
          f"wall {wall:.1f}s incl. init and final checkpoint; peak memory "
          f"{peak:.2f} GiB, {peak - held0:.2f} above the {held0:.2f} GiB "
          f"that earlier phases still held")
    if per_step_exact:
        print(f"[{label}] launches per step "
              f"{ {k: v for k, v in per_step[-1].items() if v} }")
    print(f"[{label}] launches in the run {counts}")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    check(losses[2] < losses[0],
          f"{label}: loss did not fall: {losses[0]} -> {losses[2]}")
    for k in ("sr_matmul", "outer_accum", "sr_matmul:f32",
              "outer_accum:f32"):
        check(counts[k] > 0, f"the {label} run launched {k} no time")
    for k in ("sr_matmul", "outer_accum"):
        check(counts[f"{k}:f32"] == counts[k] and counts[f"{k}:sm90"] == 0
              and counts[f"{k}:generic"] == 0,
              f"the {label} run launched {k} off the f32 path: {counts}")
    for k, n in per_step_exact.items():
        check(len(per_step) == 3 and all(p[k] == n for p in per_step),
              f"a {label} step launched {k} other than {n} times: "
              f"{[p[k] for p in per_step]}")
    return {"counts": counts, "per_step": per_step[-1],
            "ms_per_step": med * 1e3, "tokens_per_s": tok / med,
            "peak_gib": peak}


# ---------------------------------------------------------------------------
# [paper]: the paper's own networks at full width
# ---------------------------------------------------------------------------

# (net, batch, SGD lr): AlexNet at 227^2 and VGG-16 at 224^2 (the paper's
# inputs), MLP0, GRU0 (T=64) and the captioning CNN -> GRU (T=100); the
# batches fit the captioning GRU's f32 weights (6.8 GB), their gradients
# and its (43264, 30000) dW a time step on one card
PAPER_RUNS = (("paper-alexnet", 128, 1e-3), ("paper-vgg16", 32, 1e-3),
              ("paper-mlp0", 256, 5e-2), ("paper-gru", 32, 0.5),
              ("paper-captioning-gru", 8, 0.1))
PAPER_STEPS = 4
# the step-0 gradient check runs the reference backend's products in
# f64, whose autograd keeps an f64 copy of every weight for each time
# step (10.4 GB of wx a step for the captioning GRU): T cut to 2 there
PAPER_GRAD_T = {"paper-captioning-gru": 2}
# step-0 gradients, cuda against reference backend: leaves computed in
# f32 (the GRUs' weights) leaf by leaf within GRAD_REL, the loss within
# PAPER_F32_LOSS; leaves computed in bf16 held in L2 norm no farther from
# the reference's than the reference's bf16 gradients lie from its own
# f32-compute gradients (the witness): the FC and MLP leaves, which
# sr_matmul and outer_accum compute, each against its own witness; the
# conv leaves (cuDNN on both sides, where a one-ulp change can move a
# max-pool's argmax) as a whole; the loss within PAPER_BF16_LOSS (bf16
# logits)
PAPER_F32_LOSS, PAPER_BF16_LOSS = 1e-5, 1e-2
# conv_up_as_matmul against autograd's conv dW in f64: an f32 sum over
# up to 400k positions in another order
CONV_UP_REL = 1e-4
# the convs whose weight update runs as conv_up_as_matmul: AlexNet's five
# at B=128 and VGG-16's first at B=8 (T = 8 x 224 x 224 = 401,408 rows
# of Ci = 3: 12-byte rows)
CONV_UP_CASES = (("paper-alexnet", 128, range(5)), ("paper-vgg16", 8, (0,)))


def _paper_f32_leaf(net, path: str) -> bool:
    """A leaf whose gradient is computed in f32: the GRUs' weights."""
    return net.kind == "gru" or (net.kind == "caption"
                                 and path.startswith("gru/"))


def _paper_grads(net, params, batch, backend: str, dtype) -> tuple:
    """(loss, {path: f32 gradient}) of one forward and backward of the
    net's training loss on `backend`, as paper_step takes them."""
    import torch
    from repro_torch.core.rounding import fold_key
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.runtime import paper_step as ps
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(req)
    key = fold_key(0, 1) if backend == "cuda" else None
    with torch.enable_grad():
        loss = ps.loss_fn(net, req, batch, backend=backend, key=key,
                          compute_dtype=dtype)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    out = {path: g.float() for (path, _), g in zip(leaves, grads)}
    return float(loss.detach()), out


def _l2_rel(got: dict, want: dict, paths) -> float:
    import torch
    num = sum(float(torch.sum((got[p].double() - want[p].double()) ** 2))
              for p in paths)
    den = sum(float(torch.sum(want[p].double() ** 2)) for p in paths)
    return math.sqrt(num / max(den, 1e-300))


class _ShapeSpy:
    """Counts the products of one step by (kernel, role, shape, dtype):
    wraps the wrappers the PE seam and conv_up_as_matmul call, so the
    kernels and their counters run as they would."""

    def __init__(self):
        import collections
        from repro_torch.kernels import outer_accum as koa
        from repro_torch.kernels import sr_matmul as kmm
        self.kmm, self.koa = kmm, koa
        self.seen = collections.Counter()

    def __enter__(self):
        kmm, koa = self.kmm, self.koa
        self.real = (kmm.sr_matmul, koa.outer_accum)
        real_mm, real_oa = self.real

        def mm(a, b, rbits=None, *, trans_b=False):
            m, n, k = kmm._shapes(a, b, trans_b)
            self.seen[("sr_matmul", "bp" if trans_b else "ff", m, n, k,
                       str(a.dtype).split(".")[-1])] += 1
            return real_mm(a, b, rbits, trans_b=trans_b)

        def oa(x, dy, **kw):
            self.seen[("outer_accum", "up", x.shape[1], dy.shape[1],
                       x.shape[0], str(x.dtype).split(".")[-1])] += 1
            return real_oa(x, dy, **kw)

        kmm.sr_matmul, koa.outer_accum = mm, oa
        return self

    def __exit__(self, *exc):
        self.kmm.sr_matmul, self.koa.outer_accum = self.real


def paper_grad_check(net, params, batch) -> None:
    """Step-0 gradients of `net`, cuda against reference backend (and the
    reference at f32 compute as the witness of bf16 leaves)."""
    import torch
    losses, grads = {}, {}
    losses["cuda"], grads["cuda"] = _paper_grads(net, params, batch, "cuda",
                                                 torch.bfloat16)
    losses["ref"], grads["ref"] = _paper_grads(net, params, batch,
                                               "reference", torch.bfloat16)
    paths = list(grads["ref"])
    f32 = [p for p in paths if _paper_f32_leaf(net, p)]
    bf16 = [p for p in paths if p not in f32]
    msg = []
    if f32:
        leaf, rel = _grad_rel({p: grads["cuda"][p] for p in f32},
                              {p: grads["ref"][p] for p in f32})
        msg.append(f"f32 leaves: worst {leaf} rel {rel:.3g} (tol "
                   f"{GRAD_REL})")
        check(rel < GRAD_REL, f"{net.name} step-0 gradient of {leaf}: rel "
              f"{rel:.3g} (gate {GRAD_REL})")
    if bf16:
        losses["witness"], wit = _paper_grads(net, params, batch,
                                              "reference", torch.float32)
        conv = [p for p in bf16 if "convs/" in p]
        fc = [p for p in bf16 if p not in conv]
        if conv:
            l2 = _l2_rel(grads["cuda"], grads["ref"], conv)
            wl2 = _l2_rel(grads["ref"], wit, conv)
            msg.append(f"bf16 conv leaves as a whole: L2 rel {l2:.3g} "
                       f"against the witness (reference bf16 vs f32 "
                       f"compute) {wl2:.3g}")
            check(l2 <= wl2, f"{net.name} step-0 bf16 conv gradients: L2 "
                  f"rel {l2:.3g} exceeds the reference's own bf16 error "
                  f"{wl2:.3g}")
        ratio = {}
        for p in fc:
            l2 = _l2_rel(grads["cuda"], grads["ref"], [p])
            wl2 = _l2_rel(grads["ref"], wit, [p])
            ratio[p] = l2 / max(wl2, 1e-300)
            check(l2 <= wl2, f"{net.name} step-0 bf16 gradient of {p}: L2 "
                  f"rel {l2:.3g} exceeds the reference's own bf16 error "
                  f"{wl2:.3g} on that leaf")
        if fc:
            worst = max(ratio, key=ratio.get)
            msg.append(f"bf16 FC leaves each against its witness: worst "
                       f"{worst} L2 rel "
                       f"{_l2_rel(grads['cuda'], grads['ref'], [worst]):.3g}"
                       f" = {ratio[worst]:.3g} of its witness")
        del wit
    tol = PAPER_BF16_LOSS if net.kind in ("cnn", "mlp") else PAPER_F32_LOSS
    lrel = abs(losses["cuda"] / losses["ref"] - 1)
    print(f"[paper:{net.name}] step 0 cuda vs reference: loss "
          f"{losses['cuda']!r} vs {losses['ref']!r} rel {lrel:.3g} (tol "
          f"{tol}); {'; '.join(msg)}")
    check(lrel <= tol, f"{net.name} step-0 loss rel {lrel:.3g} (tol {tol})")


def paper_train(net, params, batch, lr: float, B: int) -> dict:
    """PAPER_STEPS SGD steps of `net` on the cuda backend, launches
    counted per step and by product shape: losses finite and falling,
    every step through sr_matmul and outer_accum on the path of its
    operand type."""
    import torch
    from repro_torch.runtime import paper_step as ps
    step = ps.make_paper_step(net, lr=lr, backend="cuda", device="cuda")
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    losses, secs, per_step = [], [], []
    with _ShapeSpy() as spy:
        for s in range(PAPER_STEPS):
            before = {k: c.n for k, c in counters.items()}
            t0 = time.monotonic()
            params, met = step(params, batch, s)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
            per_step.append({k: c.n - before[k]
                             for k, c in counters.items()})
    counts = {k: c.n for k, c in counters.items()}
    for kern in ("sr_matmul", "outer_accum"):
        n = sum(v for key, v in spy.seen.items() if key[0] == kern)
        check(n == counts[kern], f"{net.name}: {n} {kern} calls by shape, "
              f"{counts[kern]} launches counted")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    flops = ps.train_flops(net, B)
    f32 = net.kind in ("gru", "caption")
    path = "f32" if f32 else "sm90"
    unit = "sequences" if f32 else "samples"
    print(f"[paper:{net.name}] B={B} {PAPER_STEPS} SGD steps lr {lr} on the "
          f"cuda backend: losses {losses}")
    print(f"[paper:{net.name}] ms/step {[round(x * 1e3, 2) for x in secs]} "
          f"median (steps 2-{PAPER_STEPS}) {med * 1e3:.2f}ms, "
          f"{B / med:.1f} {unit}/s, {flops / med / 1e12:.2f} TFLOP/s "
          f"({flops / 1e9:.1f} GFLOP a step, 3 x the forward's); peak "
          f"memory {peak:.2f} GiB")
    print(f"[paper:{net.name}] launches per step {per_step[-1]}")
    check(all(math.isfinite(x) for x in losses),
          f"{net.name}: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"{net.name}: loss did not fall: {losses[0]} -> {losses[-1]}")
    for k in ("sr_matmul", "outer_accum"):
        for p in per_step:
            check(p[k] > 0 and p[f"{k}:{path}"] == p[k],
                  f"{net.name}: a step launched {k} {p[k]} times, "
                  f"{p[f'{k}:{path}']} on the {path} path: {p}")
        check(counts[f"{k}:generic"] == 0,
              f"{net.name}: {counts[f'{k}:generic']} launches of {k} on the "
              f"generic path")
    return {"ms": med * 1e3, "tflops": flops / med / 1e12,
            "shapes": dict(spy.seen)}


def paper_shape_rows(net, shapes: dict, peaks) -> list:
    """Each product shape of `net`'s step against its plain version,
    timed by events and in a CUDA graph beside its bound and torch.matmul
    (TF32 off); a row per shape with its launches in the training run
    (`shapes`: launches by shape over PAPER_STEPS steps)."""
    import torch
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import sr_matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for (kern, role, m, n, k, dt), launches in sorted(shapes.items()):
        per_step = launches // PAPER_STEPS
        dtype = getattr(torch, dt)
        f32 = dtype == torch.float32
        if kern == "sr_matmul":
            tb = role == "bp"
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            b = (torch.randn((n, k) if tb else (k, n), generator=gen,
                             device="cuda") * k ** -0.5).to(dtype)
            p = kmm.operands_plan(a, b, tb)
            call = functools.partial(kmm.sr_matmul, a, b, trans_b=tb)
            plain = functools.partial(kmm.sr_matmul_plain, a, b, trans_b=tb)
            wt = b.t() if tb else b
            lib = functools.partial(torch.matmul, a, wt)
            nbytes = a.element_size() * (m * k + k * n) + 4 * m * n
            what = f"M={m} K={k} N={n} trans_b={int(tb)}"
            src = ("sr_matmul.cu", "src/repro/kernels/sr_matmul.py:96",
                   "repro/kernels/sr_matmul.py::sr_matmul")
        else:
            x = torch.randn((k, m), generator=gen, device="cuda").to(dtype)
            dy = (torch.randn((k, n), generator=gen, device="cuda")
                  * k ** -0.5).to(dtype)
            p = koa.up_plan(x, dy)
            call = functools.partial(koa.outer_accum, x, dy)
            plain = functools.partial(koa.outer_accum_plain, x, dy)
            xt = x.t()
            lib = functools.partial(torch.matmul, xt, dy)
            nbytes = x.element_size() * k * (m + n) + 4 * m * n
            what = f"T={k} D={m} F={n}"
            src = ("outer_accum.cu", "src/repro/kernels/outer_accum.py:80",
                   "repro/kernels/outer_accum.py::outer_accum")
        check(p.path == ("f32" if f32 else "sm90"),
              f"{net.name} {kern} {role} {what} {dt}: {plan_txt(p)}")
        got, want = call(), plain()
        torch.cuda.synchronize()
        ea, er = errs(got, want)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"{net.name} {kern} {role} {what} {dt}: max abs err {ea:.3g}")
        det = ""
        if p.splits > 1:
            check(torch.equal(call(), got), f"{net.name} {kern} {role} "
                  f"{what}: two split-K calls differ")
            det = "  split-K: 2 calls bit-equal"
        del got, want
        est = max(nbytes / peaks[0], 2 * m * n * k / peaks[2 if f32 else 1])
        iters = 3 if est > 1e-3 else 10
        ms = time_ms(call, iters=iters)
        p_ms = time_ms(plain, iters=iters)
        l_ms = time_ms(lib, iters=iters)
        g_ms = time_graph_ms(call, iters=iters, replays=3)
        gl_ms = time_graph_ms(lib, iters=iters, replays=3)
        b_ms, by = bound(nbytes, 2 * m * n * k, peaks, f32=f32)
        print(f"[paper:kernels] {net.name} {kern} {role.upper()} {what} {dt}"
              f" {plan_txt(p)} x{per_step}/step: kernel {ms:.4f}ms (graph "
              f"{g_ms:.4f}) plain {p_ms:.4f}ms torch.matmul {l_ms:.4f}ms "
              f"(graph {gl_ms:.4f}) bound {b_ms:.4f}ms ({by}); graph / "
              f"torch.matmul graph {g_ms / gl_ms:.2f}  max_abs_err "
              f"{ea:.3g}{det}")
        rows.append({
            "name": f"{kern}:{net.name}:{role}:{dt}:{m}x{n}x{k}",
            "route": "cuda",
            "source": ("src/repro_torch/csrc/sgemm_sm90.cuh" if f32
                       else "src/repro_torch/csrc/gemm_sm90.cuh"),
            "entry": f"src/repro_torch/csrc/{src[0]}", "replaces": src[1],
            "tpu_kernel": src[2], "max_abs_err": ea, "max_rel_err": er,
            "ms": ms, "kernel_ms": ms, "graph_ms": g_ms,
            "plain_ms": p_ms, "library_ms": l_ms,
            "library_graph_ms": gl_ms, "bound_ms": b_ms, "bound_by": by,
            "plan": list(p), "per_step": per_step, "launches": launches,
            "shapes": f"{net.name}'s {role.upper()} {what}, {dt}"})
        del call, plain, lib
        torch.cuda.empty_cache()
    return rows


def phase_conv_up(peaks) -> dict:
    """conv_up_as_matmul (one f32 outer_accum word per tap) at AlexNet's
    five convs and VGG-16's first, at full resolution, against autograd's
    conv dW in f64 (and in f32, TF32 off, as torch's own yardstick).
    Launches: the calls of one conv_up_as_matmul per conv, counted alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.models import cnn
    from repro_torch.runtime import paper_step as ps
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = worst_rel = 0.0
    tot = {"ms": 0.0, "graph": 0.0, "plain": 0.0, "lib": 0.0,
                       "bound": 0.0}
    by_ms = {"bytes": 0.0, "operations": 0.0}
    launches = 0
    for name, B, idx in CONV_UP_CASES:
        cfg = ps.paper_net(name).cfg
        hw, ch = cfg.in_hw, cfg.in_ch
        for i, c in enumerate(cfg.convs):
            ho = cnn.conv_hw(hw, c)
            if i in idx:
                x = torch.randn((B, hw, hw, ch), generator=gen,
                                device="cuda")
                dy = torch.randn((B, ho, ho, c.out_ch), generator=gen,
                                 device="cuda")
                run = functools.partial(cnn.conv_up_as_matmul, x, dy,
                                        c.kernel, c.stride, c.pad,
                                        backend="cuda")
                before = (koa.COUNTER.n, koa.PATH_COUNTERS["f32"].n)
                got = run()
                torch.cuda.synchronize()
                n_calls = koa.COUNTER.n - before[0]
                launches += n_calls
                check(n_calls == c.kernel ** 2 == koa.PATH_COUNTERS["f32"].n
                      - before[1], f"conv_up {name} conv{i + 1}: "
                      f"{n_calls} outer_accum launches for "
                      f"{c.kernel ** 2} taps, not all on the f32 path")
                pad = c.kernel // 2 if c.pad == "SAME" else 0
                xc = x.permute(0, 3, 1, 2)
                dyc = dy.permute(0, 3, 1, 2)
                wshape = (c.out_ch, ch, c.kernel, c.kernel)
                want = F.grad.conv2d_weight(
                    xc.double(), wshape, dyc.double(), stride=c.stride,
                    padding=pad).permute(2, 3, 1, 0)
                lib = functools.partial(F.grad.conv2d_weight, xc, wshape,
                                        dyc, stride=c.stride, padding=pad)
                lib_err = float((lib().permute(2, 3, 1, 0).double()
                                 - want).abs().max())
                scale = float(want.abs().max())
                err = float((got.double() - want).abs().max())
                worst = max(worst, err)
                worst_rel = max(worst_rel, errs(got, want)[1])
                check(err <= CONV_UP_REL * scale,
                      f"conv_up {name} conv{i + 1}: max abs err {err:.3g} "
                      f"of max |dW| {scale:.3g} (tol {CONV_UP_REL})")
                T = B * ho * ho
                tap = (x[:, :ho, :ho].reshape(-1, ch).contiguous(),
                       dy.reshape(-1, c.out_ch).contiguous())
                p = koa.up_plan(*tap)
                det = ""
                if p.splits > 1:
                    t1 = koa.outer_accum(*tap)
                    check(torch.equal(t1, koa.outer_accum(*tap)),
                          f"conv_up {name} conv{i + 1}: a tap's two split-K"
                          f" calls differ")
                    det = "  a tap's split-K: 2 calls bit-equal"
                del got, want
                ms = time_ms(run, iters=3, warmup=1)
                g_ms = time_graph_ms(run, iters=2, replays=2)
                plain = time_ms(functools.partial(
                    cnn.conv_up_as_matmul, x, dy, c.kernel, c.stride, c.pad,
                    backend="reference"), iters=3, warmup=1)
                l_ms = time_ms(lib, iters=3, warmup=1)
                b_ms, by = bound(4 * (x.numel() + dy.numel()
                                      + c.kernel ** 2 * ch * c.out_ch),
                                 2 * c.kernel ** 2 * T * ch * c.out_ch, peaks,
                                 f32=True)
                by_ms[by] += b_ms
                for key, v in (("ms", ms), ("graph", g_ms), ("plain", plain),
                               ("lib", l_ms), ("bound", b_ms)):
                    tot[key] += v
                print(f"[conv_up] {name} conv{i + 1} B={B} k={c.kernel} "
                      f"stride {c.stride} Ci={ch} Co={c.out_ch} T={T}: "
                      f"{c.kernel ** 2} taps, a tap's {plan_txt(p)}: "
                      f"{ms:.4f}ms (graph {g_ms:.4f}) plain {plain:.4f}ms "
                      f"torch conv2d_weight {l_ms:.4f}ms bound "
                      f"{b_ms:.4f}ms ({by}); max abs err {err:.3g} "
                      f"(torch f32 {lib_err:.3g}) of max |dW| "
                      f"{scale:.3g}{det}")
                del x, dy, run, lib
                torch.cuda.empty_cache()
            hw, ch = cnn.conv_out_hw(hw, c), c.out_ch
    return {"name": "outer_accum:conv_up", "route": "cuda",
            "source": "src/repro_torch/csrc/sgemm_sm90.cuh",
            "entry": "src/repro_torch/csrc/outer_accum.cu",
            "replaces": "src/repro/kernels/outer_accum.py:80",
            "tpu_kernel": "repro/kernels/outer_accum.py::outer_accum",
            "max_abs_err": worst, "max_rel_err": worst_rel, "ms": tot["ms"], "kernel_ms": tot["ms"],
            "graph_ms": tot["graph"], "plain_ms": tot["plain"],
            "library_ms": tot["lib"], "bound_ms": tot["bound"],
            "bound_by": max(by_ms, key=by_ms.get), "launches": launches,
            "shapes": "conv_up_as_matmul, one f32 outer_accum word a tap, at "
                      "AlexNet's five convs (B=128) and VGG-16's first "
                      "(B=8, T=401408, Ci=3); library: torch.nn.grad."
                      "conv2d_weight (cuDNN, TF32 off)"}


def phase_paper(peaks) -> list:
    """The paper's five networks at full width on the cuda backend: the
    step-0 gradients against the reference backend, PAPER_STEPS SGD
    steps each with launches counted per step, each product shape of a
    step against its plain version, conv_up_as_matmul, and Fig 16's
    throughput spread.  Returns the kernel rows."""
    import dataclasses
    import torch
    from repro_torch.runtime import paper_step as ps
    t_phase = time.monotonic()
    rows, tflops = [], []
    for name, B, lr in PAPER_RUNS:
        net = ps.paper_net(name)
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = ps.init_params(net, gen)
        batch = ps.synthetic_batch(net, B, gen)
        gnet, gbatch = net, batch
        if name in PAPER_GRAD_T:
            T = PAPER_GRAD_T[name]
            gnet = dataclasses.replace(net, cfg=dataclasses.replace(
                net.cfg, T=T))
            gbatch = dict(batch, y=batch["y"][:, :T])
            print(f"[paper:{name}] step-0 gradients at T={T} (the f64 "
                  f"reference keeps an f64 copy of wx, 10.4 GB, a step)")
        paper_grad_check(gnet, params, gbatch)
        del gbatch
        torch.cuda.empty_cache()
        res = paper_train(net, params, batch, lr, B)
        del params, batch
        torch.cuda.empty_cache()
        net_rows = paper_shape_rows(net, res["shapes"], peaks)
        prod, bnd, lib = (sum(r[k] * r["per_step"] for r in net_rows)
                          for k in ("graph_ms", "bound_ms",
                                    "library_graph_ms"))
        print(f"[paper:kernels] {name}: a step's products {prod:.3f}ms in "
              f"the kernels (graph; torch.matmul {lib:.3f}ms, bound "
              f"{bnd:.3f}ms) of {res['ms']:.3f}ms a step: "
              f"{prod / res['ms']:.3f} of the step")
        rows += net_rows
        tflops.append(res["tflops"])
        torch.cuda.empty_cache()
    rows.append(phase_conv_up(peaks))
    mean = sum(tflops) / len(tflops)
    std = math.sqrt(sum((v - mean) ** 2 for v in tflops) / len(tflops))
    print(f"[paper:suite] achieved TFLOP/s "
          f"{', '.join(f'{n} {v:.2f}' for (n, _, _), v in zip(PAPER_RUNS, tflops))}"
          f": std/mean {std / mean:.3f} (Fig 16's measure on this card; the "
          f"paper reports < 0.06 for its own chip; not a gate)")
    print(f"[paper] the five networks, their product shapes and conv_up in "
          f"{time.monotonic() - t_phase:.1f}s")
    return rows


# ---------------------------------------------------------------------------
# rwkv6-1.6b training: wkv6_bwd, the fp32 check, the bf16 main path
# ---------------------------------------------------------------------------

# wkv6_bwd against its plain version (f64 sums): f32 sums in another
# order, each output within this share of its own largest value
WKV_BWD_REL = 1e-4
RWKV_LAYERS = 24
# (label, B, S, H, hd, decay or None for w in (0.45, 0.95), r/k/v dtype)
WKV_BWD_CASES = (("train", 4, 256, 32, 64, None, "bfloat16"),
                 ("train f32", 4, 256, 32, 64, None, "float32"),
                 ("hd16", 4, 256, 128, 16, None, "bfloat16"),
                 ("hd32", 4, 256, 64, 32, None, "bfloat16"),
                 ("S=1", 4, 1, 32, 64, None, "bfloat16"),
                 ("S=33", 4, 33, 32, 64, None, "bfloat16"),
                 ("strong", 4, 256, 32, 64, 1e-6, "bfloat16"),
                 ("S=5", 4, 5, 32, 64, None, "bfloat16"),
                 ("S=9", 4, 9, 32, 64, None, "bfloat16"),
                 ("B=3 H=7", 3, 40, 7, 64, None, "bfloat16"),
                 ("B=3 H=7 f32", 3, 40, 7, 64, None, "float32"))


def phase_wkv6_bwd(peaks) -> dict:
    """wkv6_bwd (csrc/wkv6_bwd.cu) against wkv6_bwd_plain on the card at
    WKV_BWD_CASES: each of dr, dk, dv, dw, du within WKV_BWD_REL of its
    largest value, finite, and two calls bit-equal.  The training shape
    (B=4, S=256, 32 heads of 64, bf16 r, k, v) is timed in events and in
    a CUDA graph beside its bound and the plain version."""
    import torch
    from repro_torch.kernels import wkv6 as kwkv
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    names = ("dr", "dk", "dv", "dw", "du")
    row, worst_abs, worst_rel = None, 0.0, 0.0
    for label, B, S, H, hd, decay, dt in WKV_BWD_CASES:
        rkv = getattr(torch, dt)
        r, k, v = ((0.5 * rnd(B, S, H, hd)).to(rkv) for _ in range(3))
        w = (torch.full((B, S, H, hd), decay, device="cuda") if decay
             else 0.45 + 0.5 * torch.sigmoid(rnd(B, S, H, hd)))
        u = 0.1 * rnd(H, hd)
        dy = rnd(B, S, H, hd)
        args = (r, k, v, w, u, dy)
        got = kwkv.wkv6_bwd(*args)
        again = kwkv.wkv6_bwd(*args)
        want = kwkv.wkv6_bwd_plain(*args)
        torch.cuda.synchronize()
        rels = {}
        for nm, g, g2, wv in zip(names, got, again, want):
            check(bool(torch.isfinite(g).all()),
                  f"wkv6_bwd {label}: non-finite {nm}")
            check(torch.equal(g, g2), f"wkv6_bwd {label}: two calls differ "
                  f"in {nm}")
            err = float((g - wv).abs().max())
            big = float(wv.abs().max())
            rels[nm] = err / max(big, 1e-30)
            worst_abs = max(worst_abs, err)
            check(err <= WKV_BWD_REL * big,
                  f"wkv6_bwd {label} (B={B} S={S} H={H} hd={hd}): {nm} max "
                  f"abs err {err:.3g} against its largest {big:.3g} "
                  f"(share {WKV_BWD_REL})")
        worst_rel = max(worst_rel, max(rels.values()))
        print(f"[wkv6_bwd] {label:<9} B={B} S={S} H={H} hd={hd} r,k,v {dt}: "
              f"max abs err / largest "
              f"{', '.join(f'{n} {x:.3g}' for n, x in rels.items())}; "
              f"2 calls bit-equal")
        if label != "train":
            continue
        ms = time_ms(lambda: kwkv.wkv6_bwd(*args), iters=10)
        g_ms = time_graph_ms(lambda: kwkv.wkv6_bwd(*args), iters=10)
        plain = time_ms(lambda: kwkv.wkv6_bwd_plain(*args), iters=2,
                        warmup=1)
        n_tok = B * S * H * hd
        plan = kwkv.wkv6_bwd_plan(B, H, S, hd)
        # r, k, v in their type, w and dy in, dr, dk, dv, dw out (f32); u
        # in, du out
        nbytes = n_tok * (3 * r.element_size() + 8 + 16) + 8 * H * hd
        # what the gradient needs a token and head: one forward recompute
        # of the state (3 hd^2), the G update (3 hd^2) and the dr, dk, dv,
        # dw sums (2 hd^2 each); the u terms are rank-1, O(hd).  The
        # kernel's pass A (the state every tile) and its walk's 1.25
        # forward steps a token are its own design, not counted
        flops = 14 * n_tok * hd
        b_ms, by = bound(nbytes, flops, peaks, f32=True)
        print(f"[wkv6_bwd] {label} B={B} S={S} H={H} hd={hd}: kernel "
              f"{ms:.4f}ms (in a CUDA graph {g_ms:.4f}ms) plain "
              f"{plain:.4f}ms bound {b_ms:.4f}ms ({by}: {flops / 1e9:.3f} "
              f"GFLOP f32, {nbytes / 1e6:.1f} MB); graph / bound "
              f"{g_ms / b_ms:.2f}; wkv6_bwd_plan: one block a (b, h), "
              f"{plan.grid} blocks x {plan.threads} threads ({plan.cols} "
              f"state values a thread), tile {plan.tile}, {plan.smem} B "
              f"shared")
        row = {"name": "wkv6_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/wkv6_bwd.cu",
               "replaces": "src/repro/models/ssm.py:82",
               "tpu_kernel": None, "ms": ms, "kernel_ms": ms, "graph_ms": g_ms,
               "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
               "bound_by": by,
               "shapes": "rwkv6-1.6b training: B=4, S=256, H=32, hd=64, "
                         "bf16 r, k, v, from a zero state; one call a "
                         "layer a step"}
    row["max_abs_err"] = worst_abs
    row["max_rel_of_largest"] = worst_rel
    return row


def phase_train_rwkv6_fp32(rcfg) -> None:
    """Four full-width rwkv6-1.6b layers under fp32 (remat block, B=4,
    S=256, random layernorm scales and biases): step-0 loss and every
    gradient leaf, the cuda backend (f32 sr_matmul / outer_accum, wkv6,
    wkv6_bwd) against the reference backend (f64-accumulated products,
    the plain recurrence and its plain reverse), TF32 off.  Each leaf
    within GRAD_REL of its largest value, the loss within TRAIN_RTOL[0];
    every product on the f32 path; each layer's recurrence launched
    twice (remat block) and its backward once."""
    import dataclasses
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    n = 4
    cfg4 = dataclasses.replace(rcfg, n_layers=n)
    shape = ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train")
    program = compile_program(cfg4, shape, precision="fp32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    train = TrainConfig(precision="fp32", kernel_backend="cuda",
                        remat="block")
    params = tl.init_state(cfg4, program, train, gen)["params"]
    for norm in (params["groups"]["u0"]["norm1"],
                 params["groups"]["u0"]["norm2"], params["final_norm"]):
        for key, base in (("scale", 1.0), ("bias", 0.0)):
            norm[key].copy_(base + 0.1 * torch.randn(
                norm[key].shape, generator=gen, device="cuda"))
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in SyntheticLM(cfg4, shape).batch_at(0).items()}
    counters = _counters()
    out = {}
    for backend in ("reference", "cuda"):
        for c in counters.values():
            c.reset()
        t0 = time.monotonic()
        loss, grads = _step0_grads(cfg4, program, backend, params, batch0,
                                   torch.float32)
        torch.cuda.synchronize()
        counts = {k: c.n for k, c in counters.items()}
        out[backend] = (loss, grads, counts)
        print(f"[train:rwkv6:fp32] {backend:<9} {n} layers B={TRAIN_B} "
              f"S={TRAIN_S}: step-0 loss {loss!r} "
              f"({time.monotonic() - t0:.1f}s); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    (lr, gr, cr), (lc, gc, cc) = out["reference"], out["cuda"]
    leaf, rel = _grad_rel(gc, gr)
    l_rel = abs(lc / lr - 1)
    print(f"[train:rwkv6:fp32] cuda vs reference: loss rel {l_rel:.3g}, "
          f"worst leaf gradient rel {rel:.3g} ({leaf}); per leaf "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
              {k: float((gc[k] - gr[k]).abs().max()
                        / gr[k].abs().max().clamp_min(1e-30))
               for k in gr}.items())))
    check(l_rel <= TRAIN_RTOL[0], f"rwkv6 fp32 step-0 loss: cuda {lc} vs "
          f"reference {lr} (rtol {TRAIN_RTOL[0]})")
    check(rel < GRAD_REL, f"rwkv6 fp32 step-0 gradient of {leaf}: rel "
          f"{rel:.3g} (gate {GRAD_REL})")
    check(not any(cr.values()), f"the reference backend launched a kernel: "
          f"{cr}")
    for k in ("sr_matmul", "outer_accum"):
        check(cc[k] > 0 and cc[f"{k}:f32"] == cc[k]
              and cc[f"{k}:sm90"] == 0 and cc[f"{k}:generic"] == 0,
              f"the rwkv6 fp32 step launched {k} off the f32 path: {cc}")
    check(cc["wkv6"] == 2 * n and cc["wkv6_bwd"] == n,
          f"the rwkv6 fp32 step launched wkv6 {cc['wkv6']} and wkv6_bwd "
          f"{cc['wkv6_bwd']} times (want {2 * n} and {n})")


def phase_train_rwkv6() -> dict:
    """rwkv6-1.6b's training main path: launch.train at full width (24
    layers, B=4, S=256, paper_sr_bf16, adamw, remat block), 8 steps;
    every step launches each layer's recurrence twice (its forward and
    the remat recompute) and its backward once."""
    return phase_train("rwkv6-1.6b", "train:rwkv6",
                       {"wkv6": 2 * RWKV_LAYERS, "wkv6_bwd": RWKV_LAYERS})


# ---------------------------------------------------------------------------
# granite-moe-1b-a400m training: the expert tables' batched FF / BP / UP
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
GRANITE_LAYERS = 24
# [train:granite:capacity]: a batch of more than 4096 tokens, which
# takes _moe_single's capacity branch (B x S = 8192 tokens, C =
# _capacity(8192, 8, 32) = 2560 rows an expert, some entries dropped)
# rather than the dropless one (C = T) that TRAIN_B x TRAIN_S takes
CAP_B, CAP_S, CAP_C = 2, 4096, 2560
# [outer_accum:experts]: the batched UP at these C (rows an expert; a
# training step's is T = B x S = 1024, dropless, the last and timed one)
EXPERT_UP_CS = (8, 40, CAP_C, TRAIN_B * TRAIN_S)
# [train:granite] step 0, cuda (bf16 products with f32 accumulation, SR
# UP from the port's bits) against the reference backend (f64 products,
# nearest UP) under paper_sr_bf16, expert selection held: the loss within
# GRANITE_LOSS_RTOL, each gradient leaf's L2 distance within
# GRANITE_GRAD_L2 of its L2 norm (bf16 activations round at other
# places on the two backends; SR adds unbiased noise of a bf16 step)
GRANITE_LOSS_RTOL = 1e-3
GRANITE_GRAD_L2 = 0.05
# [sr_matmul:experts:f32] / [outer_accum:batched:f32]: the f32 batched
# mode (the fp32 preset on a MoE table) at these C: a PREFILL chunk, a
# ragged one (its UP with scale 1/C), and a training step's dropless
# T = B x S (the timed one)
EXPERT_F32_CS = (8, 40, TRAIN_B * TRAIN_S)
# the f32 batched products of one layer's three tables at C = 1024 in a
# CUDA graph as the kernel that computed every row measured them (NVIDIA
# H100 80GB HBM3, 700 W), the yardstick of [targets]
F32_EXPERTS_ALL_ROWS_GRAPH_MS = {"ff": 2.5140, "bp": 2.4740, "up": 2.4159}
# router probabilities nearer than this may swap between two backends
# (tests/test_torch_moe.py's TIE_GAP)
TIE_GAP = 1e-5
# [train:granite:memory] and [train:granite], GiB above what earlier
# phases hold: adamw's update at 24 layers (the old and the new state,
# 7.46 GiB each, the bf16 gradients 2.49 and one leaf's f32
# temporaries), and the 8-step run's peak
GRANITE_UPDATE_GIB, GRANITE_RUN_GIB = 21.0, 22.0


def _granite_tables(gcfg) -> list:
    """(name, K, N) of a MoE layer's three expert tables (E, K, N)."""
    d, fe = gcfg.d_model, gcfg.moe.d_expert
    return [("experts_in", d, fe), ("experts_gate", d, fe),
            ("experts_out", fe, d)]


def phase_expert_training_products(gcfg, peaks) -> tuple:
    """A MoE training step's expert products at granite's full width:
    outer_accum's batched mode (UP, dW (E, K, N) = X^T dY) at layer 0's
    three tables' shapes and C in EXPERT_UP_CS rows an expert, every row
    random, one launch on the sm90 path each, within MM_RTOL / MM_ATOL of
    the plain version in f32, its SR result bit-equal to the plain SR
    cast of its own f32 result and over two calls.  Then the step's UP,
    FF (X . W) and BP (dY . W^T, trans_b) at C = 1024 as the main path
    runs them — live rows from a seeded router, bf16 out, SR UP — gated
    and timed by _expert_role against the all-live and parent-equivalent
    forms and torch.bmm.  Returns (the kernels-line row of the batched
    UP, the FF / BP numbers)."""
    import torch
    from repro_torch.core.rounding import sr_cast_bf16
    from repro_torch.kernels import outer_accum as koa
    gen = torch.Generator(device="cuda").manual_seed(24)
    E = gcfg.moe.n_experts
    worst_abs = 0.0

    def operands(C, K, N):
        x = torch.randn((E, C, K), generator=gen, device="cuda").bfloat16()
        dy = (torch.randn((E, C, N), generator=gen, device="cuda")
              * C ** -0.5).bfloat16()
        return x, dy, _rbits(gen, (E, K, N))

    for C in EXPERT_UP_CS:
        for name, K, N in _granite_tables(gcfg):
            x, dy, rb = operands(C, K, N)
            p = koa.batched_plan(E, C, K, N)
            check(p.path == "sm90", f"outer_accum:experts {name} C={C}: "
                  f"{plan_txt(p)}, want sm90")
            before = {k: c.n for k, c in (("batched", koa.BATCHED_COUNTER),
                                          ("all", koa.COUNTER),
                                          *koa.PATH_COUNTERS.items())}
            got = koa.outer_accum_batched(x, dy)
            moved = {k: c.n - before[k] for k, c in (
                ("batched", koa.BATCHED_COUNTER), ("all", koa.COUNTER),
                *koa.PATH_COUNTERS.items())}
            check(moved == {"batched": 1, "all": 1, "sm90": 1, "generic": 0,
                            "f32": 0},
                  f"outer_accum:experts {name} C={C}: counters moved "
                  f"{moved}, want one sm90 launch")
            want = koa.outer_accum_batched_plain(x, dy)
            got_sr = koa.outer_accum_batched(x, dy, rbits=rb)
            again = koa.outer_accum_batched(x, dy, rbits=rb)
            torch.cuda.synchronize()
            ea, _ = errs(got, want)
            worst_abs = max(worst_abs, ea)
            check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
                  f"outer_accum:experts {name} ({E}x{C}x{K}x{N}): max abs "
                  f"err {ea:.3g}")
            check(torch.equal(got_sr.view(torch.int16),
                              sr_cast_bf16(got, rb).view(torch.int16)),
                  f"outer_accum:experts {name} C={C}: the SR epilogue is "
                  f"not the plain SR cast of the kernel's own f32 product")
            check(torch.equal(got_sr.view(torch.int16),
                              again.view(torch.int16)),
                  f"outer_accum:experts {name} C={C}: two calls differ")
            del got, want, again, got_sr
            print(f"[outer_accum:experts] {name:<12} E={E} C={C} K={K} "
                  f"N={N} {plan_txt(p)}: max_abs_err {ea:.3g}; SR "
                  f"bit-equal to the plain cast; 2 calls bit-equal")
    # a training step's products at C = T = 1024 as the main path runs
    # them: a seeded router's live rows, bf16 out, SR UP; three operand
    # sets a table (the cold timings)
    from repro_torch.launch import ablate_experts
    variants = ablate_experts.build_variants()
    C = EXPERT_UP_CS[-1]
    router = (torch.randn((gcfg.d_model, E), generator=gen, device="cuda")
              * gcfg.d_model ** -0.5)
    rows, xb = _routed_rows(gcfg, router, C, gen)
    xb = xb.bfloat16()

    def full(w):
        return torch.randn((E, C, w), generator=gen, device="cuda").bfloat16()

    def weight(K, N):
        return (torch.randn((E, K, N), generator=gen, device="cuda")
                * K ** -0.5).bfloat16()

    res = {}
    for role in ("up", "ff", "bp"):
        tabs = []
        for name, K, N in _granite_tables(gcfg):
            if role == "up":
                dy = lambda: _live_buffer(rows, C, N, gen, C ** -0.5)
                routed = [(_live_buffer(rows, C, K, gen), dy(),
                           _rbits(gen, (E, K, N))) for _ in range(3)]
                every = [(full(K), full(N) * C ** -0.5, r)
                         for _, _, r in routed]
            else:
                width = N if role == "bp" else K
                a = (xb if role == "ff" and K == gcfg.d_model
                     else _live_buffer(rows, C, width, gen))
                ws = [weight(K, N) for _ in range(3)]
                routed, every = ([(a, w) for w in ws],
                                 [(full(width), w) for w in ws])
            tabs.append((name, routed, every))
        res[role] = _expert_role("experts:train", role, tabs, rows, C,
                                 peaks, variants)
        del tabs
        torch.cuda.empty_cache()
    up = res["up"]
    row = {"name": "outer_accum:experts", "counter": "outer_accum:batched",
           "route": "cuda",
           "source": "src/repro_torch/csrc/gemm_sm90_batched.cuh",
           "entry": "src/repro_torch/csrc/outer_accum.cu",
           "replaces": "src/repro/kernels/outer_accum.py:80",
           "tpu_kernel": "repro/kernels/outer_accum.py::outer_accum under "
                         "jax.vmap (repro/engine/dispatch.py:220-229)",
           "redesigned": "live tokens, SR bits by TMA",
           "max_abs_err": max(worst_abs, up["max_abs_err"]), "ms": up["ms"],
           "kernel_ms": up["ms"], "plain_ms": up["plain"],
           "library_ms": up["lib"],
           "library": "torch.bmm (bf16 out, no SR)",
           "bound_ms": up["bound"], "bound_by": up["bound_by"],
           "full_c_bound_ms": up["bound_full"], "graph_ms": up["graph"],
           "cold_graph_ms": up["cold"], "library_graph_ms": up["lib_graph"],
           "library_cold_graph_ms": up["lib_cold"],
           "all_live_graph_ms": up["all_live_graph"],
           "all_live_cold_graph_ms": up["all_live_cold"],
           "split_graph_ms": up["split"], "live_rows": up["live_rows"],
           "shapes": f"granite-moe-1b-a400m, one layer's three expert "
                     f"tables' UP with SR, E={E}, C={C}, routed by a "
                     f"seeded router"}
    return row, {"max_abs_err": max(res["ff"]["max_abs_err"],
                                    res["bp"]["max_abs_err"]),
                 "ff": res["ff"], "bp": res["bp"]}


def phase_train_granite_step0(gcfg, n: int = 4, B: int = TRAIN_B,
                              S: int = TRAIN_S,
                              label: str = "train:granite") -> None:
    """n full-width granite-moe-1b-a400m layers under paper_sr_bf16
    (remat block, B x S tokens, random RMSNorm scales): step-0 loss and
    every gradient leaf on the cuda backend against the reference
    backend, the reference run held to the cuda run's expert selection
    (each call's own probabilities weigh it), within GRANITE_LOSS_RTOL
    and GRANITE_GRAD_L2; the cuda step launching each layer's three
    tables' FF, remat FF and BP on sr_matmul_batched and their UP on
    outer_accum_batched, none on :generic.  Then the cuda step-0
    gradients under remat none, free routing: bit-equal to remat
    block's (the recompute picks the same top-k)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.data import SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    cfg4 = dataclasses.replace(gcfg, n_layers=n)
    T = B * S
    C = T if T <= 4096 else moe._capacity(T, gcfg.moe.top_k,
                                          gcfg.moe.n_experts)
    check(T <= 4096 or C == CAP_C, f"{label}: C={C} rows an expert, but "
          f"[outer_accum:experts] holds the UP at C={CAP_C}")
    shape = ShapeConfig("smoke", S, B, "train")
    program = compile_program(cfg4, shape, precision="paper_sr_bf16")
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = tl.cast_params(tfm.init(gen, cfg4), torch.bfloat16)
    for norm in (params["groups"]["u0"]["norm1"],
                 params["groups"]["u0"]["norm2"], params["final_norm"]):
        norm["scale"].copy_(1.0 + 0.1 * torch.randn(
            norm["scale"].shape, generator=gen, device="cuda"))
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in SyntheticLM(cfg4, shape).batch_at(0).items()}
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    chosen, flips = [], []
    with _routing(record=chosen):
        lc, gc = _step0_grads(cfg4, program, "cuda", params, batch0,
                              torch.bfloat16)
    torch.cuda.synchronize()
    cc = {k: c.n for k, c in counters.items()}
    t1 = time.monotonic()
    with _routing(record=flips, replay=chosen, own_weights=True):
        lr, gr = _step0_grads(cfg4, program, "reference", params, batch0,
                              torch.bfloat16)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    l2 = {k: float((gc[k] - gr[k]).norm() / gr[k].norm().clamp_min(1e-30))
          for k in gr}
    worst = max(l2, key=l2.get)
    l_rel = abs(lc / lr - 1)
    print(f"[{label}] {n} layers paper_sr_bf16 remat=block B={B} S={S} "
          f"(T={T} tokens, C={C} rows an expert{', dropless' if C == T else ''}"
          f") step 0: cuda loss {lc!r} ({t1 - t0:.1f}s), reference "
          f"loss {lr!r} ({t2 - t1:.1f}s) with the cuda run's expert "
          f"selection (its own top-k set differs on {_flips(flips)} "
          f"token routings, each layer's forward and remat recompute); "
          f"loss rel {l_rel:.3g}; worst leaf gradient "
          f"L2 rel {l2[worst]:.4f} ({worst}); per leaf "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(l2.items())))
    print(f"[{label}] the cuda step's launches "
          f"{ {k: v for k, v in cc.items() if v} }")
    check(math.isfinite(lc) and l_rel <= GRANITE_LOSS_RTOL,
          f"{label} step-0 loss: cuda {lc} vs reference {lr} (rtol "
          f"{GRANITE_LOSS_RTOL})")
    check(l2[worst] <= GRANITE_GRAD_L2, f"{label} step-0 gradient of "
          f"{worst}: L2 rel {l2[worst]:.4f} (gate {GRANITE_GRAD_L2})")
    want = {"sr_matmul:batched": 3 * 3 * n, "outer_accum:batched": 3 * n,
            "sr_matmul:generic": 0, "outer_accum:generic": 0,
            "sr_matmul:f32": 0, "outer_accum:f32": 0}
    check(all(cc[k] == v for k, v in want.items()),
          f"{label} step 0 launched {cc}, want {want}")
    del gr
    torch.cuda.empty_cache()
    ln, gn = _step0_grads(cfg4, program, "cuda", params, batch0,
                          torch.bfloat16, remat="none")
    same = [k for k in gc if torch.equal(gc[k], gn[k])]
    print(f"[{label}] remat none vs block, cuda, free routing: loss "
          f"{ln!r} vs {lc!r}; {len(same)} of {len(gc)} gradient leaves "
          f"bit-equal")
    check(ln == lc and len(same) == len(gc),
          f"{label} remat none vs block: loss {ln} vs {lc}, leaves that "
          f"differ: {sorted(set(gc) - set(same))}")


def phase_train_memory(arch: str, label: str,
                       update_gate: float = None) -> None:
    """Where `arch`'s training peak memory lies, at the main path's
    settings (full width, cut to fit the card as launch.train cuts it;
    paper_sr_bf16, adamw, B=4, S=256): the state as
    init_state makes it; one forward and backward as the training step
    runs them (remat block, the gradients at the params' dtype); then
    adamw's update of every leaf as the step hands it those gradients
    (a stacked leaf above 128 MB layer by layer, the sr_round
    writeback), the peak reset before each part.  Every size is GiB
    above what was allocated before the state (earlier phases'
    leftovers, printed).  `update_gate` fails the run where the update's
    peak exceeds it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.program import compile_program
    from repro_torch.core.tree import tree_leaves, tree_set
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import one_card_train_config
    from repro_torch.optim import optimizers
    from repro_torch.runtime import train_loop as tl
    gib = lambda b: b / 2**30
    cfg = one_card_train_config(
        get_config(arch), torch.cuda.get_device_properties(0).total_memory)
    shape = ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train")
    program = compile_program(cfg, shape, precision="paper_sr_bf16")
    train_cfg = TrainConfig(kernel_backend="cuda", remat="block")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, opt = tl.make_train_step(cfg, program, train_cfg)
    state = tl.init_state(cfg, program, train_cfg, gen, opt)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLM(cfg, shape).batch_at(0).items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    loss, grads = _step0_grads(cfg, program, "cuda", state["params"],
                               batch, torch.bfloat16, f32=False)
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    gtree: dict = {}
    for path, g in grads.items():
        tree_set(gtree, path, g)
    del grads
    torch.cuda.reset_peak_memory_stats()
    new_p, new_s = opt.update(gtree, state["opt"], state["params"], 0, 1)
    torch.cuda.synchronize()
    up_peak = torch.cuda.max_memory_allocated() - base
    leaves = tree_leaves(state["params"])
    path, big = max(leaves, key=lambda kv: kv[1].numel())
    whole = [(p, t) for p, t in leaves if not optimizers.chunked(t)]
    wpath, wbig = max(whole, key=lambda kv: kv[1].numel())
    n_chunked = len(leaves) - len(whole)
    print(f"[{label}] {cfg.n_layers} layers paper_sr_bf16 adamw "
          f"remat=block B={TRAIN_B} S={TRAIN_S}, above the {gib(base):.2f} "
          f"GiB held before: state {gib(resident):.2f} "
          f"GiB (params and both moments); forward + backward peak "
          f"{gib(fb_peak):.2f} GiB, {gib(held):.2f} GiB held after it (the "
          f"state and the gradients at the params' dtype); adamw update "
          f"peak {gib(up_peak):.2f} GiB; {n_chunked} of {len(leaves)} leaves "
          f"updated layer by layer, the largest {path} "
          f"{tuple(big.shape)} ({gib(4 * big.numel()):.2f} GiB in f32, "
          f"{gib(4 * big[0].numel()):.4f} a layer); the largest taken whole "
          f"{wpath} {tuple(wbig.shape)} ({gib(4 * wbig.numel()):.4f} GiB in "
          f"f32); step-0 loss {loss!r}")
    check(math.isfinite(loss), f"{label} step: loss {loss}")
    if update_gate is not None:
        check(gib(up_peak) <= update_gate, f"{label}: the adamw update's "
              f"peak {gib(up_peak):.2f} GiB exceeds {update_gate} GiB")
    del new_p, new_s, gtree, state, opt


def phase_train_granite() -> dict:
    """granite-moe-1b-a400m's training main path: launch.train at full
    width (24 layers, B=4, S=256, paper_sr_bf16, adamw, remat block), 8
    steps; every step launches each layer's three expert tables' FF,
    remat FF and BP on sr_matmul_batched (216) and their UP on
    outer_accum_batched (72); the run's peak stays within
    GRANITE_RUN_GIB of what earlier phases held."""
    res = phase_train(GRANITE, "train:granite",
                      {"sr_matmul:batched": 3 * 3 * GRANITE_LAYERS,
                       "outer_accum:batched": 3 * GRANITE_LAYERS})
    added = res["peak_gib"] - res["held_gib"]
    check(added <= GRANITE_RUN_GIB, f"train:granite: the run's peak is "
          f"{added:.2f} GiB above what earlier phases held, more than "
          f"{GRANITE_RUN_GIB}")
    return res


def phase_expert_f32_products(gcfg, peaks) -> tuple:
    """The f32 batched mode (the fp32 preset on a MoE table) at granite's
    full width: at layer 0's three tables and C in EXPERT_F32_CS rows an
    expert, every row random, sr_matmul_batched's FF (x . W) and BP
    (dY . W^T, trans_b) and outer_accum_batched's UP (scale X^T dY,
    scale 1/C at C = 40), each one launch on the f32 path, within
    MM_RTOL / MM_ATOL of its plain version and bit-equal over two calls
    (the C = 8 and 40 products whose blocks fill less than a wave split
    K).  Then a training step's FF, BP and UP at C = 1024 as the main
    path runs them, with a seeded router's live rows, gated and timed by
    _expert_role_f32.  Returns the kernels-line rows of sr_matmul's and
    outer_accum's f32 batched modes."""
    import torch
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import sr_matmul as kmm
    gen = torch.Generator(device="cuda").manual_seed(26)
    E, T = gcfg.moe.n_experts, EXPERT_F32_CS[-1]
    worst = {"ff": 0.0, "bp": 0.0, "up": 0.0}
    splits_seen = set()

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def one_launch(fn, mod) -> tuple:
        cs = (("batched", mod.BATCHED_COUNTER), ("all", mod.COUNTER),
              *mod.PATH_COUNTERS.items())
        before = {k: c.n for k, c in cs}
        out = fn()
        return out, {k: c.n - before[k] for k, c in cs}

    for C in EXPERT_F32_CS:
        for name, K, N in _granite_tables(gcfg):
            x, w, dy = rnd((E, C, K)), rnd((E, K, N), K ** -0.5), \
                rnd((E, C, N), C ** -0.5)
            scale = 1.0 / C if C == 40 else 1.0
            roles = (
                ("ff", kmm, (C, N, K), kmm.f32_plan(C, N, K, experts=E),
                 lambda: kmm.sr_matmul_batched(x, w),
                 lambda: kmm.sr_matmul_batched_plain(x, w)),
                ("bp", kmm, (C, K, N), kmm.f32_plan(C, K, N, experts=E),
                 lambda: kmm.sr_matmul_batched(dy, w, trans_b=True),
                 lambda: kmm.sr_matmul_batched_plain(dy, w, trans_b=True)),
                ("up", koa, (K, N, C), koa.batched_f32_plan(E, C, K, N),
                 lambda: koa.outer_accum_batched(x, dy, scale=scale),
                 lambda: koa.outer_accum_batched_plain(x, dy, scale=scale)))
            for role, mod, (m, n, k), p, call, plain in roles:
                tag = ("outer_accum:batched:f32" if role == "up"
                       else "sr_matmul:experts:f32")
                got, moved = one_launch(call, mod)
                check(moved == {"batched": 1, "all": 1, "f32": 1,
                                "sm90": 0, "generic": 0},
                      f"{tag} {role} {name} C={C}: counters moved {moved}, "
                      f"want one f32 launch")
                again = call()
                want = plain()
                torch.cuda.synchronize()
                ea, _ = errs(got, want)
                worst[role] = max(worst[role], ea)
                check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
                      f"{tag} {role} {name} ({E}x{m}x{n}x{k}): max abs err "
                      f"{ea:.3g}")
                check(torch.equal(got.view(torch.int32),
                                  again.view(torch.int32)),
                      f"{tag} {role} {name} C={C}: two calls differ")
                if p.splits > 1:
                    splits_seen.add((role, name, C, p.splits))
                del got, again, want
                note = ", scale 1/C" if role == "up" and scale != 1 else ""
                print(f"[{tag}] {role} {name:<12} E={E} C={C} "
                      f"({m}x{n}x{k}{note}) {plan_txt(p)}: max_abs_err "
                      f"{ea:.3g}; 2 calls bit-equal; one launch")
            del x, w, dy
            torch.cuda.empty_cache()
    check(any(C < T for _, _, C, _ in splits_seen),
          f"no f32 batched product below C={T} split K: {splits_seen}")
    print(f"[sr_matmul:experts:f32] split-K plans held bit-equal: "
          f"{sorted(splits_seen)}")

    # a training step's products at C = T = 1024 as the main path runs
    # them: a seeded router's live rows; three operand sets a table (the
    # cold timings), the all-live sets with every row random
    router = (torch.randn((gcfg.d_model, E), generator=gen, device="cuda")
              * gcfg.d_model ** -0.5)
    rows, xb = _routed_rows(gcfg, router, T, gen)
    res = {}
    for role in ("ff", "bp", "up"):
        tabs = []
        for name, K, N in _granite_tables(gcfg):
            w = [rnd((E, K, N), K ** -0.5) for _ in range(3)]
            if role == "up":
                routed = [(_live_buffer(rows, T, K, gen, f32=True),
                           _live_buffer(rows, T, N, gen, T ** -0.5, f32=True))
                          for _ in range(3)]
                full = [(rnd((E, T, K)), rnd((E, T, N), T ** -0.5))
                        for _ in range(3)]
            else:
                width = N if role == "bp" else K
                a = (xb if role == "ff" and K == gcfg.d_model
                     else _live_buffer(rows, T, width, gen, f32=True))
                routed = [(a, wi) for wi in w]
                full = [(rnd((E, T, width)), wi) for wi in w]
            tabs.append((name, routed, full))
        res[role] = _expert_role_f32(role, tabs, rows, T, peaks)
        res[role]["max_abs_err"] = max(res[role]["max_abs_err"],
                                       worst[role])
        del tabs
        torch.cuda.empty_cache()

    def row(name, counter, entry, roles, tpu, what):
        t = {k: sum(res[r][k] for r in roles) for k in res["ff"]
             if isinstance(res["ff"][k], float)}
        return {"name": name, "counter": counter, "route": "cuda",
                "source": "src/repro_torch/csrc/sgemm_sm90_batched.cuh",
                "entry": entry, "replaces": tpu[0], "tpu_kernel": tpu[1],
                "redesigned": "live rows only; FF / BP live tiles first, "
                              "the UP's experts longest first",
                "max_abs_err": max(res[r]["max_abs_err"] for r in roles),
                "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain"],
                "library_ms": t["lib"],
                "library": "torch.bmm (f32, TF32 off)",
                "bound_ms": t["bound"], "bound_by": "operations",
                "full_c_bound_ms": t["bound_full"], "graph_ms": t["graph"],
                "cold_graph_ms": t["cold"],
                "library_graph_ms": t["lib_graph"],
                "library_cold_graph_ms": t["lib_cold"],
                "all_live_graph_ms": t["all_live_graph"],
                "all_live_cold_graph_ms": t["all_live_cold"],
                "live_rows": res["ff"]["live_rows"],
                **{r: res[r] for r in roles},
                "shapes": f"granite-moe-1b-a400m, one layer's three expert "
                          f"tables' {what}, f32, E={E}, C={T}, routed by a "
                          f"seeded router"}

    return (row("sr_matmul:experts:f32", "sr_matmul:batched",
                "src/repro_torch/csrc/sr_matmul.cu", ("ff", "bp"),
                ("src/repro/kernels/sr_matmul.py:96",
                 "repro/kernels/sr_matmul.py::sr_matmul under jax.vmap "
                 "(repro/engine/dispatch.py:199, :220-225)"), "FF and BP"),
            row("outer_accum:experts:f32", "outer_accum:batched",
                "src/repro_torch/csrc/outer_accum.cu", ("up",),
                ("src/repro/kernels/outer_accum.py:80",
                 "repro/kernels/outer_accum.py::outer_accum under jax.vmap "
                 "(repro/engine/dispatch.py:220-225)"), "UP"))


def _expert_role_f32(role: str, tables: list, rows, C: int, peaks) -> dict:
    """One role of a MoE layer's f32 batched products over its three
    tables, as the fp32 main path runs them: `tables` holds (name,
    routed, full) with three operand sets each — routed: every expert's
    rows past `rows` zero; full: every row live and random (the skewed
    worst case) — as (a, w) (ff: a . w; bp: a . w^T) or (x, dy) (up:
    x^T dy).  Gates each table's routed product: within MM_RTOL /
    MM_ATOL of the plain version and bit-equal to the all-live kernel's
    on the same buffers (up to the sign of a zero).  Times in a CUDA
    graph, warm in L2 (set 0 again and again) and cold (the three sets
    in turn): the routed form (also in CUDA events), the all-live form
    on the full sets and torch.bmm (TF32 off) on the routed sets; the
    bounds over the live rows (2 x live rows x K x N operations at the
    f32 peak, or the bytes: the live rows, the tables of experts with a
    live row, the whole output) and over the full C; the kernel's live
    units against the card's resident blocks (two an SM).  Returns the
    sums over the three tables."""
    import torch
    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import sr_matmul as kmm
    E, live_n, busy = rows.numel(), int(rows.sum()), int((rows > 0).sum())
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("ms", "plain", "lib", "graph", "cold", "lib_graph", "lib_cold",
            "all_live_graph", "all_live_cold", "bound", "bound_full")
    tot = {k: 0.0 for k in keys}
    worst = 0.0
    for name, routed, full in tables:
        if role == "up":
            x, dy = routed[0]
            K, N = x.shape[2], dy.shape[2]
            run = lambda o: koa.outer_accum_batched(o[0], o[1], rows=rows)
            every = lambda o: koa.outer_accum_batched(o[0], o[1])
            lib = lambda o: torch.bmm(o[0].transpose(1, 2), o[1])
            plain = lambda: koa.outer_accum_batched_plain(x, dy, rows=rows)
            out_elems, wk, wn = E * K * N, K, N
            nb_live = 4 * (live_n * (K + N) + out_elems)
            nb_full = 4 * (E * C * (K + N) + out_elems)
            gx, gy, sp = koa.batched_f32_plan(E, C, K, N).grid(K, N, C)
            # every unit runs, its reduction cut at the live tokens
            units = live_units = E * gx * gy * sp
        else:
            a, w = routed[0]
            trans_b = role == "bp"
            run = lambda o: kmm.sr_matmul_batched(o[0], o[1],
                                                  trans_b=trans_b, rows=rows)
            every = lambda o: kmm.sr_matmul_batched(o[0], o[1],
                                                    trans_b=trans_b)
            lib = lambda o: torch.bmm(o[0], o[1].transpose(1, 2) if trans_b
                                      else o[1])
            plain = lambda: kmm.sr_matmul_batched_plain(
                a, w, trans_b=trans_b, rows=rows)
            kr, (wk, wn) = a.shape[2], w.shape[1:]
            m, n, k = C, (wk if trans_b else wn), kr
            nb_live = 4 * (live_n * kr + busy * wk * wn + E * C * n)
            nb_full = 4 * (E * C * kr + E * wk * wn + E * C * n)
            p = kmm.f32_plan(m, n, k, experts=E)
            gx, gy, sp = p.grid(m, n, k)
            units = E * gx * gy * sp
            # the units whose row tile holds a live row
            live_units = gx * sp * int(
                ((rows + p.bm - 1) // p.bm).clamp(0, gy).sum())
        # the output's block first holds NaN (the caching allocator hands
        # it to the kernel again): every element must be written
        poison = torch.full((E, m, n) if role != "up" else (E, wk, wn),
                            float("nan"), device="cuda")
        ptr = poison.data_ptr()
        del poison
        got = run(routed[0])
        want = plain()
        torch.cuda.synchronize()
        check(got.data_ptr() == ptr, f"experts:f32 {role} {name}: the "
              f"allocator did not hand the poisoned block back")
        check(bool(torch.isfinite(got).all()), f"experts:f32 {role} {name}: "
              f"elements left unwritten (NaN) with live rows")
        if role != "up":
            dead = ~kmm.live_rows(rows, C)
            check(not bool(got[dead].any()), f"experts:f32 {role} {name}: "
                  f"a dead row is not 0")
        ea, _ = errs(got, want)
        worst = max(worst, ea)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"experts:f32 {role} {name} (routed, C={C}): max abs err "
              f"{ea:.3g}")
        check(torch.equal(got, every(routed[0])),
              f"experts:f32 {role} {name}: the live rows' result differs "
              f"from the all-live kernel's on the same buffers")
        del got, want
        b_live, by = bound(nb_live, 2 * live_n * wk * wn, peaks, f32=True)
        b_full, _ = bound(nb_full, 2 * E * C * wk * wn, peaks, f32=True)
        t = {"ms": time_ms(lambda: run(routed[0])),
             "plain": time_ms(plain, iters=3, warmup=1),
             "lib": time_ms(lambda: lib(routed[0])),
             "graph": time_graph_ms(lambda: run(routed[0])),
             "cold": time_graph_ms(lambda: [run(o) for o in routed],
                                   iters=2) / len(routed),
             "lib_graph": time_graph_ms(lambda: lib(routed[0])),
             "lib_cold": time_graph_ms(lambda: [lib(o) for o in routed],
                                       iters=2) / len(routed),
             "all_live_graph": time_graph_ms(lambda: every(full[0])),
             "all_live_cold": time_graph_ms(lambda: [every(o) for o in full],
                                            iters=2) / len(full),
             "bound": b_live, "bound_full": b_full}
        for kk, v in t.items():
            tot[kk] += v
        print(f"[experts:f32] {role} {name:<12} C={C} ({live_n} of {E * C} "
              f"rows live; {live_units} live of {units} units, "
              f"{live_units / slots:.2f} waves of {slots} blocks): graph "
              f"warm / cold: routed {t['graph']:.4f} / {t['cold']:.4f}, "
              f"all-live {t['all_live_graph']:.4f} / "
              f"{t['all_live_cold']:.4f}, torch.bmm {t['lib_graph']:.4f} / "
              f"{t['lib_cold']:.4f}; bound live rows {b_live:.4f} ({by}), "
              f"full C {b_full:.4f}; events: routed {t['ms']:.4f}, plain "
              f"{t['plain']:.4f}, torch.bmm {t['lib']:.4f}; max_abs_err "
              f"{ea:.3g}; == all-live kernel; a NaN-poisoned output "
              f"rewritten, dead rows 0")
    print(f"[experts:f32] {role}, one layer's three tables at C={C}, graph "
          f"warm / cold: routed {tot['graph']:.4f} / {tot['cold']:.4f}, "
          f"all-live {tot['all_live_graph']:.4f} / "
          f"{tot['all_live_cold']:.4f}, torch.bmm {tot['lib_graph']:.4f} / "
          f"{tot['lib_cold']:.4f}; bound live rows {tot['bound']:.4f} "
          f"({tot['bound'] / tot['graph']:.2f} of it reached), full C "
          f"{tot['bound_full']:.4f}")
    return {**tot, "max_abs_err": worst, "live_rows": live_n,
            "rows": E * C}


def phase_train_granite_fp32(gcfg, n: int = 4) -> None:
    """n full-width granite-moe-1b-a400m layers under fp32 (remat block,
    B=4, S=256, random RMSNorm scales, TF32 off): step-0 loss and every
    gradient leaf on the cuda backend (the f32 batched kernels for the
    expert tables, the f32 path for the rest) against the reference
    backend (f64-accumulated products), the reference run held to the
    cuda run's expert selection (each call's own probabilities weigh
    it): the loss within TRAIN_RTOL's step-1 bound and each leaf's
    largest difference within GRAD_REL of its largest value.  The cuda
    step launches, a layer, 9 sr_matmul:batched (three tables' FF, remat
    FF and BP) and 3 outer_accum:batched, every product on the f32 path.
    Printed beside it: the tokens whose k + 1 largest router
    probabilities lie nearer than TIE_GAP, and how many routings the
    reference's own top-k would have chosen otherwise."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    label = "train:granite:fp32"
    cfg4 = dataclasses.replace(gcfg, n_layers=n)
    shape = ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train")
    program = compile_program(cfg4, shape, precision="fp32")
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = tfm.init(gen, cfg4)
    for norm in (params["groups"]["u0"]["norm1"],
                 params["groups"]["u0"]["norm2"], params["final_norm"]):
        norm["scale"].copy_(1.0 + 0.1 * torch.randn(
            norm["scale"].shape, generator=gen, device="cuda"))
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in SyntheticLM(cfg4, shape).batch_at(0).items()}
    counters = _counters()
    for c in counters.values():
        c.reset()
    chosen, flips, near = [], [], []
    t0 = time.monotonic()
    with _routing(record=chosen, near_ties=near):
        lc, gc = _step0_grads(cfg4, program, "cuda", params, batch0,
                              torch.float32)
    torch.cuda.synchronize()
    cc = {k: c.n for k, c in counters.items()}
    t1 = time.monotonic()
    with _routing(record=flips, replay=chosen, own_weights=True):
        lr, gr = _step0_grads(cfg4, program, "reference", params, batch0,
                              torch.float32)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    leaf, rel = _grad_rel(gc, gr)
    l_rel = abs(lc / lr - 1)
    print(f"[{label}] {n} layers fp32 remat=block B={TRAIN_B} S={TRAIN_S} "
          f"step 0: cuda loss {lc!r} ({t1 - t0:.1f}s), reference loss "
          f"{lr!r} ({t2 - t1:.1f}s) with the cuda run's expert selection "
          f"(its own top-k set differs on {_flips(flips)} token routings; "
          f"{sum(a for a, _ in near)} of {sum(b for _, b in near)} have "
          f"their k + 1 largest probabilities nearer than {TIE_GAP}); loss "
          f"rel {l_rel:.3g}; worst leaf gradient rel {rel:.3g} ({leaf})")
    print(f"[{label}] the cuda step's launches "
          f"{ {k: v for k, v in cc.items() if v} }")
    check(math.isfinite(lc) and l_rel <= TRAIN_RTOL[0],
          f"{label} step-0 loss: cuda {lc} vs reference {lr} (rtol "
          f"{TRAIN_RTOL[0]})")
    check(rel < GRAD_REL, f"{label} step-0 gradient of {leaf}: rel "
          f"{rel:.3g} (gate {GRAD_REL})")
    want = {"sr_matmul:batched": 3 * 3 * n, "outer_accum:batched": 3 * n,
            "sr_matmul:sm90": 0, "outer_accum:sm90": 0,
            "sr_matmul:generic": 0, "outer_accum:generic": 0}
    check(all(cc[k] == v for k, v in want.items())
          and cc["sr_matmul:f32"] == cc["sr_matmul"]
          and cc["outer_accum:f32"] == cc["outer_accum"],
          f"{label} step 0 launched {cc}, want {want}, every product f32")
    del gc, gr, params


def phase_train_granite_fp32_full() -> dict:
    """granite-moe-1b-a400m under fp32 at full width through launch.train
    (24 layers, B=4, S=256, adamw, remat block), 3 steps: every step
    launches 216 sr_matmul:batched and 72 outer_accum:batched, all on
    the f32 path, none on sm90 or generic."""
    return phase_train_fp32_full(
        GRANITE, "train:granite:fp32:full",
        {"sr_matmul:batched": 3 * 3 * GRANITE_LAYERS,
         "outer_accum:batched": 3 * GRANITE_LAYERS})


# ---------------------------------------------------------------------------
# jamba-v0.1-52b: the Mamba mixer, the 1:7 attention interleave and a MoE
# FF every second layer, one period of the pattern at full width; and the
# reduced arctic-480b (a MoE FF with a dense FF beside it)
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
# one period of jamba's pattern: 8 of 32 layers (1 attention, 7 Mamba, 4
# MoE and 4 dense FFs; 13.30 B parameters, 24.8 GiB in bf16; all 32 are
# 96 GiB and do not fit the card)
JAMBA_LAYERS = 8
JAMBA_SEED = 7
# selective_scan against its plain version: expf and an f32 sum over the
# N state values against the plain version's f64 ones, within 1e-5 of
# the largest output
SCAN_REL = 1e-5
# its cases (B, S) at di 8192, N 16: one slot's decode step and chunks
# (7 tokens: a ragged tile; 32: a PREFILL chunk; 512: the longest
# prompt), a DECODE step of SERVE_SLOTS slots and jamba training's
# forward (4 x 256); the bf16 chunk and step are the served shapes, timed
# and summed in the kernels line
SCAN_CASES = ((1, 1), (1, 7), (1, 32), (1, 512), (SERVE_SLOTS, 1), (4, 256))
SCAN_MAIN = ((1, 32), (SERVE_SLOTS, 1))
# the served ring: jamba's attention window cut to 64, 4 requests whose
# prompts of 96-200 tokens wrap it inside their PREFILL chunks
RING_WINDOW = 64
# the reduced arctic's parameters: a generator of its own at each seed
ARCTIC_SEEDS = (0, 1, 2, 3)


def jamba_params(cfg, gen) -> dict:
    """bf16 parameters of a jamba config drawn leaf by leaf from `gen`
    (tfm.init with dtype bf16: no f32 tree), with random norm scales,
    Mamba dt_bias (N(0, 0.3^2)) and D (0.5-1.5)."""
    import torch
    from repro_torch.models import transformer as tfm
    params = tfm.init(gen, cfg, dtype=torch.bfloat16)
    rnd = lambda t, base, std: t.copy_(base + std * torch.randn(  # noqa
        t.shape, generator=gen, device="cuda"))
    for up in params["groups"].values():
        for k in ("norm1", "norm2"):
            rnd(up[k]["scale"], 1.0, 0.1)
        if "mamba" in up:
            rnd(up["mamba"]["dt_bias"], 0.0, 0.3)
            up["mamba"]["D"].copy_(0.5 + torch.rand(
                up["mamba"]["D"].shape, generator=gen, device="cuda"))
    rnd(params["final_norm"]["scale"], 1.0, 0.1)
    return params


def init_jamba() -> tuple:
    """(config, bf16 params) of jamba's first period at full width, drawn
    leaf by leaf as the engine draws them (tfm.init with dtype bf16: the
    f32 tree, 49.5 GiB, never exists) from a generator of its own (the
    gated readings do not move with what earlier phases draw), with
    random norm scales, Mamba dt_bias (N(0, 0.3^2)) and D (0.5-1.5)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(JAMBA_SEED)
    cfg = dataclasses.replace(get_config(JAMBA), n_layers=JAMBA_LAYERS)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = jamba_params(cfg, gen)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[init] {JAMBA}, {cfg.n_layers} of 32 layers at full width: "
          f"{cfg.param_count()} params in {time.monotonic() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held, init "
          f"peak {peak:.2f} GiB")
    return cfg, params


def _scan_inputs(gen, B, S, di, N, xdt):
    import torch
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa
    x = rnd(B, S, di).to(xdt)
    dt = torch.nn.functional.softplus(rnd(B, S, di) - 1.0)
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(
        di, 1)
    Bm, Cm = rnd(B, S, N), rnd(B, S, N)
    D = 0.5 + torch.rand(di, generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, D, 0.5 * rnd(B, di, N)


def phase_selective_scan(peaks) -> dict:
    """selective_scan at jamba's shapes (di 8192, N 16) from a nonzero
    state, x in bf16 (as served) and in f32: against the plain version
    within SCAN_REL of the largest output and state, two calls bit-equal;
    times by events and in a CUDA graph beside the plain version's and
    the bound: the largest of the bytes (x, dt, B, C, y, A, D and the
    state read and written) at the card's memory rate, the f32
    operations (six a state value and token) at its f32 peak and the
    exps (one a state value and token) at the SFU's rate, a sixteenth of
    the f32 peak (16 a clock per SM against 128 FMAs)."""
    import torch
    from repro_torch.kernels import selective_scan as kss
    di, N = 8192, 16
    gen = torch.Generator(device="cuda").manual_seed(41)
    tot = dict.fromkeys(("ms", "graph", "plain", "bound"), 0.0)
    worst, by_ms = 0.0, {"bytes": 0.0, "operations": 0.0}
    for (B, S), xdt in itertools.product(SCAN_CASES, (torch.bfloat16,
                                                      torch.float32)):
        x, dt, A, Bm, Cm, D, h0 = _scan_inputs(gen, B, S, di, N, xdt)
        st = h0.clone()
        c0 = kss.COUNTER.n
        y, _ = kss.selective_scan(x, dt, A, Bm, Cm, D, st)
        check(kss.COUNTER.n == c0 + 1, "selective_scan: not one launch")
        yp, hp = kss.selective_scan_plain(x, dt, A, Bm, Cm, D, h0)
        torch.cuda.synchronize()
        tag = f"B={B} S={S} x {str(xdt).split('.')[-1]}"
        ey = float((y - yp).abs().max() / yp.abs().max())
        eh = float((st - hp).abs().max() / hp.abs().max())
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"selective_scan {tag}: non-finite output")
        check(ey <= SCAN_REL and eh <= SCAN_REL, f"selective_scan {tag}: "
              f"y {ey:.3g}, state {eh:.3g} of the largest (gate "
              f"{SCAN_REL})")
        st2 = h0.clone()
        y2, _ = kss.selective_scan(x, dt, A, Bm, Cm, D, st2)
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"selective_scan {tag}: two calls differ")
        worst = max(worst, float((y - yp).abs().max()))
        call = lambda: kss.selective_scan(x, dt, A, Bm, Cm, D, st)  # noqa
        ms = time_ms(call)
        g_ms = time_graph_ms(call)
        plain = time_ms(lambda: kss.selective_scan_plain(
            x, dt, A, Bm, Cm, D, h0), iters=2, warmup=1)
        nbytes = (B * S * di * (x.element_size() + 4 + 4) + 2 * 4 * B * S * N
                  + 4 * di * (N + 1) + 2 * 4 * B * di * N)
        b_ms, by = bound(nbytes, 6 * B * S * di * N, peaks, f32=True)
        e_ms = B * S * di * N / (peaks[2] / 16) * 1e3
        if e_ms > b_ms:
            b_ms, by = e_ms, "operations"
        p = kss.selective_scan_plan(B, S, di, N)
        print(f"[selective_scan] {tag:<22} di={di} N={N} from state: kernel "
              f"{ms:.4f}ms (in a CUDA graph {g_ms:.4f}ms) plain {plain:.4f}ms"
              f" bound {b_ms:.4f}ms ({'exps' if b_ms == e_ms else by}); y "
              f"{ey:.3g}, state {eh:.3g} of the largest; 2 calls bit-equal; "
              f"plan {p.lanes} lanes a channel, {p.channels} channels a "
              f"block, tile {p.tile}: grid {p.grid} x {p.threads} threads")
        if (B, S) in SCAN_MAIN and xdt == torch.bfloat16:
            tot["ms"] += ms
            tot["graph"] += g_ms
            tot["plain"] += plain
            tot["bound"] += b_ms
            by_ms[by] += b_ms
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan.cu",
            "replaces": "src/repro/models/ssm.py:195",
            "tpu_kernel": None, "max_abs_err": worst, "ms": tot["ms"],
            "kernel_ms": tot["ms"], "graph_ms": tot["graph"],
            "plain_ms": tot["plain"], "library_ms": None,
            "bound_ms": tot["bound"],
            "bound_by": max(by_ms, key=by_ms.get),
            "shapes": "jamba-v0.1-52b (di 8192, N 16), bf16 x: a 32-token "
                      "PREFILL chunk of one slot + a DECODE step of 32 "
                      "slots, from a carried state"}


def phase_fused_ffn_served(cfg, params, peaks, label: str,
                           unit: str) -> dict:
    """fused_ffn as `cfg`'s served decode calls it on an SSM unit with a
    dense FF: the first layer of `unit`, SERVE_SLOTS rows, against the
    plain version within Y_TOL, its planned launches a call, two calls
    bit-equal, its CUDA-graph time beside its bound."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    B, d, f = SERVE_SLOTS, cfg.d_model, cfg.d_ff
    u = _layer0(params["groups"][unit])
    n2 = u.get("norm2") or {}
    w = dict(w_in=u["ffn"]["ffn_in"], w_out=u["ffn"]["ffn_out"],
             norm2_scale=n2.get("scale"), norm2_bias=n2.get("bias"))
    kw = dict(norm_kind=cfg.norm, act=cfg.act)
    gen = torch.Generator(device="cuda").manual_seed(42)
    x = (4 * torch.randn((B, d), generator=gen, device="cuda")).bfloat16()
    l0 = kdf.FFN_LAUNCHES.n
    y = kdf.fused_ffn(x, **w, **kw)
    per_call = kdf.FFN_LAUNCHES.n - l0
    planned = launches_per_call(cfg)["fused_ffn"]
    check(per_call == planned == 3, f"{label}: {per_call} launches in a "
          f"call, plan {planned}")
    vec = lambda t, fill: (torch.full((d,), fill, device="cuda")  # noqa
                           if t is None else t.float())
    yp = kdf.fused_ffn_plain(x, n2s=vec(w["norm2_scale"], 1.0),
                             n2b=vec(w["norm2_bias"], 0.0), w_in=w["w_in"],
                             w_out=w["w_out"], tn=kdf._clip_block_n(256, f),
                             **kw)
    torch.cuda.synchronize()
    ea, _ = errs(y, yp)
    check(torch.allclose(y.float(), yp.float(), atol=Y_TOL, rtol=Y_TOL),
          f"{label}: max abs err {ea:.3g}")
    check(torch.equal(kdf.fused_ffn(x, **w, **kw), y),
          f"{label}: two calls differ")
    dev_ms = time_graph_ms(lambda: kdf.fused_ffn(x, **w, **kw))
    ff = w["w_in"].numel() + w["w_out"].numel()
    b_ms, by = bound(2 * ff + 2 * 2 * B * d + 4 * 2 * d, 2 * B * ff, peaks)
    print(f"[{label}] {cfg.name} unit {unit} (d {d}, d_ff {f} {cfg.act}, "
          f"{cfg.norm}) B={B}: max_abs_err {ea:.3g} within Y_TOL; "
          f"{per_call} launches a call; 2 calls bit-equal; in a CUDA graph "
          f"{dev_ms:.4f}ms bound {b_ms:.4f}ms ({by})")
    return {"max_abs_err": ea, "graph_ms": dev_ms, "bound_ms": b_ms,
            "bound_by": by, "launches_per_call": per_call}


def phase_ring_serve(cfg, params, label: str) -> None:
    """The served ring: `cfg` with its attention window cut to
    RING_WINDOW, 4 requests of 96-200 prompt tokens and 8 new tokens on 4
    slots, through the engine on the cuda backend (fused and per-op) and
    on the reference backend: every budget exact, no non-finite logit,
    the KV ring shorter than every prompt; tokens equal to the reference
    run's printed (random weights: near-tie argmaxes of bf16 and f64
    products may differ).  Then the teacher-forced comparison over a
    150-token prompt (phase_chunk_vs_reference, gated)."""
    import dataclasses
    from repro_torch.serving import build_engine, latency_stats, poisson_trace
    t0 = time.monotonic()
    ring = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, window=RING_WINDOW))
    trace = poisson_trace(4, vocab_size=cfg.vocab_size, prompt_lens=(96, 200),
                          gen_tokens=8, mean_interarrival_steps=2.0, seed=1)
    check(all(len(r.prompt) > RING_WINDOW for r in trace),
          f"{label}: a prompt within the ring")
    runs = {}
    for backend, fused in (("cuda", True), ("cuda", False),
                           ("reference", False)):
        tag = f"{label}:{backend}:{'fused' if fused else 'per-op'}"
        eng = build_engine(ring, n_slots=4, max_len=208, prefill_chunk=32,
                           kernel_backend=backend, fused_decode=fused,
                           device="cuda", params=params)
        check(eng.cache["u0"]["attn"]["k"].shape[2] == RING_WINDOW,
              f"{tag}: KV ring of {eng.cache['u0']['attn']['k'].shape[2]}")
        res, wall = _serve_once(eng, trace)
        _check_served(res, trace, eng, tag)
        st = latency_stats(eng.events)
        print(f"[{tag}] {len(trace)} requests, prompts "
              f"{sorted(len(r.prompt) for r in trace)}, window {RING_WINDOW}:"
              f" steps={eng.step_count} wall={wall:.3f}s tok/s="
              f"{st['tokens'] / wall:.2f}")
        runs[tag] = res
        del eng
    want = runs[f"{label}:reference:per-op"]
    for tag, res in runs.items():
        same, first, n = _agree(res, want)
        print(f"[{tag}] against the reference backend: {same}/{n} tokens, "
              f"first tokens {first}/{len(trace)} (not gated)")
    phase_chunk_vs_reference(ring, params, label, f"{JAMBA}:ring",
                             prompt=150, steps=8)
    print(f"[{label}] phase {time.monotonic() - t0:.1f}s")


def phase_arctic_reduced() -> None:
    """The reduced arctic-480b (2 layers, d 64, 4 experts, top-2, the
    dense FF beside them) on the card, its parameters drawn from a
    generator of its own at each of ARCTIC_SEEDS: one 32-token chunk of 4
    rows on the cuda backend against the reference backend (routing
    held), gated by CHUNK_MAX; then the control, the last seed's cuda run
    with every layer's dense FF left out (its out table zero), which must
    read above the gate.  At full width one f32 expert table is 35.7 GB:
    arctic does not fit one card."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tfm
    acfg = get_reduced("arctic-480b")
    for seed in ARCTIC_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = tfm.init(gen, acfg, dtype=torch.bfloat16)
        for up in params["groups"].values():
            for k in ("norm1", "norm2"):
                up[k]["scale"].copy_(1 + 0.1 * torch.randn(
                    up[k]["scale"].shape, generator=gen, device="cuda"))
        phase_chunk_vs_reference(acfg, params,
                                 f"chunk:arctic:reduced:seed={seed}")
    cut = {**params, "groups": {u: {**g, "ffn": {
        **g["ffn"], "ffn_out": torch.zeros_like(g["ffn"]["ffn_out"])}}
        for u, g in params["groups"].items()}}
    d = phase_chunk_vs_reference(acfg, cut, "chunk:arctic:reduced:control",
                                 ref_params=params, gate=False)["gap"]
    check(d > CHUNK_MAX[acfg.name], f"chunk:arctic:reduced: the control "
          f"(dense FF left out) reads {d:.4f}, within the gate "
          f"{CHUNK_MAX[acfg.name]}")


# ---------------------------------------------------------------------------
# jamba-v0.1-52b training, cut to one card: selective_scan_bwd, step 0
# against the reference backend, the main path and its memory
# ---------------------------------------------------------------------------

# selective_scan_bwd against its plain version (f64 sums): f32 sums in
# another order, each output within this share of its own largest value
SCAN_BWD_REL = 1e-4
# (label, B, S, di, N, dt A <= -150, x dtype): jamba training's shape with
# bf16 x (the main path's; timed) and f32 x, the step-0 check's 2 x 64,
# one token, one partial tile, decay so strong that exp(dt A) is 0, and
# ragged widths at N 4 and 8
SCAN_BWD_CASES = (("train", 4, 256, 8192, 16, False, "bfloat16"),
                  ("train f32", 4, 256, 8192, 16, False, "float32"),
                  ("step0", 2, 64, 8192, 16, False, "bfloat16"),
                  ("S=1", 4, 1, 8192, 16, False, "bfloat16"),
                  ("S=5", 2, 5, 8192, 16, False, "bfloat16"),
                  ("strong", 4, 256, 8192, 16, True, "bfloat16"),
                  ("N=4", 3, 45, 300, 4, False, "float32"),
                  ("N=8", 2, 37, 200, 8, False, "bfloat16"))
# f32 operations the gradient needs a state value and token, each product
# that two terms share counted once: h recomputed (4: dt A, a h, (dt x) B,
# the add), G's update (3), dx's G B and its sum (2), ddt's G (a h), A
# times it and the sum (3; its x B term is x times dx's sum over n), dA's
# dt (G a h) and its sum (2), dB and dC (2 each)
SCAN_BWD_FLOPS = 18
# [train:jamba:step0]: the cut at full width, B x S tokens, the weights
# drawn from each of these seeds
JAMBA_STEP0_B, JAMBA_STEP0_S = 2, 64
JAMBA_STEP0_SEEDS = (JAMBA_SEED + 1, JAMBA_SEED + 2, JAMBA_SEED + 3)
# the jamba training run's learning rate: at the CLI's 3e-4 the loss of
# the cut rises after step 0 on both backends (11.83 to 28.86 on the
# cuda backend, 28.63 on the reference backend); at 1e-5 it falls
JAMBA_LR = 1e-5


def phase_selective_scan_bwd(peaks) -> dict:
    """selective_scan_bwd (csrc/selective_scan_bwd.cu) against
    selective_scan_bwd_plain on the card at SCAN_BWD_CASES: each of dx,
    ddt, dA, dB, dC and dD within SCAN_BWD_REL of its largest value,
    finite, two calls bit-equal.  Jamba training's shape (B 4, S 256, di
    8192, N 16, bf16 x) is timed in events and in a CUDA graph beside the
    plain version and its bound: the bytes (x, dt, dy, B, C, A and D
    read, the six gradients written) at the memory rate, against
    SCAN_BWD_FLOPS f32 operations a state value and token at the f32
    peak and one exp a state value and token at the SFU's rate, a
    sixteenth of it."""
    import torch
    from repro_torch.kernels import selective_scan as kss
    gen = torch.Generator(device="cuda").manual_seed(43)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    row, worst_abs, worst_rel = None, 0.0, 0.0
    for label, B, S, di, N, strong, xdt in SCAN_BWD_CASES:
        x, dt, A, Bm, Cm, D, _ = _scan_inputs(gen, B, S, di, N,
                                              getattr(torch, xdt))
        if strong:
            dt = dt + 300.0
            check(not bool(torch.exp(dt[..., None] * A).any()),
                  f"selective_scan_bwd {label}: exp(dt A) is not 0")
        dy = torch.randn((B, S, di), generator=gen, device="cuda")
        args = (x, dt, A, Bm, Cm, D, dy)
        c0 = kss.BWD_COUNTER.n
        got = kss.selective_scan_bwd(*args)
        check(kss.BWD_COUNTER.n == c0 + 1, "selective_scan_bwd: not one "
              "launch")
        again = kss.selective_scan_bwd(*args)
        want = kss.selective_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        rels = {}
        for nm, g, g2, wv in zip(names, got, again, want):
            check(bool(torch.isfinite(g).all()),
                  f"selective_scan_bwd {label}: non-finite {nm}")
            check(torch.equal(g, g2), f"selective_scan_bwd {label}: two "
                  f"calls differ in {nm}")
            err = float((g - wv).abs().max())
            big = float(wv.abs().max())
            rels[nm] = err / max(big, 1e-30)
            worst_abs = max(worst_abs, err)
            check(err <= SCAN_BWD_REL * big,
                  f"selective_scan_bwd {label} (B={B} S={S} di={di} N={N}):"
                  f" {nm} max abs err {err:.3g} against its largest "
                  f"{big:.3g} (share {SCAN_BWD_REL})")
        worst_rel = max(worst_rel, max(rels.values()))
        print(f"[selective_scan_bwd] {label:<9} B={B} S={S} di={di} N={N} x "
              f"{xdt}: max abs err / largest "
              f"{', '.join(f'{n} {v:.3g}' for n, v in rels.items())}; "
              f"2 calls bit-equal")
        del got, again, want
        if label != "train":
            continue
        ms = time_ms(lambda: kss.selective_scan_bwd(*args), iters=10)
        g_ms = time_graph_ms(lambda: kss.selective_scan_bwd(*args),
                             iters=10)
        plain = time_ms(lambda: kss.selective_scan_bwd_plain(*args),
                        iters=2, warmup=1)
        n_state = B * S * di * N
        nbytes = (B * S * di * (x.element_size() + 4 * 4)
                  + 4 * 4 * B * S * N + 2 * 4 * di * (N + 1))
        b_ms, by = bound(nbytes, SCAN_BWD_FLOPS * n_state, peaks, f32=True)
        e_ms = n_state / (peaks[2] / 16) * 1e3
        if e_ms > b_ms:
            b_ms, by = e_ms, "operations"
        p = kss.selective_scan_bwd_plan(B, S, di, N)
        print(f"[selective_scan_bwd] {label} B={B} S={S} di={di} N={N}: "
              f"kernel {ms:.4f}ms (in a CUDA graph {g_ms:.4f}ms) plain "
              f"{plain:.4f}ms bound {b_ms:.4f}ms ({by}: {nbytes / 1e6:.1f} "
              f"MB, {SCAN_BWD_FLOPS * n_state / 1e9:.2f} GFLOP f32, "
              f"{n_state / 1e6:.0f} M exps at {e_ms:.4f}ms); graph / bound "
              f"{g_ms / b_ms:.2f}; selective_scan_bwd_plan: {p.lanes} lanes "
              f"a channel, {p.channels} channels a block, tile {p.tile}: "
              f"grid {p.grid} x {p.threads} threads, {p.smem} B shared")
        row = {"name": "selective_scan_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
               "replaces": "src/repro/models/ssm.py:195",
               "tpu_kernel": None, "ms": ms, "kernel_ms": ms,
               "graph_ms": g_ms, "plain_ms": plain, "library_ms": None,
               "bound_ms": b_ms, "bound_by": by,
               "shapes": "jamba-v0.1-52b training: B=4, S=256, di=8192, "
                         "N=16, bf16 x, from a zero state; one call a "
                         "Mamba layer a step"}
    row["max_abs_err"] = worst_abs
    row["max_rel_of_largest"] = worst_rel
    return row


def phase_train_jamba_step0(cfg, seed: int) -> None:
    """`cfg` (jamba cut to one card: one period at full width, 4 experts
    top-2) at step 0 (remat block, JAMBA_STEP0_B x JAMBA_STEP0_S tokens,
    random weights, norm scales, dt_bias and D from `seed`), every run
    held to the expert selection of the first (each call's own
    probabilities weigh it):

    - paper_sr_bf16, the cuda backend against the reference backend: the
      loss within GRANITE_LOSS_RTOL, each leaf's L2 distance within
      GRANITE_GRAD_L2 of its L2 norm, as granite's step 0 is held;
    - fp32 on the same values in f32, the cuda backend (f32 sr_matmul and
      its batched form, selective_scan and selective_scan_bwd on f32 x)
      against the reference backend: the loss within TRAIN_RTOL[0], each
      leaf within GRAD_REL of its largest value.

    Each cuda step launches each Mamba layer's scan twice (forward, remat
    recompute) and its backward once, each MoE table's FF, remat FF and
    BP on sr_matmul_batched and its UP on outer_accum_batched: on the
    sm90 path under paper_sr_bf16, on the f32 path under fp32, never on
    :generic."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.core.tree import tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as tfm
    B, S = JAMBA_STEP0_B, JAMBA_STEP0_S
    tag = f"train:jamba:step0:seed={seed}"
    shape = ShapeConfig("smoke", S, B, "train")
    program = compile_program(cfg, shape, precision="paper_sr_bf16")
    program32 = compile_program(cfg, shape, precision="fp32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = jamba_params(cfg, gen)
    batch0 = {k: torch.as_tensor(v, device="cuda")
              for k, v in SyntheticLM(cfg, shape).batch_at(0).items()}
    pattern = tfm.layer_pattern(cfg)
    n_mamba = sum(u.mixer == "mamba" for u in pattern)
    n_moe = sum(u.ffn == "moe" for u in pattern)
    counters = _counters()
    chosen, flips, secs = [], [], {}

    def run(backend, prog, tree, dtype, record=None):
        for c in counters.values():
            c.reset()
        t0 = time.monotonic()
        held = (_routing(record=chosen) if record is None else
                _routing(record=record, replay=chosen, own_weights=True))
        with held:
            loss, grads = _step0_grads(cfg, prog, backend, tree, batch0,
                                       dtype, f32=dtype == torch.float32)
        torch.cuda.synchronize()
        secs[(backend, dtype)] = time.monotonic() - t0
        return loss, grads, {k: c.n for k, c in counters.items()}

    lc, gc, cc = run("cuda", program, params, torch.bfloat16)
    lr, gr, _ = run("reference", program, params, torch.bfloat16, flips)
    l2 = {k: float((gc[k].float() - gr[k].float()).norm()
                   / gr[k].float().norm().clamp_min(1e-30)) for k in gr}
    worst = max(l2, key=l2.get)
    params32 = tree_map(lambda p: p.float(), params)
    del params, gc, gr
    torch.cuda.empty_cache()
    lt, gt, _ = run("reference", program32, params32, torch.float32, [])
    lf, gf, cf = run("cuda", program32, params32, torch.float32, [])
    del params32
    f32_leaf, f32_rel = _grad_rel(gf, gt)
    l_rel, lf_rel = abs(lc / lr - 1), abs(lf / lt - 1)
    print(f"[{tag}] {cfg.n_layers} layers, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k} ({cfg.param_count()} params) remat=block "
          f"B={B} S={S}, the cuda bf16 run's expert selection held (the "
          f"reference's own top-k set differs on {_flips(flips)} token "
          f"routings, each layer's forward and remat recompute); seconds "
          + ", ".join(f"{b} {str(d).split('.')[-1]} {t:.1f}"
                      for (b, d), t in secs.items()))
    print(f"[{tag}] paper_sr_bf16: cuda loss {lc!r}, reference {lr!r}, loss "
          f"rel {l_rel:.3g}; cuda vs reference, worst leaf L2 rel "
          f"{l2[worst]:.4f} ({worst}); per leaf "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(l2.items())))
    print(f"[{tag}] fp32: cuda loss {lf!r}, reference {lt!r}, rel "
          f"{lf_rel:.3g}; worst leaf max abs err / largest {f32_rel:.3g} "
          f"({f32_leaf}); launches bf16 "
          f"{ {k: v for k, v in cc.items() if v} }, fp32 "
          f"{ {k: v for k, v in cf.items() if v} }")
    check(math.isfinite(lc) and l_rel <= GRANITE_LOSS_RTOL,
          f"{tag} loss: cuda {lc} vs reference {lr} (rtol "
          f"{GRANITE_LOSS_RTOL})")
    check(l2[worst] <= GRANITE_GRAD_L2, f"{tag} gradient of {worst}: L2 "
          f"rel {l2[worst]:.4f} (gate {GRANITE_GRAD_L2})")
    check(math.isfinite(lf) and lf_rel <= TRAIN_RTOL[0],
          f"{tag} fp32 loss: cuda {lf} vs reference {lt} (rtol "
          f"{TRAIN_RTOL[0]})")
    check(f32_rel < GRAD_REL, f"{tag} fp32 gradient of {f32_leaf}: rel "
          f"{f32_rel:.3g} (gate {GRAD_REL})")
    want = {"selective_scan": 2 * n_mamba, "selective_scan_bwd": n_mamba,
            "sr_matmul:batched": 3 * 3 * n_moe,
            "outer_accum:batched": 3 * n_moe, "sr_matmul:generic": 0,
            "outer_accum:generic": 0}
    for name, counts, path, off in (("bf16", cc, "sm90", "f32"),
                                    ("fp32", cf, "f32", "sm90")):
        need = dict(want, **{f"sr_matmul:{off}": 0, f"outer_accum:{off}": 0})
        check(all(counts[k] == v for k, v in need.items())
              and counts[f"sr_matmul:{path}"] == counts["sr_matmul"] > 0
              and counts[f"outer_accum:{path}"] == counts["outer_accum"] > 0,
              f"{tag} {name} launched {counts}, want {need} and every "
              f"product on :{path}")


def phase_train_jamba() -> dict:
    """jamba-v0.1-52b's training main path: launch.train on the card,
    which cuts it to one period at full width and 4 of its 16 experts
    (B=4, S=256, paper_sr_bf16, adamw at JAMBA_LR, remat block, no
    checkpoint: the state is 27 GiB), 8 steps; every step launches each
    of the 7 Mamba layers' scan twice (forward, remat recompute) and its
    backward once, and each of the 4 MoE units' three expert tables' FF,
    remat FF and BP on sr_matmul_batched and their UP on
    outer_accum_batched."""
    return phase_train(JAMBA, "train:jamba",
                       {"selective_scan": 14, "selective_scan_bwd": 7,
                        "sr_matmul:batched": 36, "outer_accum:batched": 12},
                       ckpt_every=0, lr=JAMBA_LR)


def print_targets(rows: dict) -> None:
    """The redesign's time targets against this run's yardsticks: met or
    missed (a missed target is reported, not failed)."""
    tr, oa = rows["sr_matmul:train"], rows["outer_accum"]
    targets = [
        ("sr_matmul:train FF + BP <= 2x torch.matmul", tr["ms"],
         2 * tr["library_ms"]),
        ("sr_matmul:train tied head's BP <= 0.25 ms", tr["head_bp_ms"], 0.25),
        ("outer_accum SR, 5 UP shapes <= 2x bound", oa["ms"],
         2 * oa["bound_ms"]),
    ]
    for arch, key in (("qwen2", "sr_matmul"), ("rwkv6", "sr_matmul:rwkv6")):
        r = rows[key]
        targets += [
            (f"sr_matmul PREFILL {arch} <= torch.matmul", r["ms"],
             r["library_ms"]),
            (f"sr_matmul PREFILL {arch} <= torch.matmul, in a CUDA graph",
             r["graph_ms"], r["library_graph_ms"])]
    # the f32 mainloop's redesign, against torch.matmul with TF32 off
    for key, what in (("sr_matmul:f32", "the ten FF + BP products"),
                      ("outer_accum:f32", "the five UP products")):
        r = rows[key]
        targets += [
            (f"{key} {what} <= 1.5x torch.matmul", r["ms"],
             1.5 * r["library_ms"]),
            (f"{key} {what} <= 1.5x torch.matmul, in a CUDA graph",
             r["graph_ms"], 1.5 * r["library_graph_ms"])]
    # the fused decode words' redesign: device time of one layer's call
    targets += [
        ("fused_attn_unit qwen2 layer, B=32 S=528, in a CUDA graph <= "
         "0.040 ms", rows["fused_attn_unit"]["graph_ms"], 0.040),
        ("fused_ffn rwkv6 layer, B=32, in a CUDA graph <= 0.045 ms",
         rows["fused_ffn"]["graph_ms"], 0.045)]
    # wkv6's redesign: bf16 r, k, v in a CUDA graph, cold in L2
    wk = rows["wkv6"]["per_shape"]
    targets += [
        ("wkv6 PREFILL chunk B=1 S=32, in a CUDA graph cold in L2 <= "
         "0.0060 ms", wk["chunk"]["graph_ms"], 0.0060),
        ("wkv6 DECODE step B=32, in a CUDA graph cold in L2 <= 0.0125 ms",
         wk["step"]["graph_ms"], 0.0125)]
    # wkv6_bwd's redesign: bf16 r, k, v at the training shape
    targets.append(("wkv6_bwd training shape B=4 S=256 H=32 hd=64, in a "
                    "CUDA graph <= 0.10 ms", rows["wkv6_bwd"]["graph_ms"],
                    0.10))
    # the bf16 batched expert products' redesign: a layer's three tables
    # with a seeded router's live rows, in a CUDA graph (warm), against
    # torch.bmm on the same buffers and twice the live-row bound
    ex, up = rows["sr_matmul:experts"], rows["outer_accum:experts"]
    for role in ("ff", "bp"):
        r = ex["train"][role]
        targets += [
            (f"experts {role} routed C=1024 <= torch.bmm", r["graph"],
             r["lib_graph"]),
            (f"experts {role} routed C=1024 <= 2x its live-row bound",
             r["graph"], 2 * r["bound"]),
            (f"experts {role} every row live <= the parent-equivalent "
             f"(f32 out + cast)", r["all_live_graph"], r["parent_graph"])]
    targets += [
        ("experts up routed C=1024 (SR) <= torch.bmm (no SR)",
         up["graph_ms"], up["library_graph_ms"]),
        ("experts up routed C=1024 <= 2x its live-row bound", up["graph_ms"],
         2 * up["bound_ms"]),
        ("experts PREFILL routed C=32 warm <= 0.0364 ms", ex["graph_ms"],
         0.0364),
        ("experts PREFILL routed C=32 cold in L2 <= 0.0509 ms",
         ex["cold_graph_ms"], 0.0509)]
    # the f32 batched expert products' redesign: a layer's three tables
    # with a seeded router's live rows, in a CUDA graph (warm), against
    # half of the all-rows kernel's time, torch.bmm on the same buffers
    # and twice the live-row bound; every row live within 5% of it
    f32 = {"ff": rows["sr_matmul:experts:f32"]["ff"],
           "bp": rows["sr_matmul:experts:f32"]["bp"],
           "up": rows["outer_accum:experts:f32"]["up"]}
    for role, r in f32.items():
        old = F32_EXPERTS_ALL_ROWS_GRAPH_MS[role]
        targets += [
            (f"experts:f32 {role} routed C=1024 <= 0.5x the all-rows "
             f"kernel's {old}",
             r["graph"], 0.5 * old),
            (f"experts:f32 {role} routed C=1024 <= torch.bmm", r["graph"],
             r["lib_graph"]),
            (f"experts:f32 {role} routed C=1024 <= 2x its live-row bound",
             r["graph"], 2 * r["bound"]),
            (f"experts:f32 {role} every row live <= 1.05x the all-rows "
             f"kernel's {old}",
             r["all_live_graph"], 1.05 * old)]
    for what, got, limit in targets:
        print(f"[targets] {what}: {got:.4f}ms against {limit:.4f}ms: "
              f"{'met' if got <= limit else 'MISSED'}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("[chip_smoke] FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print("[chip_smoke] FAIL: run from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    try:
        phase_build()
        cfg = get_config("qwen2-0.5b")
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.monotonic()
        params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
        # random nonzero norm scales and qkv bias (init makes them 1 and 0)
        u = params["groups"]["u0"]
        for leaf, base in ((u["norm1"]["scale"], 1.0),
                           (u["norm2"]["scale"], 1.0),
                           (u["attn"]["qkv_bias"], 0.0)):
            leaf.copy_(base + 0.1 * torch.randn(leaf.shape, generator=gen,
                                                device="cuda"))
        print(f"[init] qwen2-0.5b {cfg.param_count()} params in "
              f"{time.monotonic() - t0:.1f}s on {name}")
        rows = [phase_sr_matmul("sr_matmul", cfg.name,
                                qwen2_prefill_shapes(params), peaks,
                                ragged=True),
                phase_fused(cfg, params, peaks)]
        serve_counts = {"sr_matmul": phase_serve(cfg, params, "serve")}
        serve_counts["fused_attn_unit"] = serve_counts["sr_matmul"]
        tf_qwen2 = phase_fused_vs_perop(cfg, params, "serve")
        # speculative serving: k = SPEC_K with the default draft, fused and
        # per-op; the self-draft oracle; the bursty overload
        t_spec = time.monotonic()
        spec = phase_serve_spec(cfg, params, f"serve:spec:{cfg.name}",
                                modes=(True, False))
        spec_counts = {"sr_matmul": spec, "fused_attn_unit": spec}
        phase_spec_self_draft(cfg, params, "serve:spec:self-draft")
        phase_bursty(cfg, params, "serve:bursty")
        spec_wall = time.monotonic() - t_spec
        del params, u
        torch.cuda.empty_cache()

        rcfg = get_config("rwkv6-1.6b")
        t0 = time.monotonic()
        rparams = tl.cast_params(tfm.init(gen, rcfg), torch.bfloat16)
        # random layernorm scales and biases (init makes them 1 and 0)
        for norm in (rparams["groups"]["u0"]["norm1"],
                     rparams["groups"]["u0"]["norm2"], rparams["final_norm"]):
            for key, base in (("scale", 1.0), ("bias", 0.0)):
                norm[key].copy_(base + 0.1 * torch.randn(
                    norm[key].shape, generator=gen, device="cuda"))
        print(f"[init] rwkv6-1.6b {rcfg.param_count()} params in "
              f"{time.monotonic() - t0:.1f}s")
        rows += [phase_sr_matmul("sr_matmul:rwkv6", rcfg.name,
                                 rwkv6_prefill_shapes(rcfg, rparams), peaks),
                 phase_wkv6(peaks), phase_fused_ffn(rcfg, rparams, peaks)]
        rwkv_counts = phase_serve(rcfg, rparams, "serve:rwkv6")
        t_spec = time.monotonic()
        spec = phase_serve_spec(rcfg, rparams, f"serve:spec:{rcfg.name}")
        spec_wall += time.monotonic() - t_spec
        for k in ("sr_matmul:rwkv6", "wkv6", "fused_ffn"):
            spec_counts[k] = spec
        for k in ("sr_matmul:rwkv6", "wkv6", "fused_ffn"):
            serve_counts[k] = rwkv_counts
        tf_rwkv = phase_fused_vs_perop(rcfg, rparams, "serve:rwkv6")
        tf_rwkv_long = phase_fused_vs_perop(rcfg, rparams, "serve:rwkv6",
                                            prompt=512)
        worst_layer = phase_ffn_bisect(rcfg, rparams)
        check_fused_vs_perop({cfg.name: tf_qwen2, rcfg.name: tf_rwkv,
                              rcfg.name + ":512": tf_rwkv_long}, worst_layer)
        del rparams
        torch.cuda.empty_cache()

        # granite-moe-1b-a400m: the expert tables' batched PREFILL
        # products, the attention half of its fused decode, its serving;
        # then olmo-1b's and minitron-4b's fused decode and serving on the
        # dense path
        fused_row = next(r for r in rows if r["name"] == "fused_attn_unit")
        tf_served = {}
        for arch, tag in (("granite-moe-1b-a400m", "granite"),
                          ("olmo-1b", "olmo"), ("minitron-4b", "minitron")):
            scfg, sparams = init_served(arch, gen)
            if scfg.moe is not None:
                rows.append(phase_sr_matmul_experts(scfg, sparams, peaks))
            fused_row[tag] = phase_fused_served(
                scfg, sparams, peaks, f"fused_attn_unit:{tag}")
            counts = phase_serve(scfg, sparams, f"serve:{tag}")
            if scfg.moe is not None:
                serve_counts["sr_matmul:experts"] = counts
                t_spec = time.monotonic()
                spec_counts["sr_matmul:experts"] = phase_serve_spec(
                    scfg, sparams, f"serve:spec:{arch}")
                spec_wall += time.monotonic() - t_spec
            phase_chunk_vs_reference(scfg, sparams, f"serve:{tag}")
            tf_served[arch] = phase_fused_vs_perop(scfg, sparams,
                                                   f"serve:{tag}")
            del sparams
            torch.cuda.empty_cache()
        check_fused_vs_perop(tf_served)

        # jamba-v0.1-52b, one period at full width: the selective_scan
        # kernel, the fused words at its widths, its serving (the main
        # path: the scan on selective_scan, every product on sr_matmul's
        # sm90 path and its batched mode, fused_attn_unit and fused_ffn),
        # its chunk and decode against the reference backend, the
        # served ring; then the reduced arctic-480b
        t_jamba = time.monotonic()
        jcfg, jparams = init_jamba()
        rows += [phase_sr_matmul("sr_matmul:jamba", jcfg.name,
                                 jamba_prefill_shapes(jcfg, jparams), peaks,
                                 products="layer 0's attention and FF, "
                                          "layer 1's Mamba mixer"),
                 phase_sr_matmul_experts(jcfg, jparams, peaks, unit="u1",
                                         label="sr_matmul:experts:jamba",
                                         cs=(8, 32)),
                 phase_selective_scan(peaks)]
        fused_row["jamba"] = phase_fused_served(
            jcfg, jparams, peaks, "fused_attn_unit:jamba")
        next(r for r in rows if r["name"] == "fused_ffn")["jamba"] = \
            phase_fused_ffn_served(jcfg, jparams, peaks, "fused_ffn:jamba",
                                   "u2")
        jamba_counts = phase_serve(jcfg, jparams, "serve:jamba")
        for k in ("sr_matmul:jamba", "sr_matmul:experts:jamba",
                  "selective_scan"):
            serve_counts[k] = jamba_counts
        phase_chunk_vs_reference(jcfg, jparams, "chunk:jamba", prompt=32,
                                 steps=8)
        phase_ring_serve(jcfg, jparams, "serve:jamba:ring")
        del jparams
        torch.cuda.empty_cache()
        phase_arctic_reduced()
        torch.cuda.empty_cache()
        print(f"[jamba] the jamba and arctic phases in "
              f"{time.monotonic() - t_jamba:.1f}s on {smi}")
        # the speculative loop on the reference backend, bit for bit
        t_spec = time.monotonic()
        for arch in ("qwen2-0.5b", "rwkv6-1.6b", GRANITE):
            phase_spec_reference(arch, gen, "serve:spec:reference")
        spec_wall += time.monotonic() - t_spec
        print(f"[serve:spec] the speculative and bursty phases in "
              f"{spec_wall:.1f}s")

        rows += [*phase_sr_matmul_train(cfg, peaks),
                 *phase_outer_accum(cfg, peaks),
                 phase_sr_round(cfg, peaks)]
        torch.cuda.empty_cache()
        phase_train_fp32(cfg)
        torch.cuda.empty_cache()
        fp32_full = phase_train_fp32_full()
        torch.cuda.empty_cache()
        train = phase_train()
        phase_decode_launches({r["name"]: r for r in rows})
        torch.cuda.empty_cache()
        paper_rows = phase_paper(peaks)
        torch.cuda.empty_cache()
        rows.append(phase_wkv6_bwd(peaks))
        torch.cuda.empty_cache()
        phase_train_rwkv6_fp32(rcfg)
        torch.cuda.empty_cache()
        rwkv_train = phase_train_rwkv6()
        serve_counts["wkv6_bwd"] = rwkv_train["counts"]
        rows[-1]["launches_per_step"] = rwkv_train["per_step"]["wkv6_bwd"]
        print(f"[train:rwkv6] on {smi}")
        torch.cuda.empty_cache()
        phase_train_memory("rwkv6-1.6b", "train:rwkv6:memory")
        torch.cuda.empty_cache()

        # granite-moe-1b-a400m training: the expert tables' batched UP,
        # FF and BP; four layers against the reference backend and under
        # both remat modes; then the full-width main path
        gcfg = get_config(GRANITE)
        up_row, mm_train = phase_expert_training_products(gcfg, peaks)
        rows.append(up_row)
        torch.cuda.empty_cache()
        phase_train_granite_step0(gcfg)
        torch.cuda.empty_cache()
        phase_train_granite_step0(gcfg, n=2, B=CAP_B, S=CAP_S,
                                  label="train:granite:capacity")
        torch.cuda.empty_cache()
        granite_train = phase_train_granite()
        torch.cuda.empty_cache()
        phase_train_memory(GRANITE, "train:granite:memory",
                           GRANITE_UPDATE_GIB)
        serve_counts["outer_accum:experts"] = granite_train["counts"]
        up_row["launches_per_step"] = \
            granite_train["per_step"]["outer_accum:batched"]
        mm_row = next(r for r in rows if r["name"] == "sr_matmul:experts")
        mm_row["train"] = dict(mm_train, launches_per_step=granite_train[
            "per_step"]["sr_matmul:batched"])
        print(f"[train:granite] on {smi}")
        torch.cuda.empty_cache()

        # the fp32 preset on granite: the f32 batched products, four
        # layers against the reference backend, then the full-width path
        f32_rows = phase_expert_f32_products(gcfg, peaks)
        rows += f32_rows
        torch.cuda.empty_cache()
        phase_train_granite_fp32(gcfg)
        torch.cuda.empty_cache()
        granite_fp32 = phase_train_granite_fp32_full()
        for r in f32_rows:
            serve_counts[r["name"]] = granite_fp32["counts"]
            r["launches_per_step"] = granite_fp32["per_step"][r["counter"]]
        print(f"[train:granite:fp32:full] on {smi}")
        torch.cuda.empty_cache()

        # jamba-v0.1-52b training, cut to one card (one period at full
        # width, 4 of its 16 experts): the scan's gradient kernel, step 0
        # against the reference backend, the main path, its memory
        from repro_torch.launch.train import one_card_train_config
        t_jt = time.monotonic()
        bwd_row = phase_selective_scan_bwd(peaks)
        rows.append(bwd_row)
        torch.cuda.empty_cache()
        jamba_cut = one_card_train_config(
            get_config(JAMBA),
            torch.cuda.get_device_properties(0).total_memory)
        for seed in JAMBA_STEP0_SEEDS:
            phase_train_jamba_step0(jamba_cut, seed)
            torch.cuda.empty_cache()
        jamba_train = phase_train_jamba()
        serve_counts["selective_scan_bwd"] = jamba_train["counts"]
        bwd_row["launches_per_step"] = \
            jamba_train["per_step"]["selective_scan_bwd"]
        next(r for r in rows if r["name"] == "selective_scan")[
            "train_launches_per_step"] = \
            jamba_train["per_step"]["selective_scan"]
        torch.cuda.empty_cache()
        phase_train_memory(JAMBA, "train:jamba:memory")
        print(f"[train:jamba] the jamba training phases in "
              f"{time.monotonic() - t_jt:.1f}s on {smi}")
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    # launches: each kernel's count in the main path that runs it — the
    # qwen2 serve run for its PREFILL sr_matmul and fused_attn_unit, the
    # rwkv6 serve run for its sr_matmul, wkv6 and fused_ffn, the granite
    # serve run for the batched expert products (its sr_matmul:batched
    # count; the granite training run's a step ride along as "train"),
    # the granite training run for the batched UP (outer_accum:batched),
    # the jamba serve run for its sr_matmul, batched expert products and
    # selective_scan,
    # the rwkv6 training run for wkv6_bwd, the jamba training run for
    # selective_scan_bwd, granite's fp32 training run for the f32 batched
    # rows, qwen2's fp32 training run for the other
    # f32 rows, the paper_sr_bf16 training run for the rest
    # (sr_matmul:train is sr_matmul's FF + BP count there)
    for r in rows:
        kernel = r["name"].split(":")[0]
        counts = serve_counts.get(r["name"], fp32_full["counts"]
                                  if r["name"].endswith(":f32")
                                  else train["counts"])
        r["launches"] = counts[r.get("counter", kernel)]
        if r["name"] in spec_counts:
            # the speculative run of the same trace (k = SPEC_K), and its
            # launches by chunk kind and rows
            sc = spec_counts[r["name"]]
            key = r.get("counter", kernel)
            r["launches_spec"] = sc["counts"][key]
            r["launches_spec_by_chunk"] = {
                f"{kind}:M={m}": d[key] for (kind, m), d in
                sorted(sc["hist"].items()) if d.get(key)}
        if f"{kernel}:launches" in counts:
            r["kernel_launches"] = counts[f"{kernel}:launches"]
        paths = {p: counts[f"{kernel}:{p}"] for p in ("sm90", "generic",
                                                      "f32")
                 if f"{kernel}:{p}" in counts}
        if paths:
            r["path_launches"] = paths
        for shape, d in r.get("per_shape", {}).items():
            d["launches"] = counts[f"{kernel}:{shape}"]
            d["excess_ms"] = d["launches"] * (d["graph_ms"] - d["bound_ms"])
            print(f"[wkv6] {shape} (B={d['B']}, S={d['S']}): "
                  f"{d['launches']} launches in the rwkv6 trace x (graph, "
                  f"cold in L2, {d['graph_ms']:.4f} - bound "
                  f"{d['bound_ms']:.4f} ms) = "
                  f"{d['excess_ms']:.3f} ms; graph / bound "
                  f"{d['graph_ms'] / d['bound_ms']:.2f}")
    print_targets({r["name"]: r for r in rows})
    # the paper nets' rows carry their launches in their own training runs
    rows += paper_rows
    print(f"[chip_smoke] wall {time.monotonic() - T_START:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
