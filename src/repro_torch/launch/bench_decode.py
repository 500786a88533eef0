"""Device time of the fused decode words, launch by launch.

    PYTHONPATH=src python -m repro_torch.launch.bench_decode

Times ``fused_attn_unit`` at one qwen2-0.5b layer (B=32 rows, S=528,
GQA 14/2 heads of 64, d_ff 4864 swiglu) and ``fused_ffn`` at one
rwkv6-1.6b layer's FF (B=32, d 2048, d_ff 7168 relu^2), weights and
caches random from a seed, in a CUDA graph (device time alone).  Prints
each word's graph time, each launch's share of it (the time by which it
extends the device timeline in a traced graph replay) and the launches
of each kind per call that the trace saw; and, beside them, the same
weight products at the same 32 rows through ``sr_matmul``'s sm90 path
(``csrc/gemm_sm90.cuh``'s kernel with its 32-row A box and its
``splitk_reduce``, f32 out, no decode epilogue), one after another in
a CUDA graph as the word runs them.  Then the card's name, and as its last line the same as
one JSON object.  It runs in a process of its own: after torch.profiler
has traced a process, that process's later launches may cost more host
time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

TRACES = 3      # traces taken of a word before one with no kernel is fatal


def _graph(fn, iters: int):
    """`iters` calls of fn captured in one CUDA graph (after 3 warm-up
    calls on a side stream)."""
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
    return graph


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of `iters` calls captured in one CUDA graph."""
    import torch
    graph = _graph(fn, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _part(name: str) -> str:
    """A decode_fused.cu kernel's part of the word: the weight product of
    gemm_kernel<W, P>, norm_kernel<W, 0> (norm1, or fused_ffn's norm2),
    norm_kernel<W, 1> (the o-projection's sum + residual, then norm2) or
    the attention."""
    m = re.search(r"rt::decode::(\w+)_kernel(?:<\d+(?:, (\d+))?>)?", name)
    if m.group(1) == "gemm":
        return {0: "qkv", 1: "o", 2: "ffn_in", 3: "ffn_in",
                4: "ffn_out"}[int(m.group(2))]
    if m.group(1) == "norm":
        return "o_sum_norm2" if m.group(2) == "1" else "norm"
    return {"attn": "attention"}.get(m.group(1), m.group(1))


def _trace(graph) -> list:
    """(start, end, name) of each decode_fused.cu kernel in a
    torch.profiler trace of one replay of `graph`, by start."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if "rt::decode::" in e.name
                   and str(e.device_type).endswith("CUDA")),
                  key=lambda k: k[0])


def launch_ms(fn, iters: int = 10) -> dict:
    """{part: (device ms per call, launches per call)} of one word call,
    from a torch.profiler trace of one replay of `iters` calls captured
    in a CUDA graph.  A launch may start while the one before it
    finishes (programmatic dependent launch), so each launch is charged
    the time by which it extends the device timeline: its end less the
    later of its start and the previous launch's end.  The parts sum to
    the graph's device time per call.  A trace in which the profiler
    recorded no device kernel at all is taken again, up to TRACES
    traces; one that recorded kernels is used as it is."""
    graph = _graph(fn, iters)
    for n in range(1, TRACES + 1):
        kern = _trace(graph)
        if kern:
            break
        print(f"bench_decode: trace {n} of {TRACES} recorded no device "
              f"kernel", file=sys.stderr)
    else:
        raise SystemExit(f"bench_decode: torch.profiler recorded no device "
                         f"kernel in {TRACES} traced replays")
    us, count, prev_end = {}, {}, None
    for t0, t1, name in kern:
        part = _part(name)
        lead = t0 if prev_end is None else max(t0, prev_end)
        us[part] = us.get(part, 0.0) + max(0.0, t1 - lead)
        count[part] = count.get(part, 0) + 1
        prev_end = t1 if prev_end is None else max(prev_end, t1)
    return {p: (us[p] / 1e3 / iters, count[p] / iters) for p in us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # keep CUPTI set up between this process's traces, as PyTorch does
    # itself under CUDA graphs: a teardown and re-init around graph
    # replays can leave a later trace without device records
    os.environ.setdefault("TEARDOWN_CUPTI", "0")

    import torch

    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import sr_matmul as kmm

    if not torch.cuda.is_available():
        raise SystemExit("bench_decode needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    B, S, d, H, K, hd, f = 32, 528, 896, 14, 2, 64, 4864
    qn = (H + 2 * K) * hd
    w = dict(qkv_w=(rnd(d, qn) * d ** -0.5).bfloat16(),
             qkv_bias=(0.1 * rnd(qn)).bfloat16(),
             o_w=(rnd(H * hd, d) * (H * hd) ** -0.5).bfloat16(),
             w_in=(rnd(d, 2 * f) * d ** -0.5).bfloat16(),
             w_out=(rnd(f, d) * f ** -0.5).bfloat16(),
             norm1_scale=(1 + 0.1 * rnd(d)).bfloat16(),
             norm2_scale=(1 + 0.1 * rnd(d)).bfloat16())
    cache = [(2 * rnd(B, S, K, hd)).bfloat16(), rnd(B, S, K, hd).bfloat16()]
    fill = torch.randint(0, S - 3, (B,), generator=gen, device="cuda")
    sidx = torch.arange(S, device="cuda")[None]
    cache.append(torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32))
    x = rnd(B, d).bfloat16()
    pos = fill.to(torch.int32)
    attn = lambda: kdf.fused_attn_unit(
        x, *cache, pos, **w, heads=H, kv_heads=K, head_dim=hd,
        rope_theta=1e6, norm_kind="rmsnorm", act="swiglu")
    rd, rf = 2048, 7168
    rw = dict(w_in=(rnd(rd, rf) * rd ** -0.5).bfloat16(),
              w_out=(rnd(rf, rd) * rf ** -0.5).bfloat16(),
              norm2_scale=(1 + 0.1 * rnd(rd)).bfloat16(),
              norm2_bias=(0.1 * rnd(rd)).bfloat16())
    rx = rnd(B, rd).bfloat16()
    ffn = lambda: kdf.fused_ffn(rx, **rw, norm_kind="layernorm",
                                act="relu_sq")
    # each word's weight products: (name, A's columns, the weight)
    products = {"fused_attn_unit": (("qkv", d, w["qkv_w"]),
                                    ("o", H * hd, w["o_w"]),
                                    ("ffn_in", d, w["w_in"]),
                                    ("ffn_out", f, w["w_out"])),
                "fused_ffn": (("ffn_in", rd, rw["w_in"]),
                              ("ffn_out", rf, rw["w_out"]))}
    print(f"device: {torch.cuda.get_device_name(0)}")
    results = {}
    for word, model, fn in (("fused_attn_unit", "qwen2-0.5b", attn),
                            ("fused_ffn", "rwkv6-1.6b", ffn)):
        ms = graph_ms(fn)
        parts = launch_ms(fn)
        pairs = [(rnd(B, k).bfloat16(), wt) for _, k, wt in products[word]]
        sm90 = graph_ms(lambda: [kmm.sr_matmul(a, wt) for a, wt in pairs])
        own = sum(parts.get(n, (0.0, 0))[0] for n, _, _ in products[word])
        results[word] = {"graph_ms": ms, "parts": parts,
                         "products_ms": own, "sm90_products_ms": sm90}
        print(f"{word} {model}: graph {ms:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} x{n:g}"
                          for k, (v, n) in parts.items()))
        print(f"{word} {model}: its weight products {own:.4f} ms; the same "
              f"products through sr_matmul's sm90 path in a graph "
              f"{sm90:.4f} ms")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "words": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
