"""Serving CLI: the continuous-batching engine over a Poisson trace.

    # on the GPU, through the hand-written kernels
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --kernel-backend cuda --fused-decode --requests 16 --slots 32

    # rwkv6: the recurrence on the wkv6 kernel, the FF half on fused_ffn
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --kernel-backend cuda --fused-decode --requests 16 --slots 32

    # granite-moe-1b-a400m: each expert table's PREFILL product as one
    # sr_matmul_batched launch, the attention half of DECODE fused
    # (olmo-1b and minitron-4b take the dense path)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --kernel-backend cuda --fused-decode \
        --requests 16 --slots 32

    # speculative decoding: a one-layer draft proposes 3 tokens, the big
    # model verifies 4 in one PREFILL chunk
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --kernel-backend cuda --fused-decode --requests 16 --slots 32 \
        --speculative 4

    # on the CPU at the reduced size (the plain reference backend)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --device cpu --requests 4 --prompt-lens 4,20 --gen 4

    # jamba-v0.1-52b (attention, Mamba and MoE units; the scan on the
    # selective_scan kernel) and arctic-480b (MoE with a dense FF beside
    # it) at the reduced size; at full width neither fits one card at
    # full depth (chip_smoke.py serves jamba's first 8 layers)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --reduced --device cpu --requests 4 \
        --prompt-lens 4,20 --gen 4 --kernel-backend cuda --fused-decode

Without ``--device`` it runs on CUDA and fails when there is none.
"""
from __future__ import annotations

import argparse
import time


def run_engine(args) -> int:
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.serving import build_engine, latency_stats, poisson_trace

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    lo, hi = (int(x) for x in args.prompt_lens.split(","))
    max_len = args.max_len or hi + args.gen
    engine = build_engine(
        cfg, n_slots=args.slots, max_len=max_len, prefill_chunk=args.chunk,
        kernel_backend=args.kernel_backend, seed=args.seed,
        fused_decode=args.fused_decode, device=args.device,
        evict_patience=args.evict_patience, speculative=args.speculative)
    trace = poisson_trace(args.requests, vocab_size=cfg.vocab_size,
                          prompt_lens=(lo, hi), gen_tokens=args.gen,
                          mean_interarrival_steps=args.rate, seed=args.seed)
    t0 = time.monotonic()
    results = engine.run(trace)
    if engine.device.type == "cuda":
        import torch
        torch.cuda.synchronize(engine.device)
    wall = time.monotonic() - t0
    stats = latency_stats(engine.events)
    n_prompt = sum(len(r.prompt) for r in trace)
    print(f"arch={cfg.name} requests={args.requests} prompts=[{lo},{hi}] "
          f"gen={args.gen} slots={args.slots} chunk={args.chunk} "
          f"device={engine.device} arena_row={engine.arena_row_bytes}B")
    print(f"steps={engine.step_count} prompt_tokens={n_prompt} "
          f"generated={stats['tokens']} wall={wall*1e3:.0f}ms")
    print(f"throughput {stats['tokens']/wall:.1f} tok/s (generated), "
          f"{(n_prompt+stats['tokens'])/wall:.1f} tok/s (total); "
          f"per-token latency p50={stats['p50_ms']:.1f}ms "
          f"p99={stats['p99_ms']:.1f}ms")
    if args.speculative:
        v = max(1, engine.spec_stats["verifies"])
        print(f"speculative k={args.speculative}: "
              f"verifies={engine.spec_stats['verifies']} "
              f"accepted={engine.spec_stats['accepted']} "
              f"({engine.spec_stats['accepted']/v:.2f} accepted/verify)")
    first = trace[0].rid
    print(f"sample ({first}):", results[first][:16])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kernel-backend", default="reference",
                    choices=("reference", "cuda"))
    ap.add_argument("--fused-decode", action="store_true",
                    help="run one fused decode word per layer")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-lens", default="16,512",
                    help="lo,hi prompt-length band of the trace")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=32,
                    help="cache arena rows (max concurrent requests)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk width (tokens per chunk step)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean request inter-arrival in engine steps")
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length per slot (0 = hi + gen)")
    ap.add_argument("--evict-patience", type=int, default=None,
                    help="steps a queued request starves before preemption")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per verify "
                         "(0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, failing without one)")
    return run_engine(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
