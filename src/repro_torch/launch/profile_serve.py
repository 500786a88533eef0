"""Where the serving time goes on the GPU: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch rwkv6-1.6b --out profile_serve.txt
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --speculative 4 --out profile_spec.txt
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch jamba-v0.1-52b --out profile_jamba.txt

Serves a seeded Poisson trace through one model at full width
(qwen2-0.5b by default; rwkv6-1.6b, granite-moe-1b-a400m, olmo-1b,
minitron-4b, jamba-v0.1-52b or arctic-480b; random weights) on the cuda
backend with fused decode, and profiles a window of engine steps in the
middle of the run.  A model whose full depth does not fit the card runs
one period of its layer pattern (one_card_depth).  Prints the
device time by kernel (sum and launch count), the window's wall time,
the device's busy and idle share of it, each of the port's kernels'
device time (PORT_KERNELS),
torch's copy kernels' time and launches (COPY_KERNELS), and, for each
kind of engine call in the window — PREFILL chunks, masked DECODE steps
and, with ``--speculative K``, DRAFT steps, verify chunks and replays —
its calls, host-clock time (each call synchronised before and after)
and the device time of the kernels it launched (the kernels that run
inside the call's ``record_function`` range).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import re
import time

# the port's hand-written kernels, by the names their launches carry:
# gemm_sm90.cuh's mainloop and split reduction (bf16) and sgemm_sm90.cuh's
# (f32) serve sr_matmul with A K-major (template argument A_MN false) and
# outer_accum with A = X^T (A_MN true); a MoE table's batched products
# are gemm_sm90_batched.cuh's batched_kernel and splitk_reduce_batched
# (bf16) and sgemm_sm90_batched.cuh's sgemm_batched_kernel (f32):
# sr_matmul:batched with A_MN false, outer_accum:batched (a MoE table's
# UP) with A_MN true; decode_fused.cu's kernels carry their
# word as the first template argument (0 fused_attn_unit, 1 fused_ffn)
PORT_KERNELS = {
    "sr_matmul": r"rt::(sr_matmul_kernel|sm90::(gemm_kernel<\d+, false, "
                 r"\w+>|splitk_reduce<false>)|"
                 r"sgemm::sgemm_kernel<false, \w+>)",
    "sr_matmul:batched": r"rt::(sm90::(batched_kernel<\d+, false|"
                         r"splitk_reduce_batched<false)|"
                         r"sgemm::sgemm_batched_kernel<false, \w+>)",
    "outer_accum": r"rt::(outer_accum_kernel|sm90::(gemm_kernel<\d+, true, "
                   r"\w+>|splitk_reduce<true>)|"
                   r"sgemm::sgemm_kernel<true, \w+>)",
    "outer_accum:batched": r"rt::(sm90::(batched_kernel<\d+, true|"
                           r"splitk_reduce_batched<true)|"
                           r"sgemm::sgemm_batched_kernel<true, \w+>)",
    "sr_round": r"rt::sr_round_kernel",
    "fused_attn_unit": r"rt::decode::((norm|gemm)_kernel<0\b|attn_kernel)",
    "fused_ffn": r"rt::decode::(norm|gemm)_kernel<1\b",
    "wkv6": r"\bwkv6_kernel<", "wkv6_bwd": r"\bwkv6_bwd_kernel<",
    "selective_scan": r"\bselective_scan_kernel<",
    "selective_scan_bwd": r"\bselective_scan_bwd_(kernel<|reduce)"}
# the models the port serves
SERVED = ("qwen2-0.5b", "rwkv6-1.6b", "granite-moe-1b-a400m", "olmo-1b",
          "minitron-4b", "jamba-v0.1-52b", "arctic-480b")
# torch's copy and dtype-conversion kernel (.to, .contiguous, copy_:
# direct_copy_kernel_cuda)
COPY_KERNELS = r"copy_kernel"
# the engine calls timed on their own, by the method that makes them
CALLS = (("chunk", "_chunk"), ("decode", "_decode"), ("draft",
         "_draft_step_one"), ("verify", "_verify"), ("replay", "_replay"))
RANGE = "serve:"                   # record_function prefix of those calls


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _device_by_range(events) -> dict:
    """{call kind: device us} of the profiled window: each kernel's time
    goes to the ``RANGE`` + kind range that holds its start (the calls
    synchronise before they end, so their kernels run inside them), the
    rest to None."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name[len(RANGE):])
                   for e in events if e.name.startswith(RANGE)
                   and not str(e.device_type).endswith("CUDA"))
    starts = [s for s, _, _ in spans]
    out: dict = {}
    for e in events:
        if not str(e.device_type).endswith("CUDA") \
                or e.name.startswith(RANGE):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        kind = (spans[i][2] if i >= 0 and e.time_range.start < spans[i][1]
                else None)
        out[kind] = out.get(kind, 0.0) + (e.time_range.end
                                          - e.time_range.start)
    return out


def one_card_depth(cfg, card_bytes: int):
    """`cfg` at full depth where its bf16 weights take at most half the
    card's memory (the rest holds the slot arena and DECODE's f32 copy of
    a weight), else cut to one period of its layer pattern, which holds
    every unit kind: jamba-v0.1-52b 8 of 32 layers (13.30 B parameters,
    24.8 GiB in bf16, against 96 GiB for all 32), arctic-480b 1 of 35."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    if 2 * cfg.param_count() <= card_bytes // 2:
        return cfg
    return dataclasses.replace(cfg, n_layers=len(tfm.layer_pattern(cfg)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=SERVED)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--per-op", action="store_true",
                    help="profile the per-op decode words instead of fused")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="serve speculatively with a K-token window")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.serving import build_engine, poisson_trace

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    cfg = one_card_depth(get_config(args.arch),
                         torch.cuda.get_device_properties(0).total_memory)
    eng = build_engine(cfg, n_slots=32, max_len=528, prefill_chunk=32,
                       kernel_backend="cuda", fused_decode=not args.per_op,
                       seed=args.seed, device="cuda",
                       speculative=args.speculative)
    trace = poisson_trace(args.requests, vocab_size=cfg.vocab_size,
                          prompt_lens=(16, 512), gen_tokens=16, seed=args.seed)
    for r in trace:
        eng.submit(r)                  # all queued up front: a busy arena
    kinds = [k for k, _ in CALLS]
    host = dict.fromkeys(kinds, 0.0)
    calls = dict.fromkeys(kinds, 0)

    def timed(kind, fn):
        def wrap(*a):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with record_function(RANGE + kind):
                out = fn(*a)
                torch.cuda.synchronize()
            host[kind] += time.monotonic() - t0
            calls[kind] += 1
            return out
        return wrap

    with torch.no_grad():
        for _ in range(args.warmup_steps):
            eng.step()
        for kind, name in CALLS:
            setattr(eng, name, timed(kind, getattr(eng, name)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(args.steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0

    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if _device_us(e) > 0 and e.device_type is not None
            and str(e.device_type).endswith("CUDA")
            and not e.key.startswith(RANGE)]
    busy = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    port = {k: (sum(us for key, us, _ in rows if re.search(pat, key)),
                sum(n for key, _, n in rows if re.search(pat, key)))
            for k, pat in PORT_KERNELS.items()}
    copies = [(us, n) for key, us, n in rows if re.search(COPY_KERNELS, key)]
    dev = _device_by_range(prof.events())
    spec = (f", speculative k={args.speculative}: verifies="
            f"{eng.spec_stats['verifies']} accepted="
            f"{eng.spec_stats['accepted']} (whole run)"
            if args.speculative else "")
    lines = [f"device: {torch.cuda.get_device_name(0)}; arch {cfg.name}, "
             f"{cfg.n_layers} layers",
             f"window: {args.steps} engine steps after {args.warmup_steps}, "
             f"{'per-op' if args.per_op else 'fused'} decode{spec}, "
             f"wall {wall * 1e3:.3f} ms",
             f"device busy {busy / 1e3:.3f} ms "
             f"({busy / 1e6 / wall:.3f} of wall; idle "
             f"{1 - busy / 1e6 / wall:.3f})",
             "engine calls (calls, host ms, device ms, device share of the "
             "calls' host time): " + ", ".join(
                 f"{k} {calls[k]} {host[k] * 1e3:.3f} "
                 f"{dev.get(k, 0.0) / 1e3:.3f} "
                 f"{dev.get(k, 0.0) / 1e3 / max(host[k] * 1e3, 1e-9):.3f}"
                 for k in kinds if calls[k]),
             f"outside those calls: host "
             f"{(wall - sum(host.values())) * 1e3:.3f} ms, device "
             f"{dev.get(None, 0.0) / 1e3:.3f} ms",
             "port kernels, device ms (share of busy, launches): " + ", ".join(
                 f"{k} {us / 1e3:.3f} ({us / busy:.3f}, {n})"
                 for k, (us, n) in port.items()),
             f"torch copy kernels: {sum(us for us, _ in copies) / 1e3:.3f} "
             f"ms, {sum(n for _, n in copies)} launches",
             "device time by kernel (ms, launches):"]
    for key, us, n in rows[:25]:
        lines.append(f"  {us / 1e3:10.3f}  {n:6d}  {key[:110]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
