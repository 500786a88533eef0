"""Where the serving time goes on the GPU: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch rwkv6-1.6b --out profile_serve.txt

Serves a seeded Poisson trace through one model at full width
(qwen2-0.5b by default; rwkv6-1.6b, granite-moe-1b-a400m, olmo-1b or
minitron-4b; random weights) on the cuda backend with fused decode, and
profiles a window of engine steps in the middle of the run.  Prints the
device time by kernel (sum and launch count), the window's wall time,
the device's busy and idle share of it, each of the port's kernels'
device time (PORT_KERNELS),
torch's copy kernels' time and launches (COPY_KERNELS), and the
host-clock time of the window's PREFILL chunk calls and DECODE
calls.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
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
    "wkv6": r"\bwkv6_kernel<", "wkv6_bwd": r"\bwkv6_bwd_kernel<"}
# the models the port serves
SERVED = ("qwen2-0.5b", "rwkv6-1.6b", "granite-moe-1b-a400m", "olmo-1b",
          "minitron-4b")
# torch's copy and dtype-conversion kernel (.to, .contiguous, copy_:
# direct_copy_kernel_cuda)
COPY_KERNELS = r"copy_kernel"


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=SERVED)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--per-op", action="store_true",
                    help="profile the per-op decode words instead of fused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serving import build_engine, poisson_trace

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    cfg = get_config(args.arch)
    eng = build_engine(cfg, n_slots=32, max_len=528, prefill_chunk=32,
                       kernel_backend="cuda", fused_decode=not args.per_op,
                       seed=args.seed, device="cuda")
    trace = poisson_trace(args.requests, vocab_size=cfg.vocab_size,
                          prompt_lens=(16, 512), gen_tokens=16, seed=args.seed)
    for r in trace:
        eng.submit(r)                  # all queued up front: a busy arena
    host = {"chunk": 0.0, "decode": 0.0}
    calls = {"chunk": 0, "decode": 0}

    def timed(kind, fn):
        def wrap(*a):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*a)
            torch.cuda.synchronize()
            host[kind] += time.monotonic() - t0
            calls[kind] += 1
            return out
        return wrap

    with torch.no_grad():
        for _ in range(args.warmup_steps):
            eng.step()
        eng._chunk = timed("chunk", eng._chunk)
        eng._decode = timed("decode", eng._decode)
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
            and str(e.device_type).endswith("CUDA")]
    busy = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    port = {k: (sum(us for key, us, _ in rows if re.search(pat, key)),
                sum(n for key, _, n in rows if re.search(pat, key)))
            for k, pat in PORT_KERNELS.items()}
    copies = [(us, n) for key, us, n in rows if re.search(COPY_KERNELS, key)]
    lines = [f"device: {torch.cuda.get_device_name(0)}; arch {cfg.name}",
             f"window: {args.steps} engine steps after {args.warmup_steps}, "
             f"{'per-op' if args.per_op else 'fused'} decode, "
             f"wall {wall * 1e3:.3f} ms",
             f"device busy {busy / 1e3:.3f} ms "
             f"({busy / 1e6 / wall:.3f} of wall; idle "
             f"{1 - busy / 1e6 / wall:.3f})",
             f"host clock: {calls['chunk']} PREFILL chunk calls "
             f"{host['chunk'] * 1e3:.3f} ms, {calls['decode']} DECODE calls "
             f"{host['decode'] * 1e3:.3f} ms",
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
