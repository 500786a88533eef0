"""Device time of selective_scan_bwd at jamba's training shapes, tree by tree.

    PYTHONPATH=src python -m repro_torch.launch.bench_selective_scan_bwd \\
        [--tree DIR ...] [--rounds 2]

Times ``kernels.selective_scan.selective_scan_bwd``
(``csrc/selective_scan_bwd.cu``) at jamba-v0.1-52b's di 8192, N 16 with
bf16 x, from a zero state, at two shapes: the training step's (B=4,
S=256) and ``chip_smoke.py``'s step-0 check (B=2, S=64).  Inputs are
random from a seed, as ``chip_smoke.py``'s ``[selective_scan_bwd]``
makes them.  Each shape is timed in CUDA events, in a CUDA graph warm in
L2 (the same call again and again), in a CUDA graph cold in L2 (the call
on distinct copies of x, dt and dy that together exceed the 50 MB L2),
and in a CUDA graph after half a second of replays, beside the SM clock
read while they run, for each source tree given: the root of a checkout,
this one by default.

Each tree runs in a process of its own, which imports that tree's
``repro_torch``, builds its kernel and holds each of its six gradients
against its own plain version (max error over the largest value).  The
trees run in turns, forward then backward (``--rounds 2`` with trees A,
B: A B B A), so two versions are compared on one card in one call.
Prints one line a shape and run with the shape's bound (the largest of
the bytes over the memory rate, the f32 operations over the f32 peak
and the exps over the SFU's rate), the plan where the tree has one, each
kernel's registers and spills from its build log, the SM clock sampled
while the trees ran, the card's name and power limit, and as its last
line the runs as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
DI, N = 8192, 16
SHAPES = ((4, 256), (2, 64))
# H100 SXM (NVIDIA's data sheet): device memory, f32 outside the tensor
# cores; the SFU's exps at 16 a clock per SM against 128 f32 FMAs (256
# operations) a clock, so a sixteenth of the f32 operation rate
MEM_RATE, F32_RATE = 3.35e12, 67e12
EXP_RATE = F32_RATE / 16
# f32 operations the gradient needs a state value and token (chip_smoke.py's
# SCAN_BWD_FLOPS: h recomputed 4, G 3, dx 2, ddt 3, dA 2, dB and dC 2 each)
FLOPS = 18


def bound_ms(B: int, S: int, di: int = DI, n: int = N,
             x_bytes: int = 2) -> tuple:
    """(least ms, what sets it, {bytes, operations, exps: ms}): x, dt,
    dy, B, C, A and D read once, dx, ddt, dB, dC, dA and dD written once;
    FLOPS f32 operations and one exp a state value and token."""
    nbytes = (B * S * di * (x_bytes + 4 * 4) + 4 * 4 * B * S * n
              + 2 * 4 * di * (n + 1))
    work = B * S * di * n
    ms = {"bytes": nbytes / MEM_RATE * 1e3,
          "operations": FLOPS * work / F32_RATE * 1e3,
          "exps": work / EXP_RATE * 1e3}
    by = max(ms, key=ms.get)
    return ms[by], by, ms


# run in each tree's own process: the public wrapper and its plain
# version, which every tree since the kernel was added has
CHILD = r"""
import itertools, json, math, re, subprocess, sys, torch
from repro_torch.kernels import build, selective_scan as kss
DI, N = 8192, 16
SHAPES = json.loads(sys.argv[1])

def events_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

# device ms a call, `iters` calls in a CUDA graph replayed `replays`
# times; with spin_s, after that many seconds of replays (the card's clock
# ramps up under load) and with the SM clock read while the card is busy:
# (ms, MHz)
def graph_ms(fn, iters=10, replays=5, spin_s=0.0):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    mhz = None
    if spin_s:
        n = max(1, int(spin_s * 1e3 / a.elapsed_time(b)))
        for _ in range(n):
            g.replay()
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout.split()[0])
        for _ in range(n):
            g.replay()
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (iters * replays)
    return (ms, mhz) if spin_s else ms

def inputs(gen, B, S):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = rnd(B, S, DI).bfloat16()
    dt = torch.nn.functional.softplus(rnd(B, S, DI) - 1.0)
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(
        DI, 1)
    Bm, Cm = rnd(B, S, N), rnd(B, S, N)
    D = 0.5 + torch.rand(DI, generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, D, rnd(B, S, DI)

# {kernel<template args>: registers, spills} of the build's ptxas report
def registers():
    log = build.BUILD_DIR / "selective_scan_bwd.log"
    rows, cur, spill = {}, None, (0, 0)
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"\d(selective_scan_bwd_[a-z]+)(I(?:L[ib]\d+E)+E)?",
                      line)
        if m and ("Compiling entry" in line or "Function properties" in line):
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            cur = m.group(1) + (f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            rows[cur] = {"registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]}
            cur, spill = None, (0, 0)
    return rows

gen = torch.Generator(device="cuda").manual_seed(43)
names = ("dx", "ddt", "dA", "dB", "dC", "dD")
out = {"shapes": {}}
for B, S in SHAPES:
    args = inputs(gen, B, S)
    got = kss.selective_scan_bwd(*args)
    want = kss.selective_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    rel = {n: float((g - w).abs().max() / w.abs().max())
           for n, g, w in zip(names, got, want)}
    del got, want
    call = lambda: kss.selective_scan_bwd(*args)
    x, dt, A, Bm, Cm, D, dy = args
    nbytes = B * S * DI * 18
    sets = [(x.clone(), dt.clone(), dy.clone())
            for _ in range(max(2, math.ceil((64 << 20) / nbytes)))]
    cyc = itertools.cycle(sets)
    def cold():
        xx, dd, gg = next(cyc)
        kss.selective_scan_bwd(xx, dd, A, Bm, Cm, D, gg)
    plan = (kss.selective_scan_bwd_plan(B, S, DI, N)._asdict()
            if hasattr(kss, "selective_scan_bwd_plan") else None)
    spun, mhz = graph_ms(call, spin_s=0.5)
    out["shapes"][f"{B}x{S}"] = {
        "events_ms": events_ms(call), "graph_ms": graph_ms(call),
        "cold_graph_ms": graph_ms(cold, iters=2 * len(sets)),
        "spun_graph_ms": spun, "busy_sm_mhz": mhz, "rel": rel,
        "plan": plan}
    del sets
out["registers"] = registers()
print(json.dumps(out, default=str))
"""


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD,
                           json.dumps([list(s) for s in SHAPES])],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="a checkout's root (repeatable; default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="passes over the trees, every second one reversed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_selective_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    order = [t for n in range(args.rounds)
             for t in (trees if n % 2 == 0 else trees[::-1])]
    for B, S in SHAPES:
        ms, by, parts = bound_ms(B, S)
        print(f"[bench_selective_scan_bwd] bound B={B} S={S}: {ms:.4f} ms "
              f"({by}; " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + ")", flush=True)
    runs = []
    # the SM clock and the power drawn while the trees run, every 100 ms
    smi_log = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for tree in order:
            res = run_tree(tree)
            for shape, d in res["shapes"].items():
                B, S = map(int, shape.split("x"))
                b_ms = bound_ms(B, S)[0]
                print(f"[bench_selective_scan_bwd] {tree.name} B={B} S={S}: "
                      f"events {d['events_ms']:.4f} ms, graph "
                      f"{d['graph_ms']:.4f} ms, cold in L2 "
                      f"{d['cold_graph_ms']:.4f} ms, after 0.5 s of calls "
                      f"{d['spun_graph_ms']:.4f} ms at "
                      f"{d['busy_sm_mhz']:.0f} MHz "
                      f"({d['graph_ms'] / b_ms:.2f}x / "
                      f"{d['cold_graph_ms'] / b_ms:.2f}x bound); max err / "
                      f"largest " + ", ".join(f"{k} {v:.3g}" for k, v in
                                              d["rel"].items())
                      + f"; plan {d['plan']}", flush=True)
                runs.append({"tree": str(tree), "B": B, "S": S,
                             "bound_ms": b_ms, **d})
            for kern, r in res["registers"].items():
                print(f"[bench_selective_scan_bwd] {tree.name} {kern}: "
                      f"{r['registers']} registers, spill stores "
                      f"{r['spill_stores']} B, loads {r['spill_loads']} B")
    finally:
        smi_log.terminate()
    samples = sorted(tuple(float(v) for v in line.split(","))
                     for line in smi_log.communicate()[0].splitlines()
                     if line.count(",") == 1)
    clocks = sorted(c for c, _ in samples)
    if clocks:
        print(f"[bench_selective_scan_bwd] SM clock while the trees ran: "
              f"median {clocks[len(clocks) // 2]:.0f} MHz ({clocks[0]:.0f}-"
              f"{clocks[-1]:.0f}); power drawn up to "
              f"{max(p for _, p in samples):.1f} W, {len(clocks)} samples")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "sm_clock_mhz": clocks,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
