"""Device time of wkv6_bwd at rwkv6-1.6b's training shape, tree by tree.

    PYTHONPATH=src python -m repro_torch.launch.bench_wkv6_bwd \\
        [--tree DIR ...] [--rounds 2]

Times ``kernels.wkv6.wkv6_bwd`` (``csrc/wkv6_bwd.cu``) at B=4, S=256,
H=32, hd=64 with bf16 r, k, v (inputs random from a seed, as
``chip_smoke.py``'s ``[wkv6_bwd]`` makes them) in CUDA events and in a
CUDA graph, for each source tree given: the root of a checkout, this one
by default.  Each tree runs in a process of its own, which imports that
tree's ``repro_torch``, builds its kernel and holds its result against
its own plain version.  The trees run in turns, forward then backward
(``--rounds 2`` with trees A, B: A B B A), so two versions are compared
on one card in one call.  Prints one line a run, the card's name and
power limit, and as its last line the runs as one JSON object.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# run in each tree's own process: only the public wrapper and its plain
# version, which every tree since the kernel was added has
CHILD = r"""
import json, sys, torch
from repro_torch.kernels import wkv6 as kwkv
B, S, H, hd = 4, 256, 32, 64

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

def graph_ms(fn, iters=10, replays=5):
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
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * replays)

gen = torch.Generator(device="cuda").manual_seed(9)
rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
r, k, v = ((0.5 * rnd(B, S, H, hd)).bfloat16() for _ in range(3))
w = 0.45 + 0.5 * torch.sigmoid(rnd(B, S, H, hd))
u = 0.1 * rnd(H, hd)
dy = rnd(B, S, H, hd)
args = (r, k, v, w, u, dy)
runs = {"wkv6_bwd": lambda: kwkv.wkv6_bwd(*args)}
want = kwkv.wkv6_bwd_plain(*args)
out = {}
for name, fn in runs.items():
    got = fn()
    torch.cuda.synchronize()
    rel = max(float((g - x).abs().max()) / float(x.abs().max())
              for g, x in zip(got, want))
    out[name] = {"events_ms": events_ms(fn), "graph_ms": graph_ms(fn),
                 "max_rel_of_largest": rel}
print(json.dumps(out))
"""


def run_tree(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env,
                          capture_output=True, text=True, timeout=600)
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
        print("bench_wkv6_bwd: no CUDA device", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    order = [t for n in range(args.rounds)
             for t in (trees if n % 2 == 0 else trees[::-1])]
    runs = []
    for tree in order:
        res = run_tree(tree)
        for name, d in res.items():
            print(f"[bench_wkv6_bwd] {tree.name} {name} B=4 S=256 H=32 "
                  f"hd=64 bf16 r,k,v: events {d['events_ms']:.4f} ms, "
                  f"graph {d['graph_ms']:.4f} ms, max err / largest "
                  f"{d['max_rel_of_largest']:.3g}", flush=True)
            runs.append({"tree": str(tree), "name": name, **d})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
