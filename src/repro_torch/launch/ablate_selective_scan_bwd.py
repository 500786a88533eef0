"""Where selective_scan_bwd's time goes: its kernel with one part left out.

    PYTHONPATH=src python -m repro_torch.launch.ablate_selective_scan_bwd \\
        [--tree DIR ...]

Builds a tree's ``csrc/selective_scan_bwd.cu`` as it is and in variants
that each leave one part of the kernel out (edited copies of the source,
built concurrently into that tree's ``csrc/_build/``), and times each
through that tree's own wrapper (its library swapped for the variant's)
at jamba's training shape (B=4, S=256, di 8192, N 16, bf16 x, inputs
random from a seed) in a CUDA graph, the variants in turns: forward,
then backward.  A variant's outputs are wrong by design: only its time
is read.  The full kernel's time less a variant's is what that part
costs where the rest does not hide it.

The variants (``VARIANTS``) leave out the start-state pass over chunks
in parallel, the walk to each tile's start, the recompute's exps, the
staging of the tiles and the wait for them, the dB / dC sums over a
warp's channels or the second kernel, or put the accurate expf in place
of ex2.approx.  Their anchors are lines of the kernel as it is in this
checkout; a tree whose kernel lacks one fails with the anchor named.
Each tree runs in a process of its own.  Prints one line a run, the
card's name and power limit, and as its last line the runs as one JSON
object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# each variant: (anchor, replacement) edits of the source; an anchor must
# occur exactly once, so a kernel that has moved on fails loudly here
ENDS_LAUNCH = ("    e = launch_ends<N, BF>(a, st);\n"
               "    if (e != cudaSuccess) return e;\n")
RECOMPUTE_EXPS = "    as[i] = decay(dtv, A2);\n"
DC_SUMS = ("    bc_sums<N>(v, lane32);\n"
           "    if (put) red[i * G::W * 32 + 16] = v[0];\n")
DB_SUMS = ("    bc_sums<N>(v, lane32);\n"
           "    if (put) red[i * G::W * 32] = v[0];\n")
REDUCE = ("  e = reduce_launch<N>(a, bc, ad, st);\n"
          "  if (e != cudaSuccess) return e;\n")
WALK = "      walk<N, BF>(sl, c, n0, A2, h);\n"
STAGE = ("      if (iq >= n - 1) {\n"
         "        stage<N, BF, true>(a, sl, b, d0, ik * a.chunk"
         " + (2 * n - 2 - iq) * T);\n"
         "      } else {\n"
         "        stage<N, BF, false>(a, sl, b, d0, ik * a.chunk + iq * T);\n"
         "      }\n")
WAIT = "    cp_async_wait<SLOTS - 2>();\n"
EXP = "float exp_of(float v) { return ex2(v); }"
VARIANTS = {
    "full": (),
    "without the start-state pass": ((ENDS_LAUNCH, ""),),
    "without the walk to the tile starts": ((WALK, ""),),
    "without the recompute's exps": ((RECOMPUTE_EXPS,
                                      "    as[i] = A2;\n"),),
    "without the staging of the tiles": ((STAGE, ""), (WAIT, "")),
    "without the dB / dC sums": (
        (DC_SUMS, DC_SUMS.replace("    bc_sums<N>(v, lane32);\n", "")),
        (DB_SUMS, DB_SUMS.replace("    bc_sums<N>(v, lane32);\n", ""))),
    "without the second kernel": ((REDUCE, ""),),
    "with the accurate expf": ((EXP, EXP.replace("ex2(v)",
                                                 "expf(v * LN2)")),),
}
def variant_source(src: str, edits) -> str:
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ablate_selective_scan_bwd: {anchor!r} occurs "
                               f"{src.count(anchor)} times in "
                               f"selective_scan_bwd.cu")
        src = src.replace(anchor, new)
    return src


# run in each tree's own process: build the variants, then time each
# through the tree's wrapper with its library swapped in
CHILD = r"""
import ctypes, hashlib, json, subprocess, sys, torch
from repro_torch.kernels import build, selective_scan as kss
texts = json.loads(sys.stdin.read())
B, S, DI, N = 4, 256, 8192, 16
build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
procs = {}
for n, (name, text) in enumerate(texts.items()):
    tag = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text).encode())
    cu = build.BUILD_DIR / f"ablate_bwd{n}-{tag.hexdigest()[:16]}.cu"
    lib = cu.with_suffix(".so")
    cu.write_text(text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
           str(lib), str(cu)]
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True), lib)
libs = {}
for name, (proc, lib) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"{name} failed to build:\n{log}")
    libs[name] = ctypes.CDLL(str(lib))

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

gen = torch.Generator(device="cuda").manual_seed(43)
rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
x = rnd(B, S, DI).bfloat16()
dt = torch.nn.functional.softplus(rnd(B, S, DI) - 1.0)
A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(DI, 1)
Bm, Cm = rnd(B, S, N), rnd(B, S, N)
D = 0.5 + torch.rand(DI, generator=gen, device="cuda")
args = (x, dt, A, Bm, Cm, D, rnd(B, S, DI))

def call():
    kss.selective_scan_bwd(*args)

runs = []
names = list(libs)
for order in (names, names[::-1]):
    for name in order:
        build._LIBS["selective_scan_bwd"] = libs[name]
        runs.append({"variant": name, "graph_ms": graph_ms(call)})
print(json.dumps(runs))
"""


def run_tree(tree: Path) -> list:
    src = (tree / "src" / "repro_torch" / "csrc"
           / "selective_scan_bwd.cu").read_text()
    texts = {name: variant_source(src, edits)
             for name, edits in VARIANTS.items()}
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(texts), env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="a checkout's root (repeatable; default: this one)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ablate_selective_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    runs = []
    for tree in (t.resolve() for t in (args.tree or [ROOT])):
        for r in run_tree(tree):
            print(f"[ablate_selective_scan_bwd] {tree.name} {r['variant']}: "
                  f"graph {r['graph_ms']:.4f} ms", flush=True)
            runs.append({"tree": str(tree), **r})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "shape": [4, 256, 8192, 16],
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
