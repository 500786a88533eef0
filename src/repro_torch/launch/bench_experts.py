"""Device time of a MoE layer's batched expert products, tree by tree.

    PYTHONPATH=src python -m repro_torch.launch.bench_experts \\
        [--tree DIR ...] [--rounds 2] [--precision fp32]

Times granite-moe-1b-a400m's three expert tables a layer (32 experts;
experts_in and experts_gate 1024 -> 512, experts_out 512 -> 1024) in a
CUDA graph, warm in L2 (the same operands again and again) and cold
(three operand sets in turn), for each source tree given: the root of a
checkout, this one by default.  The inputs are random from a seed, with
each expert's live rows counted from a top-8 router on seeded weights
(the rows past an expert's count are zero, as the MoE dispatch leaves
them):

- ``ff``, ``bp``, ``up``: a training step's FF (x . W), BP (dY . W^T)
  and SR UP (X^T dY) at C = 1024 rows an expert (B=4 x S=256 tokens,
  dropless), ``prefill``: a 32-token PREFILL chunk's product (C = 32);
  each called as the tree's dispatch calls it — with the live rows and
  bf16 out where the tree's wrappers take them, else every row, f32 out
  and the cast to bf16 (the two passes of the trees before the live
  rows);
- ``…:all-live``: every row of every expert live (a skewed routing's
  worst case: one expert takes every token);
- ``…:bmm``: ``torch.bmm`` on the routed buffers (bf16 out, no SR).

``--precision fp32`` times the f32 batched forms instead (the fp32
preset on a MoE table: f32 operands, f32 out, no SR): FF, BP and UP at
C = 1024, routed, all-live and ``torch.bmm`` (TF32 off), each called as
the dispatch calls it, with the live rows (a tree whose f32 kernels
predate them takes every row whatever it is passed); FF and BP also
under 1, 2 and 4 splits of K (``…:splits<s>``, routed and all-live;
the child process replaces ``sr_matmul.f32_plan`` for the call), the
sweep behind ``f32_plan``'s choice for a MoE table.

Each tree runs in a process of its own, which imports that tree's
``repro_torch``, builds its kernels and holds each product against its
own plain version.  The trees run in turns, forward then backward
(``--rounds 2`` with trees A, B: A B B A), so two versions are compared
on one card in one call.  Prints one line a case and tree, the card's
name and power limit, and as its last line the runs as one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# run in each tree's own process: only the public wrappers and their
# plain versions, which every tree since the batched UP was added has
COMMON = r"""
import inspect, json, torch
from repro_torch.kernels import outer_accum as koa
from repro_torch.kernels import sr_matmul as kmm
E, D, FE, TOP = 32, 1024, 512, 8
TABLES = ((D, FE), (D, FE), (FE, D))   # experts_in, experts_gate, experts_out
LIVE = "rows" in inspect.signature(kmm.sr_matmul_batched).parameters
gen = torch.Generator(device="cuda").manual_seed(27)
torch.backends.cuda.matmul.allow_tf32 = False

def graph_ms(fn, iters=20, replays=5):
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

def routed_rows(T):
    x = torch.randn((T, D), generator=gen, device="cuda")
    router = torch.randn((D, E), generator=gen, device="cuda") * D ** -0.5
    top = torch.topk(x @ router, TOP, dim=-1).indices.reshape(-1)
    return torch.zeros(E, dtype=torch.int32, device="cuda").scatter_add_(
        0, top, torch.ones(top.numel(), dtype=torch.int32, device="cuda"))

"""
CHILD = COMMON + r"""
def buf(rows, C, w, scale=1.0):
    live = torch.arange(C, device="cuda")[None, :] < rows[:, None]
    r = torch.randn((E, C, w), generator=gen, device="cuda") * scale
    return torch.where(live[..., None], r, 0.0).bfloat16()

def mm(a, w, trans_b, rows):
    if LIVE:
        return kmm.sr_matmul_batched(a, w, trans_b=trans_b, rows=rows,
                                     out_dtype=torch.bfloat16)
    return kmm.sr_matmul_batched(a, w, trans_b=trans_b).to(torch.bfloat16)

def up(x, dy, rb, rows):
    if LIVE:
        return koa.outer_accum_batched(x, dy, rbits=rb, rows=rows)
    return koa.outer_accum_batched(x, dy, rbits=rb)

def operands(role, rows, C, k, n):
    w = (torch.randn((E, k, n), generator=gen, device="cuda")
         * k ** -0.5).bfloat16()
    if role == "bp":
        return buf(rows, C, n), w
    if role == "up":
        rb = torch.randint(-2 ** 31, 2 ** 31, (E, k, n), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        return buf(rows, C, k), buf(rows, C, n, C ** -0.5), rb
    return buf(rows, C, k), w

def call(role, ops, rows, bmm=False):
    if role == "up":
        x, dy, rb = ops
        if bmm:
            return torch.bmm(x.transpose(1, 2), dy)
        return up(x, dy, rb, rows)
    a, w = ops
    if bmm:
        return torch.bmm(a, w.transpose(1, 2) if role == "bp" else w)
    return mm(a, w, role == "bp", rows)

def check(role, ops, rows, got):
    if role == "up":
        x, dy, _ = ops
        want = koa.outer_accum_batched_plain(x, dy)
    else:
        a, w = ops
        want = kmm.sr_matmul_batched_plain(a, w, trans_b=role == "bp")
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err < 2e-2, (role, err)
    return err

out = {}
for C, roles in ((1024, ("ff", "bp", "up")), (32, ("prefill",))):
    routed = routed_rows(C)
    full = torch.full((E,), C, dtype=torch.int32, device="cuda")
    for role in roles:
        kind = "ff" if role == "prefill" else role
        for label, rows, bmm in ((role, routed, False),
                                 (role + ":all-live", full, False),
                                 (role + ":bmm", routed, True)):
            warm = cold = err = 0.0
            for k, n in TABLES:
                sets = [operands(kind, rows, C, k, n) for _ in range(3)]
                f = lambda: call(kind, sets[0], rows, bmm)
                if not bmm:
                    err = max(err, check(kind, sets[0], rows, f()))
                warm += graph_ms(f)
                cold += graph_ms(lambda: [call(kind, s, rows, bmm)
                                          for s in sets], iters=4) / 3
                del sets
            out[label] = {"graph_ms": warm, "cold_ms": cold,
                          "live_rows": int(rows.sum()), "rows": C * E,
                          "max_rel_err": err}
print(json.dumps({"live_rows_passed": LIVE, "cases": out}))
"""


# the f32 forms (--precision fp32), in each tree's own process; FF
# and BP also under SPLITS' split counts
CHILD_F32 = COMMON + r"""
C, SPLITS = 1024, (1, 2, 4)


def buf32(rows, w, scale=1.0):
    live = torch.arange(C, device="cuda")[None, :] < rows[:, None]
    r = torch.randn((E, C, w), generator=gen, device="cuda") * scale
    return torch.where(live[..., None], r, 0.0)

def operands(role, rows, k, n):
    w = torch.randn((E, k, n), generator=gen, device="cuda") * k ** -0.5
    if role == "bp":
        return buf32(rows, n), w
    if role == "up":
        return buf32(rows, k), buf32(rows, n, C ** -0.5)
    return buf32(rows, k), w

def call(role, ops, rows, bmm=False, splits=None):
    if role == "up":
        x, dy = ops
        if bmm:
            return torch.bmm(x.transpose(1, 2), dy)
        return koa.outer_accum_batched(x, dy, rows=rows)
    a, w = ops
    tb = role == "bp"
    if bmm:
        return torch.bmm(a, w.transpose(1, 2) if tb else w)
    if splits is None:
        return kmm.sr_matmul_batched(a, w, trans_b=tb, rows=rows)
    own = kmm.f32_plan
    kmm.f32_plan = lambda *args, **kw: own(*args, **kw)._replace(
        splits=splits)
    try:
        return kmm.sr_matmul_batched(a, w, trans_b=tb, rows=rows)
    finally:
        kmm.f32_plan = own

def check(role, ops, rows, got):
    if role == "up":
        want = koa.outer_accum_batched_plain(*ops, rows=rows)
    else:
        want = kmm.sr_matmul_batched_plain(*ops, trans_b=role == "bp",
                                           rows=rows)
    assert torch.allclose(got, want, rtol=5e-4, atol=1e-4), role
    return float((got - want).abs().max() / want.abs().max())

out = {}
routed = routed_rows(C)
full = torch.full((E,), C, dtype=torch.int32, device="cuda")
for role in ("ff", "bp", "up"):
    cases = [(role, routed, False, None), (role + ":all-live", full, False,
                                          None),
             (role + ":bmm", routed, True, None)]
    if role != "up":
        cases += [(f"{role}:splits{s}{tag}", r, False, s) for s in SPLITS
                  for tag, r in (("", routed), (":all-live", full))]
    for label, rows, bmm, splits in cases:
        warm = cold = err = 0.0
        for k, n in TABLES:
            sets = [operands(role, rows, k, n) for _ in range(3)]
            f = lambda: call(role, sets[0], rows, bmm, splits)
            if not bmm:
                err = max(err, check(role, sets[0], rows, f()))
            warm += graph_ms(f)
            cold += graph_ms(lambda: [call(role, s, rows, bmm, splits)
                                      for s in sets], iters=4) / 3
            del sets
        out[label] = {"graph_ms": warm, "cold_ms": cold,
                      "live_rows": int(rows.sum()), "rows": C * E,
                      "max_rel_err": err}
print(json.dumps({"live_rows_passed": True, "cases": out}))
"""


def run_tree(tree: Path, child: str = CHILD) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          capture_output=True, text=True, timeout=900)
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
    ap.add_argument("--precision", choices=("paper_sr_bf16", "fp32"),
                    default="paper_sr_bf16",
                    help="the bf16 batched forms, or the f32 ones (fp32)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_experts: no CUDA device", file=sys.stderr)
        return 1
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    order = [t for n in range(args.rounds)
             for t in (trees if n % 2 == 0 else trees[::-1])]
    runs = []
    for tree in order:
        res = run_tree(tree, CHILD_F32 if args.precision == "fp32"
                       else CHILD)
        for name, d in res["cases"].items():
            print(f"[bench_experts] {tree.name} {name}: graph warm "
                  f"{d['graph_ms']:.4f} ms, cold {d['cold_ms']:.4f} ms a "
                  f"layer's three tables; {d['live_rows']} of {d['rows']} "
                  f"rows live; max err / largest {d['max_rel_err']:.3g}",
                  flush=True)
            runs.append({"tree": str(tree), "name": name,
                         "live_rows_passed": res["live_rows_passed"], **d})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
