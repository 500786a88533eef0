"""Where a fused decode word's device time goes: bench_decode on variants.

    PYTHONPATH=src python -m repro_torch.launch.decode_variants \
        --out artifacts/variants base r1 r2 r3 r4 r5 r6 r7 nocompute

Copies the port (``src/repro_torch``) once per variant under ``--out``,
edits the copy's ``csrc/decode_fused.cu`` as the variant says, builds
the copies' ``decode_fused`` libraries concurrently, then runs
``launch/bench_decode.py`` on each copy in turn and prints, per variant,
the graph time of each word and the attention's share.  A variant is a
diagnostic: what it computes is wrong, only its time means something.
Needs a CUDA device and nvcc.

Variants:
  base        the kernels unchanged
  r1 .. r7    the attention returns after its phase N: 1 its prelude
              (the K/V loads issued, the bias and the RoPE table) and
              the wait for QKV; 2 QKV's sum; 3 RoPE, and the K/V tiles
              landed; 4 the append; 5 the scores; 6 the softmax; 7 PV
              (base adds the partials and the merge)
  nocompute   the attention skips the scores, the softmax and PV
  noprefetch  the attention issues no K/V loads
  noqkvsum    the attention sums only the first of QKV's splits
  stagesN     the weight products' ring has N stages
  mergeN      the attention's merge loads N splits at a time
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parent.parent
STOP = "  if (n > 0) {\n    cp_async_wait_all();\n    return;\n  }\n"
# the attention kernel's phases end before these lines
PHASE_ENDS = ("  // this row's q (G heads)",
              "  // RoPE of the G queries and the key",
              "  // the current ring slot holds this step's new key",
              "  // scores on the tensor cores",
              "  // per query head (a warp each)",
              "  // PV: thread (part, 4 dims",
              "  const size_t out_row")


def edit(src: str, variant: str) -> str:
    """decode_fused.cu's text for `variant`."""
    def sub(text: str, old: str, new: str) -> str:
        if old not in text:
            raise SystemExit(f"{variant}: {old.strip()!r} not in the source")
        return text.replace(old, new, 1)
    m = re.fullmatch(r"(r|stages|merge)(\d+)", variant)
    if variant == "base":
        return src
    if m and m.group(1) == "r" and 1 <= int(m.group(2)) <= len(PHASE_ENDS):
        end = PHASE_ENDS[int(m.group(2)) - 1]
        return sub(src, end, STOP + end)
    if m and m.group(1) == "stages":
        return sub(src, "constexpr int STAGES = 6;",
                   f"constexpr int STAGES = {m.group(2)};")
    if m and m.group(1) == "merge":
        return sub(src, "constexpr int MERGE = 4;",
                   f"constexpr int MERGE = {m.group(2)};")
    if variant == "nocompute":
        src = sub(src, PHASE_ENDS[3], "  if (n < 0) {\n" + PHASE_ENDS[3])
        return sub(src, PHASE_ENDS[6], "  }\n" + PHASE_ENDS[6])
    if variant == "noprefetch":
        return sub(src, "cp_async16((which ? vt : kt) + jj * ld + ch * 8, "
                        "src);", "(void)src;")
    if variant == "noqkvsum":
        return sub(src, "for (int sp = 1; sp < p.qkv_splits; ++sp)",
                   "for (int sp = 1; sp < 1; ++sp)")
    raise SystemExit(f"unknown variant {variant!r}")


def _run(cmd, env_src: Path, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(env_src))
    return subprocess.run(cmd, env=env, capture_output=True, text=True, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for the variants' copies of the port")
    ap.add_argument("variants", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    # sr_matmul (bench_decode's yardstick) is built once, here, and its
    # library copied with the port: no variant edits its sources
    built = _run([sys.executable, "-c", "from repro_torch.kernels import "
                  "build; build.build(('sr_matmul',))"], PORT.parent)
    if built.returncode:
        raise SystemExit(built.stderr[-2000:])
    trees = {}
    for v in dict.fromkeys(args.variants):
        root = out / v / "src"
        shutil.rmtree(out / v, ignore_errors=True)
        shutil.copytree(PORT, root / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = root / "repro_torch" / "csrc" / "decode_fused.cu"
        cu.write_text(edit(cu.read_text(), v))
        trees[v] = root
    builds = {v: subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.build(('decode_fused',))"],
        env=dict(os.environ, PYTHONPATH=str(root)), stderr=subprocess.PIPE,
        text=True) for v, root in trees.items()}
    for v, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{v}: build failed\n{err[-3000:]}")
    # in the order given: a variant named twice runs twice (drift)
    results = []
    for v in args.variants:
        proc = _run([sys.executable, "-m", "repro_torch.launch.bench_decode"],
                    trees[v], timeout=600)
        if proc.returncode:
            raise SystemExit(f"{v}: bench_decode failed\n{proc.stderr[-2000:]}")
        words = json.loads(proc.stdout.strip().splitlines()[-1])["words"]
        res = {w: {"graph_ms": r["graph_ms"],
                   "parts": {k: p[0] for k, p in r["parts"].items()}}
               for w, r in words.items()}
        results.append([v, res])
        a, f = res["fused_attn_unit"], res["fused_ffn"]
        print(f"{v}: fused_attn_unit graph {a['graph_ms']:.4f} ms, "
              f"attention {a['parts'].get('attention', 0.0):.4f} ms; "
              f"fused_ffn graph {f['graph_ms']:.4f} ms", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
