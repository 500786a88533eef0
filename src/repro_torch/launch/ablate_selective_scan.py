"""Where selective_scan's time goes: its kernel with one part left out.

    PYTHONPATH=src python -m repro_torch.launch.ablate_selective_scan

Builds ``csrc/selective_scan.cu`` as it is and in variants that each
leave one part of a token's work out (edited copies of the source, built
concurrently into ``csrc/_build/``), and times each through the wrapper
at jamba's di 8192, N 16 with bf16 x, from a nonzero state (inputs random
from a seed), at the four shapes of ``bench_selective_scan.py``, in a
CUDA graph, the variants in turns: forward, then backward.  A variant's
outputs are wrong by design: only its time is read.  The full kernel's
time less a variant's is what that part costs where the rest does not
hide it.  Prints one line a run, the card's name and power limit, and as
its last line the runs as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

# each variant: (anchor, replacement) edits of the source; an anchor must
# occur exactly once, so a kernel that has moved on fails loudly here
EXPS = ("  return make_float4(expf(__fmul_rn(dtv, A.x)), "
        "expf(__fmul_rn(dtv, A.y)),\n"
        "                     expf(__fmul_rn(dtv, A.z)), "
        "expf(__fmul_rn(dtv, A.w)));\n")
SHFL = ("      v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], "
        "m));\n")
B_LOAD = ("    const float4 bv = *reinterpret_cast<const float4*>(sb + (t + k)"
          " * N + n0);\n")
C_LOAD = ("    const float4 cv = *reinterpret_cast<const float4*>(sc + (t + k)"
          " * N + n0);\n")
VARIANTS = {
    "full": (),
    "without the exps": ((EXPS, "  return make_float4(__fmul_rn(dtv, A.x), "
                                "__fmul_rn(dtv, A.y), __fmul_rn(dtv, A.z), "
                                "__fmul_rn(dtv, A.w));\n"),),
    "without the shuffles": ((SHFL, "      v[k] = __fadd_rn(v[k], v[k]);\n"),),
    "without B and C from shared memory": (
        (B_LOAD, "    const float4 bv = A;\n"),
        (C_LOAD, "    const float4 cv = g.bx[k];\n")),
}


def variant_source(src: str, edits) -> str:
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ablate_selective_scan: {anchor!r} occurs "
                               f"{src.count(anchor)} times in "
                               f"selective_scan.cu")
        src = src.replace(anchor, new)
    return src


def build_variants() -> dict:
    """{name: loaded library} of every variant, built at once."""
    from repro_torch.kernels import build
    src = (build.CSRC / "selective_scan.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, edits) in enumerate(VARIANTS.items()):
        text = variant_source(src, edits)
        tag = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text).encode())
        cu = build.BUILD_DIR / f"ablate_scan{n}-{tag.hexdigest()[:16]}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_selective_scan: {name} failed to "
                               f"build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as kss
    from repro_torch.launch.bench_decode import graph_ms
    from repro_torch.launch.bench_selective_scan import DI, N, SHAPES
    if not torch.cuda.is_available():
        print("ablate_selective_scan: no CUDA device", file=sys.stderr)
        return 1
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(41)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    A = -torch.arange(1, N + 1, device="cuda", dtype=torch.float32).repeat(
        DI, 1)
    D = 0.5 + torch.rand(DI, generator=gen, device="cuda")
    runs = []
    for B, S in SHAPES:
        x = rnd(B, S, DI).bfloat16()
        dt = torch.nn.functional.softplus(rnd(B, S, DI) - 1.0)
        Bm, Cm, st = rnd(B, S, N), rnd(B, S, N), 0.5 * rnd(B, DI, N)
        names = list(libs)
        for order in (names, names[::-1]):
            for name in order:
                build._LIBS["selective_scan"] = libs[name]
                ms = graph_ms(lambda: kss.selective_scan(x, dt, A, Bm, Cm, D,
                                                         st),
                              iters=10, replays=5)
                print(f"[ablate_selective_scan] B={B} S={S} {name}: graph "
                      f"{ms:.4f} ms", flush=True)
                runs.append({"B": B, "S": S, "variant": name,
                             "graph_ms": ms})
    build._LIBS.pop("selective_scan", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
