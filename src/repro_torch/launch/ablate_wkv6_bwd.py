"""Where wkv6_bwd's time goes: its kernel with one part left out at a time.

    PYTHONPATH=src python -m repro_torch.launch.ablate_wkv6_bwd

Builds ``csrc/wkv6_bwd.cu`` as it is and in variants that each leave one
part of the kernel out (edited copies of the source, built concurrently
into ``csrc/_build/``), and times each at rwkv6-1.6b's training shape
(B=4, S=256, H=32, hd=64, bf16 r, k, v, inputs random from a seed) in a
CUDA graph, the variants in turns: forward, then backward.  A variant's outputs are wrong by design: only its time is
read.  The full kernel's time less a variant's is what that part costs
where the rest does not hide it; "pass A alone" is the forward pass that
writes every tile's starting state.  Prints one line a run, the card's
name and power limit, and as its last line the runs as one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

# each variant: (anchor, replacement) edits of the source; an anchor must
# occur exactly once, so a kernel that has moved on fails loudly here
PASS_A_END = "    cp_async_wait<0>();\n  }\n"
VARIANTS = {
    "full": (),
    "pass A alone": ((PASS_A_END, PASS_A_END + "  return;\n"),),
    "without the walk": (("    walk(it);\n", ""),),
    "without the outputs": (("    if (it < last) epilogue(it + 1);\n", ""),
                            ("  epilogue(0);\n", "")),
    "without the token sums": (("    sums(it);\n", ""),),
}


def variant_source(src: str, edits) -> str:
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ablate_wkv6_bwd: {anchor!r} occurs "
                               f"{src.count(anchor)} times in wkv6_bwd.cu")
        src = src.replace(anchor, new)
    return src


def build_variants() -> dict:
    """{name: bound wkv6_bwd_launch} of every variant, built at once."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv6 as kwkv
    src = (build.CSRC / "wkv6_bwd.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, edits) in enumerate(VARIANTS.items()):
        text = variant_source(src, edits)
        tag = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text).encode())
        cu = build.BUILD_DIR / f"ablate{n}-{tag.hexdigest()[:16]}.cu"
        lib = cu.with_suffix(".so")
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
               str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_wkv6_bwd: {name} failed to build:\n"
                               f"{log}")
        fns[name] = kwkv._bind_bwd(ctypes.CDLL(str(lib)))
    return fns


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.launch.bench_decode import graph_ms
    if not torch.cuda.is_available():
        print("ablate_wkv6_bwd: no CUDA device", file=sys.stderr)
        return 1
    B, S, H, hd = 4, 256, 32, 64
    gen = torch.Generator(device="cuda").manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    r, k, v = ((0.5 * rnd(B, S, H, hd)).bfloat16() for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(rnd(B, S, H, hd))
    u = 0.1 * rnd(H, hd)
    dy = rnd(B, S, H, hd)
    p = kwkv.wkv6_bwd_plan(B, H, S, hd)
    outs = [torch.empty(r.shape, device="cuda") for _ in range(4)]
    du_b = torch.empty((B, H, hd), device="cuda")
    bounds = torch.empty((B * H, max(-(-S // p.tile) - 1, 1), hd * hd),
                         device="cuda")
    ptrs = [build.ptr(t) for t in (r, k, v, w, u, dy, *outs, du_b, bounds)]
    fns = build_variants()

    def call(fn):
        err = fn(*ptrs, B, H, S, hd, 1, p.threads, p.tile, p.smem,
                 build.stream_ptr(r.device))
        if err != 0:
            raise RuntimeError(f"ablate_wkv6_bwd: launch failed ({err})")

    names = list(fns)
    runs = []
    for order in (names, names[::-1]):
        for name in order:
            ms = graph_ms(lambda: call(fns[name]), iters=10, replays=5)
            print(f"[ablate_wkv6_bwd] {name}: graph {ms:.4f} ms", flush=True)
            runs.append({"variant": name, "graph_ms": ms})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "shape": [B, S, H, hd],
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
