"""Where the batched expert products' time goes, variant by variant.

    PYTHONPATH=src python -m repro_torch.launch.ablate_experts \\
        [--precision fp32]

Builds ``csrc/sr_matmul.cu`` and ``csrc/outer_accum.cu`` with a batched
kernel's header as it is and in variants that each change one part of
it (edited copies of the header, built concurrently into
``csrc/_build/``), then times granite-moe-1b-a400m's three expert tables
a layer in a CUDA graph, warm in L2, under each variant in turns,
forward then backward, with each expert's live rows from a top-8 router
on seeded weights (``routed``) and with every row live (``all-live``).
A variant that leaves a part out gives wrong outputs by design: only
its time is read.  The full kernel's time less a variant's is what
that part costs where the rest does not hide it.

bf16 (``csrc/gemm_sm90_batched.cuh``, the default): a training step's
FF, BP and SR UP at C = 1024 rows an expert and a PREFILL chunk's
product at C = 32; "without the epilogue" (no staged tile, no TMA
store, no zeros over the dead rows; the UP still loads its SR bits into
registers and gives their buffer back), "without the mainloop" (every
tile's k-loop empty: no operand loads, no wgmma; the epilogue writes
the zero tile, the UP's SR of it from the bits).  ``chip_smoke.py``
prints the same split for its routed products through
:func:`build_variants` and :func:`times`.

fp32 (``csrc/sgemm_sm90_batched.cuh``): FF, BP and UP at C = 1024;
"without the zero-fill" (the dead row tiles left unwritten), "without
the mainloop" (every unit's k-loop empty: the epilogue writes zeros),
"without the UP's order" (the UP's experts in their own order, not by
live k-blocks), "FF / BP in the experts' order" and "FF / BP row tile
by row tile" (every tile of every expert numbered from the shape, a
dead one's block writing its zeros in place, instead of the live tiles
first through a prefix and the dead ones after them).

Prints one line a run, the card's name and power limit, and as its last
line the runs as one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys

HEADER = "gemm_sm90_batched.cuh"
HEADER_F32 = "sgemm_sm90_batched.cuh"
LIBS = ("sr_matmul", "outer_accum")
# each variant: (anchor, replacement) edits of the header; an anchor must
# occur exactly once, so a kernel that has moved on fails loudly here
STAGED = "    // the staging buffer is free once this warpgroup's last store has\n"
DEAD = "      if (active)\n        for (int i = t; i < 64 * CPR; i += 128) {\n"
VARIANTS = {
    "full": (),
    "without the epilogue": ((STAGED, "    continue;\n" + STAGED),
                             (DEAD, DEAD.replace("(active)", "(false)"))),
    "without the mainloop": (
        ("      b.nk = min(kb_per_split, k_blocks - b.kb0);\n",
         "      b.nk = 0;\n"),
        ("    b.nk = max(0, min(kb_per_split, tab[b.e] - b.kb0));\n",
         "    b.nk = 0;\n")),
}


def _own_order(coords: str) -> tuple:
    """The f32 edits that number FF / BP's units from the shape alone,
    every expert's tiles (live and dead) in the order `coords` gives
    them, in place of the live tiles first through the prefix and the
    dead ones after them."""
    return (("    const int live = tab[experts] * splits;\n",
             "    {\n      w.z = u % splits;\n      int t = u / splits;\n      "
             + coords +
             "      w.kb0 = w.z * kb_per_split;\n"
             "      w.nk = min(kb_per_split, k_blocks - w.kb0);\n"
             "      w.dead = w.y >= (tab[w.e + 1] - tab[w.e]) / grid_x;\n"
             "      return w;\n    }\n"
             "    const int live = tab[experts] * splits;\n"),
            ("                         : tab[experts] * splits +\n"
             "                               experts * grid_x * grid_y - "
             "tab[experts];\n",
             "                         : experts * grid_x * grid_y * splits;\n"))


# the f32 variants, edits of HEADER_F32 likewise
VARIANTS_F32 = {
    "full": (),
    "without the zero-fill": (("    if (cur.dead) {\n",
                               "    if (cur.dead) {\n      continue;\n"),),
    "without the mainloop": (
        ("      w.nk = min(kb_per_split, k_blocks - w.kb0);\n",
         "      w.nk = 0;\n"),
        ("    w.nk = max(0, min(kb_per_split, tab[w.e] - w.kb0));\n",
         "    w.nk = 0;\n")),
    "without the UP's order": (("      order[rank] = e;\n",
                                "      order[e] = e;\n"),),
    "FF / BP in the experts' order": _own_order(
        "w.y = t % grid_y;\n      t /= grid_y;\n      w.x = t % grid_x;\n"
        "      w.e = t / grid_x;\n"),
    "FF / BP row tile by row tile": _own_order(
        "w.x = t % grid_x;\n      t /= grid_x;\n      w.e = t % experts;\n"
        "      w.y = t / experts;\n"),
}
_BUILT: dict = {}


def variant_source(src: str, edits, header: str = HEADER) -> str:
    """`src` (the text of `header`) with `edits` made."""
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"ablate_experts: {anchor!r} occurs "
                               f"{src.count(anchor)} times in {header}")
        src = src.replace(anchor, new)
    return src


def build_variants(header: str = HEADER) -> dict:
    """{variant: {library name: ctypes.CDLL}} for `header`'s variants
    (VARIANTS for the bf16 header, VARIANTS_F32 for the f32 one), every
    variant's two libraries built at once (once a process); "full" is
    the build's own."""
    if header in _BUILT:
        return _BUILT[header]
    from repro_torch.kernels import build
    src = (build.CSRC / header).read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in (VARIANTS_F32 if header == HEADER_F32
                        else VARIANTS).items():
        if not edits:
            continue
        text = variant_source(src, edits, header)
        tag = hashlib.sha256((" ".join(build.NVCC_FLAGS) + header
                              + text).encode())
        vdir = build.BUILD_DIR / f"ablate_experts-{tag.hexdigest()[:16]}"
        vdir.mkdir(exist_ok=True)
        (vdir / header).write_text(text)
        for lib in LIBS:
            # the .cu beside the edited header: its quoted include finds
            # the copy first, the other headers through -I
            shutil.copy(build.CSRC / f"{lib}.cu", vdir / f"{lib}.cu")
            out = vdir / f"lib{lib}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
                   str(out), str(vdir / f"{lib}.cu")]
            procs[name, lib] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    built = {"full": {lib: build.load(lib) for lib in LIBS}}
    for (name, lib), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_experts: {name} ({lib}) failed to "
                               f"build:\n{log}")
        built.setdefault(name, {})[lib] = ctypes.CDLL(str(out))
    _BUILT[header] = built
    return built


@contextlib.contextmanager
def variant(libs: dict):
    """The wrappers launch `libs`' kernels inside the block."""
    from repro_torch.kernels import build
    old = {lib: build._LIBS.get(lib) for lib in libs}
    build._LIBS.update(libs)
    try:
        yield
    finally:
        for lib, v in old.items():
            if v is None:
                build._LIBS.pop(lib, None)
            else:
                build._LIBS[lib] = v


def times(variants: dict, fn, graph_ms) -> dict:
    """{variant: graph ms of fn} under each variant, in turns forward then
    backward, each the mean of its two."""
    names = list(variants)
    got = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            with variant(variants[n]):
                got[n].append(graph_ms(fn))
    return {n: sum(v) / len(v) for n, v in got.items()}


def split_txt(t: dict) -> str:
    """The split as chip_smoke.py and main() print it."""
    full = t["full"]
    return (f"full {full:.4f} ms, without the epilogue "
            f"{t['without the epilogue']:.4f} (epilogue "
            f"{full - t['without the epilogue']:.4f}), without the mainloop "
            f"{t['without the mainloop']:.4f} (mainloop "
            f"{full - t['without the mainloop']:.4f})")


def variants_txt(t: dict) -> str:
    """Each variant's time and its difference from the full kernel's."""
    full = t["full"]
    return f"full {full:.4f} ms, " + ", ".join(
        f"{n} {ms:.4f} ({ms - full:+.4f})" for n, ms in t.items()
        if n != "full")


def main(argv=None) -> int:
    import argparse

    import torch

    from repro_torch.kernels import outer_accum as koa
    from repro_torch.kernels import sr_matmul as kmm
    from repro_torch.launch.bench_decode import graph_ms
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precision", choices=("paper_sr_bf16", "fp32"),
                    default="paper_sr_bf16",
                    help="the bf16 batched kernel's variants, or the f32 "
                         "one's (fp32)")
    f32 = ap.parse_args(argv).precision == "fp32"
    if not torch.cuda.is_available():
        print("ablate_experts: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    E, D, FE, TOP = 32, 1024, 512, 8
    gen = torch.Generator(device="cuda").manual_seed(27)

    def rows_of(T):
        x = torch.randn((T, D), generator=gen, device="cuda")
        router = torch.randn((D, E), generator=gen, device="cuda") * D ** -0.5
        top = torch.topk(x @ router, TOP, dim=-1).indices.reshape(-1)
        return torch.zeros(E, dtype=torch.int32, device="cuda").scatter_add_(
            0, top, torch.ones(top.numel(), dtype=torch.int32,
                               device="cuda"))

    def buf(rows, C, w, scale=1.0):
        live = kmm.live_rows(rows, C)[..., None]
        b = torch.where(live, torch.randn((E, C, w), generator=gen,
                                          device="cuda") * scale, 0.0)
        return b if f32 else b.bfloat16()

    variants = build_variants(HEADER_F32 if f32 else HEADER)
    dt = torch.float32 if f32 else torch.bfloat16
    runs = []
    cases = ((1024, ("ff", "bp", "up")),) if f32 else (
        (1024, ("ff", "bp", "up")), (32, ("prefill",)))
    for C, roles in cases:
        routed = rows_of(C)
        full = torch.full((E,), C, dtype=torch.int32, device="cuda")
        for role in roles:
            for label, rows in (("routed", routed), ("all-live", full)):
                if role == "prefill" and label == "all-live":
                    continue
                tot = {}
                for k, n in ((D, FE), (D, FE), (FE, D)):
                    w = (torch.randn((E, k, n), generator=gen,
                                     device="cuda") * k ** -0.5).to(dt)
                    if role == "up":
                        x, dy = buf(rows, C, k), buf(rows, C, n, C ** -0.5)
                        rb = None if f32 else torch.randint(
                            -2 ** 31, 2 ** 31, (E, k, n), generator=gen,
                            device="cuda", dtype=torch.int64).to(torch.int32)
                        fn = lambda: koa.outer_accum_batched(  # noqa: E731
                            x, dy, rbits=rb, rows=rows)
                    else:
                        a = buf(rows, C, n if role == "bp" else k)
                        fn = lambda: kmm.sr_matmul_batched(  # noqa: E731
                            a, w, trans_b=role == "bp", rows=rows,
                            out_dtype=dt)
                    for name, ms in times(variants, fn, graph_ms).items():
                        tot[name] = tot.get(name, 0.0) + ms
                print(f"[ablate_experts] {'fp32 ' if f32 else ''}{role} "
                      f"{label} (C={C}, {int(rows.sum())} of {E * C} rows "
                      f"live), a layer's three tables in a graph: "
                      f"{variants_txt(tot) if f32 else split_txt(tot)}",
                      flush=True)
                runs.append({"precision": "fp32" if f32 else "bf16",
                             "role": role, "rows": label, "C": C,
                             "live_rows": int(rows.sum()), "graph_ms": tot})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
