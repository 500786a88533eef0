#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only ``torch`` and the
port (``src/repro_torch``), never JAX or the JAX package, and:

1. builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, concurrently) and prints the build seconds;
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes qwen2-0.5b's serving path gives it, and times kernel,
   plain version and (for sr_matmul) the one torch call computing the
   same product;
3. serves a seeded Poisson trace through qwen2-0.5b at full width
   (random weights from a seed) with the continuous-batching engine on
   the cuda backend — PREFILL through sr_matmul, fused DECODE through
   fused_attn_unit — counting each kernel's launches in that run, and
   serves the same trace again with the per-op decode words.

It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero.  Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# sr_matmul f32 path, from tests/test_kernels.py: the blocked f32
# accumulation runs in another order than the plain product — a few ulp
# of the sum of |terms|, hence the relative part plus a small absolute.
MM_RTOL, MM_ATOL = 5e-4, 1e-4
# SR path: one ulp of f32 order difference can move the SR-rounded bf16
# result by one bf16 step (2^-8 relative) on a few elements.
SR_RTOL = 1.2e-2
# fused_attn_unit, from tests/test_decode_fused.py:155-164: bf16 outputs
# of f32-accumulated products in another order (2e-2), and cache entries
# that are single bf16 dot products of near-cancelling terms (6e-2).
Y_TOL, CACHE_TOL = 2e-2, 6e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# H100 variants by marketing name: (bytes/s of device memory, dense bf16
# tensor-core flop/s) from NVIDIA's data sheets.
_PEAKS = (("NVL", 3.9e12, 835e12), ("PCIe", 2.0e12, 756e12),
          ("H100", 3.35e12, 989e12))


def card_peaks(name: str) -> tuple:
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    return 3.35e12, 989e12


def bound(nbytes: float, flops: float, peaks: tuple) -> tuple:
    tb, tf = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errs(got, want) -> tuple:
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), float((d / w.abs().clamp_min(1e-6)).max())


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    secs = build.build()
    print(f"[build] {len(secs)} libraries in {time.monotonic() - t0:.1f}s "
          f"({', '.join(f'{n} {s:.1f}s' for n, s in secs.items())})")
    for n in build.SOURCES:
        log = build.BUILD_DIR / f"{n}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {n}: {line.strip()}")


def phase_sr_matmul(cfg, params, peaks) -> dict:
    """sr_matmul at every PREFILL shape of a 32-token chunk."""
    import torch
    from repro_torch.core.rounding import sr_cast_bf16
    from repro_torch.kernels import sr_matmul as kmm
    g0 = {k: v[0] for k, v in params["groups"]["u0"]["attn"].items()}
    f0 = {k: v[0] for k, v in params["groups"]["u0"]["ffn"].items()}
    shapes = [("attn_qkv", g0["qkv"], False), ("attn_o", g0["o"], False),
              ("ffn_in", f0["ffn_in"], False), ("ffn_out", f0["ffn_out"], False),
              ("lm_head", params["embed"]["table"], True)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    M = 32
    worst_abs = worst_rel = 0.0
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for name, w, tb in shapes:
        K = w.shape[1] if tb else w.shape[0]
        N = w.shape[0] if tb else w.shape[1]
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        got = kmm.sr_matmul(a, w, trans_b=tb)
        want = kmm.sr_matmul_plain(a, w, trans_b=tb)
        torch.cuda.synchronize()
        ea, er = errs(got, want)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"sr_matmul {name} ({M}x{K}x{N}, trans_b={tb}) f32 path: "
              f"max abs err {ea:.3g}")
        rb = torch.randint(-2**31, 2**31, (M, N), generator=gen,
                           device="cuda", dtype=torch.int64).to(torch.int32)
        got_sr = kmm.sr_matmul(a, w, rb, trans_b=tb)
        check(torch.equal(got_sr.view(torch.int16),
                          sr_cast_bf16(got, rb).view(torch.int16)),
              f"sr_matmul {name}: SR epilogue is not bit-equal to the plain "
              f"SR cast of the kernel's own f32 product")
        want_sr = kmm.sr_matmul_plain(a, w, rb, trans_b=tb)
        check(torch.allclose(got_sr.float(), want_sr.float(), rtol=SR_RTOL,
                             atol=MM_ATOL),
              f"sr_matmul {name}: SR product outside rtol {SR_RTOL}")
        worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
        ms = time_ms(lambda: kmm.sr_matmul(a, w, trans_b=tb))
        plain = time_ms(lambda: kmm.sr_matmul_plain(a, w, trans_b=tb))
        wt = w.t() if tb else w
        lib = time_ms(lambda: torch.matmul(a, wt))
        b_ms, _ = bound(2 * (M * K + K * N) + 4 * M * N, 2 * M * N * K, peaks)
        print(f"[sr_matmul] {name:<8} M={M} K={K} N={N} trans_b={int(tb)}: "
              f"kernel {ms:.4f}ms plain {plain:.4f}ms torch.matmul "
              f"{lib:.4f}ms bound {b_ms:.4f}ms  max_abs_err {ea:.3g}")
        tot["ms"] += ms
        tot["plain"] += plain
        tot["lib"] += lib
        tot["bound"] += b_ms
    # ragged edges of M, N and K on both layouts (masking, no overreads)
    for tb in (False, True):
        a = torch.randn((37, 1000), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((333, 1000) if tb else (1000, 333), generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = kmm.sr_matmul(a, w, trans_b=tb)
        want = kmm.sr_matmul_plain(a, w, trans_b=tb)
        check(torch.allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL),
              f"sr_matmul ragged 37x1000x333 trans_b={tb}: max abs err "
              f"{errs(got, want)[0]:.3g}")
    print(f"[sr_matmul] one PREFILL chunk's five shapes: kernel "
          f"{tot['ms']:.4f}ms plain {tot['plain']:.4f}ms torch.matmul "
          f"{tot['lib']:.4f}ms bound {tot['bound']:.4f}ms")
    return {"name": "sr_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/sr_matmul.cu",
            "replaces": "src/repro/kernels/sr_matmul.py:96",
            "tpu_kernel": "repro/kernels/sr_matmul.py::sr_matmul",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain"],
            "library_ms": tot["lib"], "bound_ms": tot["bound"],
            "bound_by": "bytes",
            "shapes": "one 32-token PREFILL chunk: qkv, o, ffn_in, ffn_out "
                      "of one layer + the tied LM head (trans_b)"}


def phase_fused(cfg, params, peaks) -> dict:
    """fused_attn_unit at B=32 arena rows, S=528, over 3 decode steps."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels.decode_fused import _vec
    a = cfg.attention
    B, S, d, f = 32, 528, cfg.d_model, cfg.d_ff
    H, K, hd = a.n_heads, a.n_kv_heads, a.head_dim
    u = params["groups"]["u0"]
    w = dict(qkv_w=u["attn"]["qkv"][0], qkv_bias=u["attn"]["qkv_bias"][0],
             o_w=u["attn"]["o"][0], w_in=u["ffn"]["ffn_in"][0],
             w_out=u["ffn"]["ffn_out"][0],
             norm1_scale=u["norm1"]["scale"][0],
             norm2_scale=u["norm2"]["scale"][0])
    kw = dict(heads=H, kv_heads=K, head_dim=hd, rope_theta=a.rope_theta,
              norm_kind="rmsnorm", act="swiglu")
    gen = torch.Generator(device="cuda").manual_seed(2)
    ck = (torch.randn((B, S, K, hd), generator=gen, device="cuda") * 2
          ).to(torch.bfloat16)
    cv = torch.randn((B, S, K, hd), generator=gen, device="cuda").to(torch.bfloat16)
    fill = torch.randint(0, S - 3, (B,), generator=gen, device="cuda")
    sidx = torch.arange(S, device="cuda")[None]
    cpos = torch.where(sidx < fill[:, None], sidx, -1).to(torch.int32)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[5] = active[17] = False
    kern = [ck.clone(), cv.clone(), cpos.clone()]
    plain = [ck.clone(), cv.clone(), cpos.clone()]
    qn = (H + 2 * K) * hd
    pkw = dict(n1s=_vec(w["norm1_scale"], d, 1.0, "cuda"),
               n1b=_vec(None, d, 0.0, "cuda"), qkv_w=w["qkv_w"],
               qkv_b=_vec(w["qkv_bias"], qn, 0.0, "cuda"), o_w=w["o_w"],
               n2s=_vec(w["norm2_scale"], d, 1.0, "cuda"),
               n2b=_vec(None, d, 0.0, "cuda"), w_in=w["w_in"],
               w_out=w["w_out"], window=None, tn=kdf._clip_block_n(256, f),
               with_ffn=True, active=active, **kw)
    worst_abs = worst_rel = 0.0
    for t in range(3):
        x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
        pos = (fill + t).to(torch.int32)
        y = kdf.fused_attn_unit(x, *kern, pos, active=active, **w, **kw)
        yp = kdf.fused_attn_unit_plain(x, *plain, pos, **pkw)
        torch.cuda.synchronize()
        ea, er = errs(y, yp)
        worst_abs, worst_rel = max(worst_abs, ea), max(worst_rel, er)
        check(torch.allclose(y.float(), yp.float(), atol=Y_TOL, rtol=Y_TOL),
              f"fused_attn_unit step {t}: y max abs err {ea:.3g}")
        for got, want in zip(kern[:2], plain[:2]):
            check(torch.allclose(got.float(), want.float(), atol=CACHE_TOL,
                                 rtol=CACHE_TOL),
                  f"fused_attn_unit step {t}: cache max abs err "
                  f"{errs(got, want)[0]:.3g}")
        check(torch.equal(kern[2], plain[2]), "fused_attn_unit: cache pos differ")
    for got, orig in zip(kern, (ck, cv, cpos)):
        check(torch.equal(got[~active], orig[~active]),
              "fused_attn_unit wrote an inactive arena row")
    x = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = (fill + 3).to(torch.int32)
    ms = time_ms(lambda: kdf.fused_attn_unit(x, *kern, pos, active=active,
                                             **w, **kw))
    plain_ms = time_ms(lambda: kdf.fused_attn_unit_plain(x, *plain, pos,
                                                         **pkw))
    qn = (H + 2 * K) * hd
    weights = 2 * (d * qn + H * hd * d + d * 2 * f + f * d) + 4 * (qn + 2 * d)
    valid = int((fill + 4).sum())                 # cached positions attended
    kv = valid * K * hd * 2 * 2 + B * S * 4
    io = 2 * 2 * B * d + B * (K * hd * 2 * 2 + 4) + 2 * B * 4
    flops = 2 * B * (d * qn + H * hd * d + 2 * d * f + f * d) \
        + 4 * H * hd * valid
    b_ms, by = bound(weights + kv + io, flops, peaks)
    print(f"[fused_attn_unit] B={B} S={S}: kernel {ms:.4f}ms plain "
          f"{plain_ms:.4f}ms bound {b_ms:.4f}ms ({by})  max_abs_err "
          f"{worst_abs:.3g}")
    return {"name": "fused_attn_unit", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_fused.cu",
            "replaces": "src/repro/kernels/decode_fused.py:272",
            "tpu_kernel": "repro/kernels/decode_fused.py::fused_attn_unit",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
            "shapes": f"one layer, B={B} rows, S={S}"}


def phase_serve(cfg, params) -> tuple:
    """The main path: the engine serves a trace on the cuda backend."""
    import torch
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import sr_matmul as kmm
    from repro_torch.serving import build_engine, latency_stats, poisson_trace
    trace = poisson_trace(16, vocab_size=cfg.vocab_size, prompt_lens=(16, 512),
                          gen_tokens=16, mean_interarrival_steps=2.0, seed=0)
    runs = {}
    for fused in (True, False):
        eng = build_engine(cfg, n_slots=32, max_len=528, prefill_chunk=32,
                           kernel_backend="cuda", fused_decode=fused,
                           device="cuda", params=params)
        kmm.COUNTER.reset()
        kdf.COUNTER.reset()
        t0 = time.monotonic()
        res = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {"sr_matmul": kmm.COUNTER.n, "fused_attn_unit": kdf.COUNTER.n}
        st = latency_stats(eng.events)
        label = "fused" if fused else "per-op"
        print(f"[serve:{label}] steps={eng.step_count} generated={st['tokens']}"
              f" wall={wall:.3f}s tok/s={st['tokens'] / wall:.2f} "
              f"p50={st['p50_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
              f"launches={counts} nonfinite_logits={eng.nonfinite_logits}")
        check(eng.nonfinite_logits == 0, f"{label}: non-finite logits")
        check(sum(len(v) for v in res.values()) == 16 * 16,
              f"{label}: {sum(len(v) for v in res.values())} tokens, want 256")
        runs[label] = (res, counts)
    main_counts = runs["fused"][1]
    for k, n in main_counts.items():
        check(n > 0, f"the main path launched {k} no time")
    a, b = runs["fused"][0], runs["per-op"][0]
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    print(f"[serve] fused vs per-op decode: {same}/{16 * 16} generated tokens "
          f"agree ({same / 256:.3f})")
    return main_counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("[chip_smoke] FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print("[chip_smoke] FAIL: run from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import train_loop as tl
    try:
        phase_build()
        cfg = get_config("qwen2-0.5b")
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.monotonic()
        params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
        # random nonzero norm scales and qkv bias (init makes them 1 and 0)
        u = params["groups"]["u0"]
        for leaf, base in ((u["norm1"]["scale"], 1.0),
                           (u["norm2"]["scale"], 1.0),
                           (u["attn"]["qkv_bias"], 0.0)):
            leaf.copy_(base + 0.1 * torch.randn(leaf.shape, generator=gen,
                                                device="cuda"))
        print(f"[init] qwen2-0.5b {cfg.param_count()} params in "
              f"{time.monotonic() - t0:.1f}s on {name}")
        rows = [phase_sr_matmul(cfg, params, peaks),
                phase_fused(cfg, params, peaks)]
        counts = phase_serve(cfg, params)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr)
        return 1
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
