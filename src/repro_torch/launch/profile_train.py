"""Where the training time goes on the GPU: a torch.profiler window.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --out profile_train.txt [--precision fp32] [--arch rwkv6-1.6b]

Runs the training CLI's own loop (``launch.train.run``) on qwen2-0.5b (or
``--arch``: rwkv6-1.6b, granite-moe-1b-a400m) at full width (random weights from a seed) on the cuda
backend under paper_sr_bf16 (or ``--precision``; adamw, remat block,
B=4, S=256), and profiles the steps
after a warm-up.  Prints the window's wall time per step, the device's
busy and idle share of it, the device time by kernel (sum and launch
count), the share of the port's kernels (the batched expert products,
``sr_matmul:batched`` and ``outer_accum:batched``, apart from the rest),
and the host operators with the most host time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import re
import shutil
import tempfile
import time

from repro_torch.launch.profile_serve import PORT_KERNELS, _device_us

WARMUP_STEPS, WINDOW_STEPS = 2, 3
TRAIN_ARGS = ["--kernel-backend", "cuda", "--device", "cuda",
              "--optimizer", "adamw", "--remat", "block", "--batch", "4",
              "--seq", "256", "--steps",
              str(WARMUP_STEPS + WINDOW_STEPS), "--log-every", "1",
              "--ckpt-every", "1000"]

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--precision", default="paper_sr_bf16",
                    help="the training precision preset")
    ap.add_argument("--arch", default="qwen2-0.5b",
                    help="the model to train (qwen2-0.5b, rwkv6-1.6b or "
                         "granite-moe-1b-a400m)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch_train

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    ckpt_dir = tempfile.mkdtemp(prefix="profile_train_")
    train_args = launch_train.parser().parse_args(
        TRAIN_ARGS + ["--precision", args.precision, "--ckpt-dir",
                      ckpt_dir, "--arch", args.arch])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_step(step, metrics, dt):
        # the loss was read on the host: the step's work has finished
        if step == WARMUP_STEPS - 1:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.monotonic()
        elif step == WARMUP_STEPS + WINDOW_STEPS - 1:
            torch.cuda.synchronize()
            window["wall"] = time.monotonic() - window["t0"]
            prof.stop()

    try:
        launch_train.run(train_args, on_step=on_step)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = window["wall"]

    avgs = prof.key_averages()
    rows = [(e.key, _device_us(e), e.count) for e in avgs
            if _device_us(e) > 0 and e.device_type is not None
            and str(e.device_type).endswith("CUDA")]
    busy = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    port = {k: sum(us for key, us, _ in rows if re.search(pat, key))
            for k, pat in PORT_KERNELS.items()}
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in avgs
                   if e.device_type is not None
                   and str(e.device_type).endswith("CPU")),
                  key=lambda r: -r[1])
    n = WINDOW_STEPS
    lines = [f"device: {torch.cuda.get_device_name(0)}",
             f"launch.train --arch {args.arch} {' '.join(TRAIN_ARGS)} "
             f"--precision {args.precision}: window {n} steps after "
             f"{WARMUP_STEPS}, wall {wall * 1e3 / n:.3f} ms/step (under the "
             f"profiler)",
             f"device busy {busy / 1e3 / n:.3f} ms/step "
             f"({busy / 1e6 / wall:.3f} of wall; idle "
             f"{1 - busy / 1e6 / wall:.3f})",
             "port kernels, device ms/step (share of busy): " + ", ".join(
                 f"{k} {us / 1e3 / n:.3f} ({us / busy:.3f})"
                 for k, us in port.items()),
             "device time by kernel (ms/step, launches/step):"]
    for key, us, c in rows[:25]:
        lines.append(f"  {us / 1e3 / n:10.3f}  {c / n:8.1f}  {key[:100]}")
    lines.append("host operators by self host time (ms/step, calls/step):")
    for key, us, c in host[:15]:
        lines.append(f"  {us / 1e3 / n:10.3f}  {c / n:8.1f}  {key[:100]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
