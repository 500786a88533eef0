"""Training CLI: the paper's FF / BP / UP step over SyntheticLM batches.

    # on the GPU, through the hand-written kernels, at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --kernel-backend cuda --batch 4 --seq 256 --steps 8

    # on the CPU at the reduced size
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 12 --batch 4 --seq 32 --log-every 2

Without ``--device`` it runs on CUDA and fails when there is none.  It
drives the fault-tolerant loop (checkpoints every ``--ckpt-every`` steps
and at the end, restart from the latest on a failed step).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def run(args, on_step=None) -> dict:
    """Train as `args` says.  on_step(step, metrics, seconds) is called
    after every step.  Returns {"losses", "seconds", "state"}."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_config, get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import train_loop as tl
    from repro_torch.runtime.fault_tolerance import run_with_recovery

    dev = tl.resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    shape = ShapeConfig("custom", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    program = compile_program(cfg, shape, precision=args.precision)
    train_cfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                            precision=args.precision, remat=args.remat,
                            kernel_backend=args.kernel_backend,
                            microbatch=args.microbatch)
    step_fn, opt = tl.make_train_step(cfg, program, train_cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params={cfg.param_count()} precision={args.precision} "
          f"backend={args.kernel_backend} optimizer={args.optimizer} "
          f"remat={args.remat} batch={args.batch} seq={args.seq} "
          f"device={dev}", flush=True)

    ckpt = Checkpointer(args.ckpt_dir)
    meta = {"arch": cfg.name, "precision": args.precision}

    def initial_state():
        """The latest checkpoint's state with --resume, else a new one
        from --seed.  It is made inside the call to run_with_recovery,
        so no frame here holds it while the steps run: each step's old
        state is freed once the next one exists."""
        if args.resume and ckpt.latest_step() is not None:
            state, step, _ = ckpt.restore(device=dev)
            print(f"resumed from step {step}")
            return state
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        return tl.init_state(cfg, program, train_cfg, gen, opt)

    pipe = SyntheticLM(cfg, shape)
    losses, seconds = [], []

    def on_metrics(step, metrics, dt):
        losses.append(metrics["loss"])
        seconds.append(dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms",
                  flush=True)
        if on_step is not None:
            on_step(step, metrics, dt)

    state = run_with_recovery(
        step_fn=step_fn, state=initial_state(), batches=pipe.batch_at,
        ckpt=ckpt, meta=meta, n_steps=args.steps,
        checkpoint_every=args.ckpt_every, key=args.seed,
        on_metrics=on_metrics)
    if losses:
        print(f"done: {len(losses)} steps; loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-10:]):.4f}")
    return {"losses": losses, "seconds": seconds, "state": state}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-test size of the same family")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("sgdm", "adamw", "adagrad"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--precision", default="paper_sr_bf16")
    ap.add_argument("--kernel-backend", default="reference",
                    choices=("reference", "cuda"),
                    help="engine matmul path: plain torch or the "
                         "hand-written CUDA kernels")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="block",
                    choices=("none", "block", "full"))
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, failing without one)")
    return ap


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
