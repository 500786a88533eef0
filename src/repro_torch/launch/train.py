"""Training CLI: the paper's FF / BP / UP step over SyntheticLM batches.

    # on the GPU, through the hand-written kernels, at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --kernel-backend cuda --batch 4 --seq 256 --steps 8

    # on the CPU at the reduced size
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 12 --batch 4 --seq 32 --log-every 2

    # jamba-v0.1-52b on one card: one period (8 of 32 layers) at full
    # width with 4 of its 16 experts (one_card_train_config); its loss
    # falls at lr 1e-5 and rises at the default 3e-4
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-v0.1-52b --kernel-backend cuda --batch 4 --seq 256 \\
        --steps 8 --lr 1e-5 --ckpt-every 0

Without ``--device`` it runs on CUDA and fails when there is none.  On
the card a model whose training state does not fit is cut to fit
(:func:`one_card_train_config`), and the cut is printed.  It drives the
fault-tolerant loop (checkpoints every ``--ckpt-every`` steps and at the
end, restart from the latest on a failed step; ``--ckpt-every 0`` writes
none, and a failed step then ends the run).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

def train_state_bytes(cfg, train_cfg) -> int:
    """Bytes of what a training step of `cfg` under `train_cfg` holds
    between steps and at its update: the params and the optimizer's
    state (the meta tensors of ``train_loop.state_shapes``), and one
    gradient a parameter, in the params' dtype (f32 where microbatches
    sum into it).  paper_sr_bf16 with adamw: 8 bytes a parameter; fp32
    with adamw: 16."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.program import compile_program
    from repro_torch.core.tree import tree_leaves
    from repro_torch.runtime import train_loop as tl

    program = compile_program(cfg, ShapeConfig("size", 1, 1, "train"),
                              precision=train_cfg.precision)
    state = tl.state_shapes(cfg, program, train_cfg)
    params = [t for _, t in tree_leaves(state["params"])]
    grad = 4 if train_cfg.microbatch > 1 else params[0].element_size()
    return sum(t.numel() * (t.element_size() + grad) for t in params) \
        + sum(t.numel() * t.element_size()
              for _, t in tree_leaves(state["opt"]))


def one_card_train_config(cfg, card_bytes: int, train_cfg=None):
    """`cfg` whole where its training state (:func:`train_state_bytes`
    under `train_cfg`, by default paper_sr_bf16 with adamw) takes at most
    half the card's memory (the rest holds the update's new state and
    the activations); else cut to one period of its layer pattern (every
    unit kind), then each MoE unit's experts halved, top-k kept, until it
    fits: jamba-v0.1-52b under paper_sr_bf16 8 of 32 layers and 4 of 16
    experts (4.84 B parameters, 38.7 GB).  Every product keeps its
    published shape.  Raises ValueError where even the smallest such
    cut does not fit (jamba under fp32 with adamw: 54.9 GB at 2
    experts)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import transformer as tfm

    train_cfg = train_cfg or TrainConfig()

    def fits(c):
        return train_state_bytes(c, train_cfg) <= card_bytes // 2

    if fits(cfg):
        return cfg
    cut = dataclasses.replace(cfg, n_layers=len(tfm.layer_pattern(cfg)))
    while not fits(cut) and cut.moe is not None \
            and cut.moe.n_experts // 2 >= cut.moe.top_k:
        cut = dataclasses.replace(cut, moe=dataclasses.replace(
            cut.moe, n_experts=cut.moe.n_experts // 2))
    if not fits(cut):
        raise ValueError(
            f"{cfg.name}: the training state under {train_cfg.precision} "
            f"with {train_cfg.optimizer} takes "
            f"{train_state_bytes(cut, train_cfg) / 1e9:.1f} GB at "
            f"{cut.n_layers} layers"
            + (f" and {cut.moe.n_experts} experts" if cut.moe else "")
            + f", over half of a card of {card_bytes / 1e9:.1f} GB")
    return cut


def run(args, on_step=None) -> dict:
    """Train as `args` says.  on_step(step, metrics, seconds) is called
    after every step.  Returns {"losses", "seconds", "state", "cfg"}
    (the model as trained: cut to fit the card where it had to be)."""
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
    train_cfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                            precision=args.precision, remat=args.remat,
                            kernel_backend=args.kernel_backend,
                            microbatch=args.microbatch)
    if dev.type == "cuda":
        card = torch.cuda.get_device_properties(dev).total_memory
        whole, cfg = cfg, one_card_train_config(cfg, card, train_cfg)
        if cfg != whole:
            print(f"cut to fit one card of {card / 2**30:.1f} GiB: "
                  f"{cfg.n_layers} of {whole.n_layers} layers"
                  + (f", {cfg.moe.n_experts} of {whole.moe.n_experts} "
                     f"experts (top-{cfg.moe.top_k})" if cfg.moe else "")
                  + f", {cfg.param_count()} of {whole.param_count()} "
                  f"params", flush=True)
    shape = ShapeConfig("custom", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    program = compile_program(cfg, shape, precision=args.precision)
    step_fn, opt = tl.make_train_step(cfg, program, train_cfg)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"params={cfg.param_count()} precision={args.precision} "
          f"backend={args.kernel_backend} optimizer={args.optimizer} "
          f"remat={args.remat} batch={args.batch} seq={args.seq} "
          f"device={dev}", flush=True)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_every > 0 else None
    meta = {"arch": cfg.name, "precision": args.precision}

    def initial_state():
        """The latest checkpoint's state with --resume, else a new one
        from --seed.  It is made inside the call to run_with_recovery,
        so no frame here holds it while the steps run: each step's old
        state is freed once the next one exists."""
        if args.resume and ckpt is not None \
                and ckpt.latest_step() is not None:
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
        peak = (f"; peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if dev.type == "cuda" else "")
        print(f"done: {len(losses)} steps; loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-10:]):.4f}{peak}")
    return {"losses": losses, "seconds": seconds, "state": state,
            "cfg": cfg}


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
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none, not even at "
                         "the end)")
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
