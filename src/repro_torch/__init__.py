"""PyTorch + CUDA port of the NeuroTrainer reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it (and never ``jax``).  Its layout mirrors ``repro/``:

  configs/    model, shape and train configs (qwen2-0.5b, rwkv6-1.6b and
              their reduced forms)
  core/       phases, precision policies, SR rounding, the PE program words
  data/       the deterministic synthetic LM pipeline
  kernels/    hand-written CUDA kernels (``csrc/``) + their plain versions
  engine/     the PE dispatch seam (``pe_dot``: FF/BP/UP and serving words)
  models/     layers, attention, RWKV6 time-mix (ssm.py), the decoder-only
              transformer (dense attention units; rwkv6 units for serving)
  optim/      sgdm / adamw / adagrad with the SR writeback
  runtime/    train- and serve-step builders, single-process fault tolerance
  serving/    slot arena, scheduler, traces, the continuous-batching engine
  launch/     the training and serving CLIs and their profilers
  checkpoint/ training-state checkpoints; carrying JAX trees across

Backends: ``reference`` (plain torch, the CPU oracle) and ``cuda`` (the
hand-written kernels; on a CPU tensor each kernel wrapper runs its plain
version, on a CUDA tensor it launches the kernel or raises).
"""
