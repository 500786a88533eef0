"""PyTorch + CUDA port of the NeuroTrainer reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it (and never ``jax``).  Its layout mirrors ``repro/``:

  configs/    model configs (qwen2-0.5b and its reduced form)
  core/       phases, precision policies, SR rounding, the PE program words
  kernels/    hand-written CUDA kernels (``csrc/``) + their plain versions
  engine/     the PE dispatch seam (``pe_dot``, the fused decode word)
  models/     layers, attention, the decoder-only transformer (serving subset)
  runtime/    serve-step builders
  serving/    slot arena, scheduler, traces, the continuous-batching engine
  launch/     the serving CLI
  checkpoint/ carrying JAX parameter pytrees across as numpy arrays

Backends: ``reference`` (plain torch, the CPU oracle) and ``cuda`` (the
hand-written kernels; on a CPU tensor each kernel wrapper runs its plain
version, on a CUDA tensor it launches the kernel or raises).
"""
