"""Train / serve step builders: where the program words meet the model.

``make_train_step`` assembles the paper's three phases into one step:
FF + BP — autograd of the model loss under a ``PEContext`` at
``Phase.FF`` (the cuda backend's FF / BP / UP words run the
hand-written kernels), then UP — the optimizer with the SR writeback of
persistent state.  Microbatch gradients accumulate in f32; a whole
batch's gradients go to the optimizer at the parameters' dtype, which
casts each leaf (or layer of a stacked leaf) to f32 as it updates it,
so no f32 copy of the whole gradient tree exists.  Each builder returns
a plain function (torch runs eagerly; there is no jit to wrap).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.phases import Phase
from repro_torch.core.program import Program
from repro_torch.core.rounding import fold_key
from repro_torch.engine.context import PEContext
from repro_torch.models import transformer as tfm
from repro_torch.core.tree import tree_leaves, tree_map, tree_set
from repro_torch.optim.optimizers import make_optimizer


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  With no GPU and no explicit request it raises — the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def cast_params(params, dtype: torch.dtype):
    """Persistent storage cast: every f32 leaf to `dtype`."""
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32
                    else p, params)


def split_microbatches(batch: dict, nm: int) -> dict:
    """Strided microbatch split: microbatch m takes rows r with
    r % nm == m.  Leaves (numpy arrays or tensors) become
    (nm, B/nm, ...)."""
    return {k: v.reshape(v.shape[0] // nm, nm, *v.shape[1:]).swapaxes(0, 1)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, program: Program,
                    train_cfg: TrainConfig):
    """(train_step, optimizer) of a dense attention, rwkv6 or MoE model
    (a MoE table's FF / BP / UP words run batched over its experts; its
    loss carries the load-balancing term).
    ``train_step(state, batch, key)`` takes
    the state {"params", "opt", "step"}, a batch of numpy arrays or
    tensors {"tokens", "labels"} and the step's integer key, and returns
    (new state, {"loss", "grad_norm"}) — the tensors of the new state are
    new; the old state is not modified, and the step holds nothing of it
    once it returns (a caller that drops its reference frees it)."""
    policy = program.policy
    backend = train_cfg.kernel_backend
    opt = make_optimizer(train_cfg, policy, backend)
    sh = PEContext(program, backend=backend, phase=Phase.FF)

    def train_step(state: dict, batch: dict, key: int):
        # the step's UP entropy: only the cuda backend draws any
        sh_step = sh.with_key(fold_key(key, 1)) if backend == "cuda" else sh
        params = state["params"]
        paths = [p for p, _ in tree_leaves(params)]
        dev = tree_leaves(params)[0][1].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

        def loss_and_grads(b):
            req = tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                loss = tfm.loss_fn(cfg, req, b, sh_step,
                                   compute_dtype=policy.ff_dtype,
                                   remat=train_cfg.remat)
                grads = torch.autograd.grad(
                    loss, [p for _, p in tree_leaves(req)])
            return loss.detach(), grads

        nm = train_cfg.microbatch
        if nm and nm > 1:
            micro = split_microbatches(batch, nm)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for _, p in tree_leaves(params)]
            for i in range(nm):
                li, gi = loss_and_grads({k: v[i] for k, v in micro.items()})
                loss = loss + li
                for a, b in zip(grads, gi):
                    a.add_(b)
                del gi          # before the next microbatch's backward
            loss = loss / nm
            for g in grads:
                g.div_(nm)
        else:
            loss, grads = loss_and_grads(batch)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in grads))
        gtree: dict = {}
        for path, g in zip(paths, grads):
            tree_set(gtree, path, g)
        del grads
        upd_key = key if policy.update_rounding != "nearest" else None
        new_params, new_opt = opt.update(gtree, state["opt"], params,
                                         state["step"], upd_key)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm})

    return train_step, opt


def init_state(cfg: ModelConfig, program: Program, train_cfg: TrainConfig,
               generator: Optional[torch.Generator], opt=None) -> dict:
    """{"params", "opt", "step"}: parameters from ``tfm.init`` cast to the
    policy's storage dtype, zero moments, step 0.  Without a generator
    the tensors lie on the meta device (shapes and dtypes only)."""
    policy = program.policy
    if opt is None:
        opt = make_optimizer(train_cfg, policy, train_cfg.kernel_backend)
    params = cast_params(tfm.init(generator, cfg), policy.param_dtype)
    return {"params": params, "opt": opt.init(params), "step": 0}


def state_shapes(cfg: ModelConfig, program: Program,
                 train_cfg: TrainConfig) -> dict:
    """The whole training state as meta tensors: no allocation."""
    return init_state(cfg, program, train_cfg, None)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{leaf path: (shape, dtype)} of the decode cache, without
    allocating it: the KV ring of an attention model, the recurrent state
    of an rwkv6 model (independent of max_len)."""
    ng = tfm.n_groups(cfg)
    if tfm.layer_pattern(cfg)[0].mixer == "rwkv6":
        hd = cfg.ssm.head_dim
        return {"u0/rwkv/wkv": ((ng, batch, cfg.d_model // hd, hd, hd),
                                torch.float32),
                "u0/rwkv/shift": ((ng, batch, cfg.d_model), torch.bfloat16)}
    a = cfg.attention
    size = min(max_len, a.window) if a.window else max_len
    kv = ((ng, batch, size, a.n_kv_heads, a.head_dim), torch.bfloat16)
    return {"u0/attn/k": kv, "u0/attn/v": kv,
            "u0/attn/pos": ((ng, batch, size), torch.int32)}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    return sum(math.prod(shape) * (torch.finfo(dt).bits if dt.is_floating_point
                                   else torch.iinfo(dt).bits) // 8
               for shape, dt in cache_shapes(cfg, batch, max_len).values())


def make_chunk_step(cfg: ModelConfig, program: Program,
                    kernel_backend: str = "reference"):
    """Multi-token cache step under the PREFILL program word."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.PREFILL)
    dt = program.policy.ff_dtype

    def chunk(params, cache, tokens, pos0):
        return tfm.chunk_step(cfg, params, tokens, cache, pos0, sh,
                              compute_dtype=dt)

    return chunk


def make_decode_step(cfg: ModelConfig, program: Program,
                     kernel_backend: str = "reference"):
    """One-token serve step under the per-op DECODE words (dense attention,
    rwkv6 and MoE units)."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.DECODE)
    dt = program.policy.ff_dtype

    def decode(params, cache, tokens, pos, active=None):
        return tfm.decode_step(cfg, params, tokens, cache, pos, sh,
                               compute_dtype=dt, active=active)

    return decode


def make_fused_decode_step(cfg: ModelConfig, program: Program,
                           kernel_backend: str = "reference"):
    """One-token serve step with each layer as ONE fused-decode word (an
    rwkv6 layer: its per-op mixer, then one fused FF word; a MoE layer:
    one fused attention word, then its per-op MoE FF)."""
    sh = PEContext(program, backend=kernel_backend, phase=Phase.DECODE)
    dt = program.policy.ff_dtype

    def decode(params, cache, tokens, pos, active=None):
        return tfm.decode_step(cfg, params, tokens, cache, pos, sh,
                               compute_dtype=dt, fused=True, active=active)

    return decode
