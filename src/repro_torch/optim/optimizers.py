"""Optimizers with phase-UP precision semantics (paper §2.3 + §3.3.2).

The port of the reference's ``optim/optimizers.py``.  All update math
runs in f32; persistent state (params, moments) is stored at the
policy's ``param_dtype`` / ``state_dtype`` and written back through the
policy's rounding: nearest for the fp32 / bf16-master presets,
stochastic rounding for the paper's presets.  SGD+momentum, AdamW and
AdaGrad are the paper's §5.3 menu.

Each leaf's update is a function of its own (``Optimizer.leaf``), given
the leaf's SR bits or generators, so tests can feed the reference's
bits.  A live step derives one generator per written-back tensor from
the step key (leaf i, output j).  On the cuda backend the SR writeback
runs the ``sr_round`` kernel on the tensor it is given, viewed flat; on
the reference backend its plain version.

As the reference's ``_leafwise`` does, a stacked leaf (3-D or more, a
leading dim of at least 4) of more than ``_CHUNK_BYTES`` as f32 is
updated layer by layer over its leading dim, so that each f32
temporary is one layer's size (granite's (24, 32, 1024, 512) expert
tables would take 1.5 GiB each whole).  Layer l's generators come from
``fold_key(leaf key, l)``, the counterpart of the reference's
``fold_in(k, l)``.  The gradients may be bf16: each leaf (or layer)
is cast to f32 inside its update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.rounding import fold_key, sr_cast_bf16
from repro_torch.core.tree import tree_get, tree_leaves, tree_map, tree_set
from repro_torch.kernels import sr_round as ksr

_F32 = torch.float32
# leaves above this many bytes as f32 are updated layer by layer
# (the reference's optim/optimizers.py _CHUNK_BYTES)
_CHUNK_BYTES = 128e6


@dataclass(frozen=True)
class Optimizer:
    init: Callable        # params -> state {"m": tree, ...}
    # (grads, state, params, step, key, rbits=None) -> (params, state)
    update: Callable
    leaf: Callable        # (g, *moments, p, step, rbits=, gens=) -> (p, *moments)


def chunked(p: torch.Tensor) -> bool:
    """Whether the update takes leaf `p` layer by layer over dim 0 (the
    reference's `_leafwise` rule: 3-D or more, a leading dim of at least
    4, more than _CHUNK_BYTES as f32)."""
    return p.dim() >= 3 and p.shape[0] >= 4 and p.numel() * 4 > _CHUNK_BYTES


def make_optimizer(cfg: TrainConfig, policy: PrecisionPolicy,
                   backend: str = "reference") -> Optimizer:
    """The optimizer `cfg.optimizer` under `policy`; `backend` picks the
    SR writeback: the sr_round kernel ('cuda') or plain torch."""
    round_fn = ksr.sr_round if backend == "cuda" else sr_cast_bf16

    def wb(x, dtype, rbits, gen):
        if dtype == _F32 or policy.update_rounding == "nearest":
            return x.to(dtype)
        return policy.writeback(x, gen, rbits=rbits,
                                round_fn=round_fn).to(dtype)

    if cfg.optimizer == "sgdm":
        leaf, names = _sgdm_leaf(cfg, policy, wb), ("m",)
    elif cfg.optimizer == "adamw":
        leaf, names = _adamw_leaf(cfg, policy, wb), ("m", "v")
    elif cfg.optimizer == "adagrad":
        leaf, names = _adagrad_leaf(cfg, policy, wb), ("v",)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    def init(params):
        return {n: tree_map(lambda p: torch.zeros(p.shape, dtype=policy
                                                  .state_dtype,
                                                  device=p.device), params)
                for n in names}

    n_out = 1 + len(names)

    def generators(k: int, device) -> list:
        gens = []
        for j in range(n_out):
            gen = torch.Generator(device=device)
            gen.manual_seed(fold_key(k, j))
            gens.append(gen)
        return gens

    def update(grads, state, params, step: int, key: Optional[int],
               rbits: Optional[Callable] = None):
        """rbits(i, layer) -> the written-back tensors' bits for leaf i
        (layer None for a leaf taken whole) replaces the generators, so
        tests can feed the reference's bits."""
        sr = policy.update_rounding != "nearest"
        if sr and key is None and rbits is None:
            raise ValueError(f"{policy.name}: SR writeback needs the step "
                             f"key")
        new_p: dict = {}
        new_s: dict = {n: {} for n in names}
        for i, (path, p) in enumerate(tree_leaves(params)):
            args = (tree_get(grads, path),
                    *(tree_get(state[n], path) for n in names), p)
            lk = fold_key(key, i) if sr and rbits is None else None

            def one(part, layer):
                kw = {}
                if rbits is not None and sr:
                    kw["rbits"] = rbits(i, layer)
                elif lk is not None:
                    kw["gens"] = generators(
                        lk if layer is None else fold_key(lk, layer),
                        p.device)
                return leaf(*part, step, **kw)

            if chunked(p):
                out = None
                for layer in range(p.shape[0]):
                    res = one([a[layer] for a in args], layer)
                    if out is None:
                        out = [torch.empty(p.shape, dtype=r.dtype,
                                           device=r.device) for r in res]
                    for o, r in zip(out, res):
                        o[layer].copy_(r)
                    del res
            else:
                out = one(args, None)
            tree_set(new_p, path, out[0])
            for n, o in zip(names, out[1:]):
                tree_set(new_s[n], path, o)
        return new_p, new_s

    return Optimizer(init, update, leaf)


def _pick(seq, j):
    return None if seq is None else seq[j]


def _sgdm_leaf(cfg: TrainConfig, policy: PrecisionPolicy, wb):
    def leaf(g, m, p, step, *, rbits=None, gens=None):
        del step
        m32 = cfg.momentum * m.to(_F32) + g.to(_F32)
        p32 = p.to(_F32) - cfg.lr * m32
        return (wb(p32, policy.param_dtype, _pick(rbits, 0), _pick(gens, 0)),
                wb(m32, policy.state_dtype, _pick(rbits, 1), _pick(gens, 1)))
    return leaf


def _adamw_leaf(cfg: TrainConfig, policy: PrecisionPolicy, wb,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
    def leaf(g, m, v, p, step, *, rbits=None, gens=None):
        # the bias corrections in f32, as the reference's traced step
        t = torch.tensor(step, dtype=_F32) + 1.0
        gf = g.to(_F32)
        m32 = b1 * m.to(_F32) + (1 - b1) * gf
        v32 = b2 * v.to(_F32) + (1 - b2) * gf * gf
        mh = m32 / (1 - b1 ** t)
        vh = v32 / (1 - b2 ** t)
        pf = p.to(_F32)
        p32 = pf - cfg.lr * (mh / (torch.sqrt(vh) + eps)
                             + cfg.weight_decay * pf)
        return (wb(p32, policy.param_dtype, _pick(rbits, 0), _pick(gens, 0)),
                wb(m32, policy.state_dtype, _pick(rbits, 1), _pick(gens, 1)),
                wb(v32, policy.state_dtype, _pick(rbits, 2), _pick(gens, 2)))
    return leaf


def _adagrad_leaf(cfg: TrainConfig, policy: PrecisionPolicy, wb,
                  eps: float = 1e-10):
    def leaf(g, v, p, step, *, rbits=None, gens=None):
        del step
        gf = g.to(_F32)
        v32 = v.to(_F32) + gf * gf
        p32 = p.to(_F32) - cfg.lr * gf / (torch.sqrt(v32) + eps)
        return (wb(p32, policy.param_dtype, _pick(rbits, 0), _pick(gens, 0)),
                wb(v32, policy.state_dtype, _pick(rbits, 1), _pick(gens, 1)))
    return leaf
