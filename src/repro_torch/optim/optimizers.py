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
runs the ``sr_round`` kernel on the whole leaf, viewed flat; on the
reference backend its plain version.  Unlike the reference, which scans
very large stacked leaves layer by layer to bound its f32 temporaries,
the port updates each leaf in one piece: the full-width model's largest
leaf (24 x 896 x 9728) needs a few GB of f32 temporaries, which one
card holds.
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


@dataclass(frozen=True)
class Optimizer:
    init: Callable        # params -> state {"m": tree, ...}
    update: Callable      # (grads, state, params, step, key) -> (params, state)
    leaf: Callable        # (g, *moments, p, step, rbits=, gens=) -> (p, *moments)


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

    def update(grads, state, params, step: int, key: Optional[int]):
        sr = policy.update_rounding != "nearest"
        new_p: dict = {}
        new_s: dict = {n: {} for n in names}
        for i, (path, p) in enumerate(tree_leaves(params)):
            g = tree_get(grads, path)
            moments = [tree_get(state[n], path) for n in names]
            gens = None
            if sr:
                if key is None:
                    raise ValueError(f"{policy.name}: SR writeback needs "
                                     f"the step key")
                lk = fold_key(key, i)
                gens = []
                for j in range(1 + len(names)):
                    gen = torch.Generator(device=p.device)
                    gen.manual_seed(fold_key(lk, j))
                    gens.append(gen)
            out = leaf(g, *moments, p, step, gens=gens)
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
