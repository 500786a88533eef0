"""Turn a reference parameter pytree or TrainState (as numpy arrays) into
the port's.

The port keeps the reference's keys and layouts (``embed.table`` (V, d),
``groups.u0.attn.qkv`` (n_groups, d, (H+2K)*hd), ``qkv_bias``, ``o``,
``ffn.ffn_in`` (n_groups, d, 2f), ``ffn.ffn_out``, ``norm1/2.scale``
and ``bias``, ``final_norm``, ``lm_head``, and rwkv6's
``groups.u0.rwkv.{rkvg, decay, o, w0, u, mix}``, a MoE unit's
``groups.u0.moe.{router, experts_in, experts_gate, experts_out}``
((n_groups, d, E), (n_groups, E, d, f), (n_groups, E, d, f),
(n_groups, E, f, d)), and the paper nets'
``convs`` / ``fcs`` / ``layers`` lists of layer dicts), so conversion is
a walk over nested dicts and lists.  bf16 arrays
(numpy has no bf16; they arrive as ml_dtypes' or as uint16 views) are
carried by bit pattern.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cpu",
                      dtype: Optional[torch.dtype] = None):
    """Nested dicts / lists of numpy arrays -> the same tree of torch
    tensors on `device`; floating leaves cast to `dtype` when given.  A
    list stays a list, so its leaves keep JAX's order (index order)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _leaf(tree, device, dtype)


def state_from_numpy(state: dict, device="cpu") -> dict:
    """A reference TrainState {"params", "opt": {"m", "v", ...}, "step"}
    (as numpy arrays) -> the port's training state, leaves carried by bit
    pattern, the step as an int."""
    return {"params": params_from_numpy(state["params"], device),
            "opt": params_from_numpy(state["opt"], device),
            "step": int(np.asarray(state["step"]))}
