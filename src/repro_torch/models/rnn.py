"""The paper's baseline GRU and MLP0 (Fig 10, Fig 14-16).

Port of ``repro/models/rnn.py``.  The GRU keeps the reference's
per-time-step structure: three weight words a step (the input product
``x_t . wx``, the recurrent ``h . wh`` and the output ``h . wo``), each
through the PE seam under ``_GRU_WORD`` — f32 operands for FF and BP, so
on the cuda backend ``sr_matmul``'s f32 path and ``outer_accum``'s f32
UP.  An optional ``quant`` hook applies after every product and to the
recurrent state: that is how the Fig 10 study injects the fixed-point
MAC datapath (``core/rounding.fixed_quantize``) without forking the
model.  MLP0's layers run the default bf16 word.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_nets import GRUConfig, MLPConfig
from repro_torch.core.phases import Phase
from repro_torch.core.program import PEWord
from repro_torch.engine.dispatch import op_key, pe_dot
from repro_torch.models.layers import param_normal

QuantFn = Optional[Callable[[torch.Tensor], torch.Tensor]]

# f32 operands: the paper's fixed-point datapath is injected by the
# `quant` hook, not by the bf16 ladder — the word must not down-cast
_GRU_WORD = PEWord(op="gru", ff_dtype="float32", bp_dtype="float32")


def gru_init(generator: torch.Generator, cfg: GRUConfig) -> dict:
    """f32 parameters on the generator's device: wx (n_input, 3 n_hidden), wh (n_hidden, 3 n_hidden), b
    (3 n_hidden,), wo (n_hidden, n_output)."""
    ni, nh, no = cfg.n_input, cfg.n_hidden, cfg.n_output
    return {"wx": param_normal(generator, (ni, 3 * nh), ni ** -0.5),
            "wh": param_normal(generator, (nh, 3 * nh), nh ** -0.5),
            "b": torch.zeros((3 * nh,), dtype=torch.float32,
                             device=generator.device),
            "wo": param_normal(generator, (nh, no), nh ** -0.5)}


def gru_forward(cfg: GRUConfig, params: dict, x: torch.Tensor,
                quant: QuantFn = None, *, backend: str = "reference",
                key: Optional[int] = None) -> tuple:
    """x (B, T, n_input) -> (outputs (B, T, n_output), final h (B,
    n_hidden)).  `key` seeds the words' UP entropy (drawn only by a word
    that asks for SR)."""
    q = (lambda a: a) if quant is None else quant
    wx, wh, b, wo = (params[k] for k in ("wx", "wh", "b", "wo"))
    nh = cfg.n_hidden
    h = torch.zeros((x.shape[0], nh), dtype=torch.float32, device=x.device)

    def dot(name, a, w):
        k = None if key is None else op_key(key, name)
        return pe_dot(a, w, word=_GRU_WORD, backend=backend, phase=Phase.FF,
                      key=k)

    ys = []
    for t in range(x.shape[1]):
        gx = q(dot("gru_x", x[:, t], wx))
        gh = q(dot("gru_h", h, wh))
        r = torch.sigmoid(gx[:, :nh] + gh[:, :nh] + b[:nh])
        z = torch.sigmoid(gx[:, nh:2 * nh] + gh[:, nh:2 * nh]
                          + b[nh:2 * nh])
        n = torch.tanh(gx[:, 2 * nh:] + r * gh[:, 2 * nh:] + b[2 * nh:])
        h = q((1 - z) * n + z * h)
        ys.append(q(dot("gru_o", h, wo)))
    return torch.stack(ys, dim=1), h


def gru_loss(cfg: GRUConfig, params: dict, batch: dict,
             quant: QuantFn = None, *, backend: str = "reference",
             key: Optional[int] = None) -> torch.Tensor:
    """Mean squared error of batch {"x" (B, T, n_input), "y" (B, T,
    n_output)} (the paper's Fig 10 trains an RNN to MSE)."""
    y, _ = gru_forward(cfg, params, batch["x"], quant, backend=backend,
                       key=key)
    return torch.mean((y - batch["y"]) ** 2)


# ---------------------------------------------------------------------------
# MLP0
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, cfg: MLPConfig,
             n_in: int = 2560, n_out: int = 256) -> dict:
    """{"layers": [{"w" (in, out), "b"}, ...]} in f32 on the generator's
    device."""
    widths = [n_in, *cfg.widths, n_out]
    return {"layers": [
        {"w": param_normal(generator, (widths[i], widths[i + 1]),
                           widths[i] ** -0.5),
         "b": torch.zeros((widths[i + 1],), dtype=torch.float32,
                          device=generator.device)}
        for i in range(len(widths) - 1)]}


def mlp_forward(cfg: MLPConfig, params: dict, x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                backend: str = "reference",
                key: Optional[int] = None) -> torch.Tensor:
    """x (B, n_in) -> (B, n_out) f32, relu between the layers."""
    x = x.to(compute_dtype)
    last = len(params["layers"]) - 1
    for i, p in enumerate(params["layers"]):
        k = None if key is None else op_key(key, f"mlp{i}")
        x = pe_dot(x, p["w"], backend=backend, phase=Phase.FF, key=k) \
            + p["b"].to(x.dtype)
        if i < last:
            x = F.relu(x)
    return x.to(torch.float32)
