"""Training steps for the paper's own networks (AlexNet, VGG-16, MLP0,
GRU0 and the captioning CNN -> GRU).

The counterpart of the reference's benchmark steps
(``benchmarks/fig16_suite.py``: loss and gradients) and of its Fig 10
step (``benchmarks/fig10_precision.py``: SGD ``p - lr * g``, with an
optional fixed-point writeback of every leaf).  FF + BP are autograd of
the net's loss with every weight product through the PE seam at
``Phase.FF`` (the cuda backend's FF / BP / UP words run ``sr_matmul`` and
``outer_accum``); UP's SR entropy, where a word asks for SR, is seeded
from the step key as ``make_train_step`` seeds its context's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.paper_nets import (CNNConfig, GRUConfig, MLPConfig,
                                            PAPER_NETS)
from repro_torch.core.rounding import FixedPointConfig, fixed_quantize, fold_key
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.engine.dispatch import BACKENDS
from repro_torch.models import caption, cnn, rnn
from repro_torch.runtime.train_loop import resolve_device

CAPTION = "paper-captioning-gru"


@dataclass(frozen=True)
class PaperNet:
    """One of the paper's networks: its kind, its config and, for the
    captioning net, its conv stack; MLP0's input and output widths."""
    name: str
    kind: str
    cfg: object
    cnn: Optional[CNNConfig] = None
    n_in: int = 2560
    n_out: int = 256


def paper_net(name: str) -> PaperNet:
    """The net of PAPER_NETS[name] at its full width."""
    cfg = PAPER_NETS[name]
    if name == CAPTION:
        return PaperNet(name, "caption", cfg, caption.CAPTION_CNN)
    kind = {CNNConfig: "cnn", MLPConfig: "mlp", GRUConfig: "gru"}[type(cfg)]
    return PaperNet(name, kind, cfg)


def init_params(net: PaperNet, generator: torch.Generator) -> dict:
    """f32 parameters on the generator's device."""
    if net.kind == "cnn":
        return cnn.init(generator, net.cfg)
    if net.kind == "mlp":
        return rnn.mlp_init(generator, net.cfg, net.n_in, net.n_out)
    if net.kind == "gru":
        return rnn.gru_init(generator, net.cfg)
    return caption.init(generator, net.cfg, net.cnn)


def synthetic_batch(net: PaperNet, batch: int,
                    generator: torch.Generator) -> dict:
    """A seeded batch on the generator's device: images (B, H, W, C) and
    class labels for a CNN; inputs and MSE targets for the others (the
    GRUs' over their T steps; the captioning net's images and GRU
    targets)."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev)

    if net.kind in ("cnn", "caption"):
        c = net.cfg if net.kind == "cnn" else net.cnn
        images = normal(batch, c.in_hw, c.in_hw, c.in_ch)
        if net.kind == "cnn":
            return {"images": images, "labels": torch.randint(
                0, c.n_classes, (batch,), generator=generator, device=dev)}
        return {"images": images,
                "y": normal(batch, net.cfg.T, net.cfg.n_output)}
    if net.kind == "mlp":
        return {"x": normal(batch, net.n_in), "y": normal(batch, net.n_out)}
    g = net.cfg
    return {"x": normal(batch, g.T, g.n_input),
            "y": normal(batch, g.T, g.n_output)}


def loss_fn(net: PaperNet, params: dict, batch: dict, *,
            backend: str = "reference", key: Optional[int] = None,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The net's training loss: cross-entropy for a CNN, MSE for the rest
    (`compute_dtype` is that of the CNN, MLP and captioning convs; the
    GRU computes in f32)."""
    if net.kind == "cnn":
        return cnn.loss_fn(net.cfg, params, batch, backend=backend, key=key,
                           compute_dtype=compute_dtype)
    if net.kind == "mlp":
        y = rnn.mlp_forward(net.cfg, params, batch["x"], backend=backend,
                            key=key, compute_dtype=compute_dtype)
        return torch.mean((y - batch["y"]) ** 2)
    if net.kind == "gru":
        return rnn.gru_loss(net.cfg, params, batch, backend=backend, key=key)
    return caption.loss_fn(params, batch, gcfg=net.cfg, ccfg=net.cnn,
                           backend=backend, key=key,
                           compute_dtype=compute_dtype)


def make_paper_step(net: PaperNet, *, lr: float, backend: str = "reference",
                    device=None, writeback: Optional[FixedPointConfig] = None):
    """``step(params, batch, key, generator=None) -> (new params,
    {"loss", "grad_norm"})``: one SGD step of `net` on `device` (CUDA,
    or raise, unless the caller names one).  With `writeback` every new
    leaf is quantized through that fixed-point format (Fig 10), drawing
    its SR entropy from `generator`.  The old params are not modified."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; one of "
                         f"{BACKENDS}")
    dev = resolve_device(device)

    def step(params: dict, batch: dict, key: int,
             generator: Optional[torch.Generator] = None):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_leaves(req)]
        # the step's UP entropy: only the cuda backend draws any
        up = fold_key(key, 1) if backend == "cuda" else None
        with torch.enable_grad():
            loss = loss_fn(net, req, batch, backend=backend, key=up)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [p - lr * g for p, g in zip(leaves, grads)]
            if writeback is not None:
                new = [fixed_quantize(p, writeback, generator) for p in new]
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        return (tree_unflatten(params, new),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step


def train_flops(net: PaperNet, batch: int) -> float:
    """The model FLOPs of one training step: three times the forward's
    multiply-adds x 2 (FF, BP and UP of every conv and weight product;
    pooling and elementwise work not counted)."""
    def cnn_fwd(c: CNNConfig, with_fcs: bool) -> float:
        hw, ch, f = c.in_hw, c.in_ch, 0.0
        for s in c.convs:
            f += 2 * cnn.conv_hw(hw, s) ** 2 * s.kernel ** 2 * ch * s.out_ch
            hw, ch = cnn.conv_out_hw(hw, s), s.out_ch
        if with_fcs:
            widths = [hw * hw * ch, *c.fcs, c.n_classes]
            f += sum(2 * a * b for a, b in zip(widths, widths[1:]))
        return f

    def gru_fwd(g: GRUConfig) -> float:
        ni, nh, no = g.n_input, g.n_hidden, g.n_output
        return 2 * g.T * (ni * 3 * nh + nh * 3 * nh + nh * no)

    if net.kind == "cnn":
        fwd = cnn_fwd(net.cfg, True)
    elif net.kind == "mlp":
        widths = [net.n_in, *net.cfg.widths, net.n_out]
        fwd = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    elif net.kind == "gru":
        fwd = gru_fwd(net.cfg)
    else:
        fwd = cnn_fwd(net.cnn, False) + gru_fwd(net.cfg)
    return 3 * fwd * batch

