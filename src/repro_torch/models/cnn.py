"""The paper's baseline CNNs (AlexNet, VGG-16): the networks NeuroTrainer
is evaluated on in Fig 13 / 16 / 17.

Port of ``repro/models/cnn.py``.  The parameters keep the reference's
layouts — conv weights HWIO, FC weights (in, out), ``{"convs": [...],
"fcs": [...]}`` — and activations are NHWC at this module's edges.
Inside :func:`_conv` the NHWC tensor is read as an NCHW view of
channels-last memory, so torch's convolution (cuDNN on the card) takes
it without a copy; the flatten before FC1 runs in NHWC order, as the
reference's, so FC1's weights mean the same thing in both packages.

The conv FF, BP and dW stay on torch's convolution and its autograd, as
the reference leaves them to XLA.  The FC layers go through the PE seam
(``engine/dispatch.pe_dot``): FF and BP on ``sr_matmul``, UP on
``outer_accum``.  :func:`conv_up_as_matmul` is the paper's Fig 6
lowering of the conv weight update, one f32 ``outer_accum`` word per tap.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_nets import CNNConfig, ConvSpec
from repro_torch.core.phases import Phase
from repro_torch.engine.dispatch import BACKENDS, op_key, pe_dot
from repro_torch.kernels import outer_accum as koa
from repro_torch.models.layers import param_normal


def conv_hw(hw: int, c: ConvSpec) -> int:
    """The side of a conv's output, before its pool."""
    return (hw - c.kernel) // c.stride + 1 if c.pad == "VALID" \
        else -(-hw // c.stride)


def conv_out_hw(hw: int, c: ConvSpec) -> int:
    """The side of a conv's output after its pool."""
    hw = conv_hw(hw, c)
    return hw // c.pool if c.pool else hw


def init(generator: torch.Generator, cfg: CNNConfig) -> dict:
    """f32 parameters on the generator's device: He-normal conv (HWIO)
    and FC (in, out) weights, zero biases."""
    dev = generator.device

    def normal(shape, fan_in):
        return param_normal(generator, shape, (2.0 / fan_in) ** 0.5)

    params: dict = {"convs": [], "fcs": []}
    ch, hw = cfg.in_ch, cfg.in_hw
    for c in cfg.convs:
        params["convs"].append({
            "w": normal((c.kernel, c.kernel, ch, c.out_ch),
                        c.kernel * c.kernel * ch),
            "b": torch.zeros((c.out_ch,), dtype=torch.float32, device=dev)})
        ch, hw = c.out_ch, conv_out_hw(hw, c)
    widths = [hw * hw * ch, *cfg.fcs, cfg.n_classes]
    for j in range(len(widths) - 1):
        params["fcs"].append({
            "w": normal((widths[j], widths[j + 1]), widths[j]),
            "b": torch.zeros((widths[j + 1],), dtype=torch.float32,
                             device=dev)})
    return params


def _same_pads(n: int, k: int, s: int) -> tuple:
    """(low, high) padding of one spatial axis under "SAME"."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, c: ConvSpec, p: dict) -> torch.Tensor:
    """conv + bias + relu (+ 2-D max pool, floor), x (B, H, W, C) ->
    (B, Ho, Wo, Co) in x.dtype."""
    xc = x.permute(0, 3, 1, 2)                    # NCHW view, channels-last
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)    # HWIO -> OIHW
    pad = (0, 0)
    if c.pad == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[1], c.kernel, c.stride),
                              _same_pads(x.shape[2], c.kernel, c.stride))
        if ht == hb and wl == wr:
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
    elif c.pad != "VALID":
        raise ValueError(f"unknown padding {c.pad!r}")
    y = F.conv2d(xc, w, stride=c.stride, padding=pad)
    y = F.relu(y + p["b"].to(x.dtype)[:, None, None])
    if c.pool:
        # the paper's comparator unit returns (max, ID); autograd's
        # max-pool backward sends the gradient to that ID
        y = F.max_pool2d(y, c.pool, c.pool)
    return y.permute(0, 2, 3, 1)


def forward(cfg: CNNConfig, params: dict, x: torch.Tensor, *,
            compute_dtype: torch.dtype = torch.bfloat16,
            backend: str = "reference",
            key: Optional[int] = None) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes) f32.  `key` seeds the FC
    words' UP entropy (drawn only by a word that asks for SR)."""
    x = x.to(compute_dtype)
    for c, p in zip(cfg.convs, params["convs"]):
        x = _conv(x, c, p)
    x = x.reshape(x.shape[0], -1)                 # NHWC order
    last = len(params["fcs"]) - 1
    for j, p in enumerate(params["fcs"]):
        k = None if key is None else op_key(key, f"fc{j}")
        x = pe_dot(x, p["w"], backend=backend, phase=Phase.FF, key=k) \
            + p["b"].to(x.dtype)
        if j < last:
            x = F.relu(x)
    return x.to(torch.float32)


def loss_fn(cfg: CNNConfig, params: dict, batch: dict, *,
            compute_dtype: torch.dtype = torch.bfloat16,
            backend: str = "reference",
            key: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross-entropy of batch {"images" (B, H, W, C),
    "labels" (B,)}."""
    logits = forward(cfg, params, batch["images"],
                     compute_dtype=compute_dtype, backend=backend, key=key)
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def conv_up_as_matmul(x: torch.Tensor, dy: torch.Tensor, kernel: int,
                      stride: int = 1, pad: str = "SAME", *,
                      backend: str = "reference") -> torch.Tensor:
    """The paper's Fig 6 lowering: the conv weight update dW = X * dY as
    one outer-product word per conv tap.

    x (B, H, W, Ci), dy (B, Ho, Wo, Co) -> dW (k, k, Ci, Co) f32.  Each
    tap's input patch (B*Ho*Wo, Ci) is copied contiguous in f32 and runs
    ``outer_accum`` with dY (B*Ho*Wo, Co): the hand-written kernel's f32
    path on the cuda backend, its plain version on the reference backend.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; one of "
                         f"{BACKENDS}")
    B, H, W, Ci = x.shape
    Ho, Wo, Co = dy.shape[1:]
    if pad == "SAME":
        lo, hi = (kernel - 1) // 2, kernel // 2
        x = F.pad(x, (0, 0, lo, hi, lo, hi))
    dym = dy.reshape(-1, Co).to(torch.float32).contiguous()
    up = koa.outer_accum if backend == "cuda" else koa.outer_accum_plain
    taps = []
    for i in range(kernel):
        for j in range(kernel):
            xp = x[:, i:i + (Ho - 1) * stride + 1:stride,
                   j:j + (Wo - 1) * stride + 1:stride]
            taps.append(up(xp.reshape(-1, Ci).to(torch.float32)
                           .contiguous(), dym))
    return torch.stack(taps).reshape(kernel, kernel, Ci, Co)
