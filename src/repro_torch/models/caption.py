"""The paper's captioning network (§5.1, Fig 14/15): AlexNet's conv
stack feeding the captioning GRU.

AlexNet conv1-conv5 with conv5's pool removed leave 13 x 13 x 256 =
43,264 features an image (``CAPTION_GRU.n_input``).  They are flattened
in NHWC order, cast to f32 and fed to the GRU at every one of its T
steps (the reference's benchmark composition repeats them; here the
repeat is a broadcast view, so step t reads the same contiguous rows),
and the GRU's outputs are held to targets by MSE.  The convs run as in
``models/cnn.py`` (torch's convolution), the GRU's three words a step as
in ``models/rnn.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.paper_nets import ALEXNET, CAPTION_GRU, CNNConfig
from repro_torch.models import cnn, rnn

# AlexNet's conv stack with conv5's pool removed: 13 x 13 x 256 features
CAPTION_CNN = dataclasses.replace(
    ALEXNET, name="paper-captioning-cnn",
    convs=(*ALEXNET.convs[:4], dataclasses.replace(ALEXNET.convs[4],
                                                   pool=0)),
    fcs=(), n_classes=0)


def n_features(ccfg: CNNConfig) -> int:
    hw, ch = ccfg.in_hw, ccfg.in_ch
    for c in ccfg.convs:
        hw, ch = cnn.conv_out_hw(hw, c), c.out_ch
    return hw * hw * ch


def init(generator: torch.Generator, gcfg=CAPTION_GRU,
         ccfg: CNNConfig = CAPTION_CNN) -> dict:
    """{"cnn": {"convs": [...]}, "gru": {...}} in f32 on the generator's
    device."""
    if n_features(ccfg) != gcfg.n_input:
        raise ValueError(f"{ccfg.name} gives {n_features(ccfg)} features, "
                         f"{gcfg.name} takes {gcfg.n_input}")
    convs = cnn.init(generator, dataclasses.replace(ccfg, n_classes=1))
    return {"cnn": {"convs": convs["convs"]},
            "gru": rnn.gru_init(generator, gcfg)}


def features(ccfg: CNNConfig, params: dict, images: torch.Tensor, *,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (B, H, W, C) -> (B, n_features) f32, in NHWC order."""
    x = images.to(compute_dtype)
    for c, p in zip(ccfg.convs, params["convs"]):
        x = cnn._conv(x, c, p)
    return x.reshape(x.shape[0], -1).to(torch.float32)


def loss_fn(params: dict, batch: dict, *, gcfg=CAPTION_GRU,
            ccfg: CNNConfig = CAPTION_CNN,
            compute_dtype: torch.dtype = torch.bfloat16,
            backend: str = "reference",
            key: Optional[int] = None) -> torch.Tensor:
    """MSE of the GRU's outputs on batch {"images" (B, H, W, C), "y" (B,
    T, n_output)}."""
    feat = features(ccfg, params["cnn"], batch["images"],
                    compute_dtype=compute_dtype)
    x = feat[:, None].expand(-1, gcfg.T, -1)
    return rnn.gru_loss(gcfg, params["gru"], {"x": x, "y": batch["y"]},
                        backend=backend, key=key)
