"""The paper's own benchmark networks (§5.1, Fig 13-16): the networks
NeuroTrainer itself is evaluated on, beside the assigned LM configs.

- paper-alexnet      : AlexNet (Fig 13 per-layer analysis)
- paper-vgg16        : VGG-16 (Fig 17 scaling study)
- paper-gru          : stand-alone GRU (Fig 16)
- paper-mlp0         : the TPU paper's 5-layer MLP (Fig 16)
- paper-captioning   : AlexNet-conv5 features -> GRU (Fig 14/15)

The same values as the reference's ``repro/configs/paper_nets.py``; the
port keeps its own copy.  The models are ``models/cnn.py`` and
``models/rnn.py``; ``runtime/paper_step.py`` trains them.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: int
    stride: int = 1
    pad: str = "SAME"
    pool: int = 0          # max-pool window after the conv (0 = none)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    in_hw: int
    in_ch: int
    convs: tuple
    fcs: tuple             # hidden FC widths
    n_classes: int


ALEXNET = CNNConfig(
    name="paper-alexnet",
    in_hw=227, in_ch=3,
    convs=(
        ConvSpec(96, 11, stride=4, pad="VALID", pool=2),
        ConvSpec(256, 5, pool=2),
        ConvSpec(384, 3),
        ConvSpec(384, 3),
        ConvSpec(256, 3, pool=2),
    ),
    fcs=(4096, 4096),
    n_classes=1000,
)

VGG16 = CNNConfig(
    name="paper-vgg16",
    in_hw=224, in_ch=3,
    convs=(
        ConvSpec(64, 3), ConvSpec(64, 3, pool=2),
        ConvSpec(128, 3), ConvSpec(128, 3, pool=2),
        ConvSpec(256, 3), ConvSpec(256, 3), ConvSpec(256, 3, pool=2),
        ConvSpec(512, 3), ConvSpec(512, 3), ConvSpec(512, 3, pool=2),
        ConvSpec(512, 3), ConvSpec(512, 3), ConvSpec(512, 3, pool=2),
    ),
    fcs=(4096, 4096),
    n_classes=1000,
)


@dataclass(frozen=True)
class GRUConfig:
    name: str
    n_input: int
    n_hidden: int
    n_output: int
    T: int                 # unrolled time steps


# §5.1: the captioning GRU: 43,264 inputs (AlexNet's conv5 features,
# 13 x 13 x 256, before its pool), 10,000 hidden, T=100.
CAPTION_GRU = GRUConfig("paper-captioning-gru", n_input=43264,
                        n_hidden=10000, n_output=10000, T=100)
# Fig 16's stand-alone GRU benchmark.
GRU0 = GRUConfig("paper-gru", n_input=2048, n_hidden=2048, n_output=2048,
                 T=64)


@dataclass(frozen=True)
class MLPConfig:
    name: str
    widths: tuple


# MLP0 from the TPU paper: 5 FC layers, 2560 wide.
MLP0 = MLPConfig("paper-mlp0", widths=(2560, 2560, 2560, 2560, 2560))

PAPER_NETS = {c.name: c for c in (ALEXNET, VGG16, CAPTION_GRU, GRU0, MLP0)}
