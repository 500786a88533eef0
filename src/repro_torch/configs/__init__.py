"""Config registry: importing this package registers qwen2-0.5b,
rwkv6-1.6b, granite-moe-1b-a400m, olmo-1b, minitron-4b, jamba-v0.1-52b
and arctic-480b;
``PAPER_NETS`` holds the paper's own benchmark networks."""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      TrainConfig, get_config, get_reduced,
                                      list_configs, register)
from repro_torch.configs import arctic_480b  # noqa: F401  (registers)
from repro_torch.configs import granite_moe_1b  # noqa: F401  (registers)
from repro_torch.configs import jamba_52b  # noqa: F401  (registers)
from repro_torch.configs import minitron_4b  # noqa: F401  (registers)
from repro_torch.configs import olmo_1b  # noqa: F401  (registers)
from repro_torch.configs import qwen2_0p5b  # noqa: F401  (registers)
from repro_torch.configs import rwkv6_1p6b  # noqa: F401  (registers)
from repro_torch.configs.paper_nets import PAPER_NETS

__all__ = ["AttentionConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "TrainConfig", "get_config", "get_reduced",
           "list_configs", "register", "PAPER_NETS"]
