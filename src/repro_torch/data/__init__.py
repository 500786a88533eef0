"""Deterministic synthetic data (the reference's numpy pipeline)."""
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM

__all__ = ["PipelineConfig", "SyntheticLM"]
