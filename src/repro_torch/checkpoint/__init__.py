"""Checkpoints of the training state, and carrying parameters and
training states across from the reference package."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
