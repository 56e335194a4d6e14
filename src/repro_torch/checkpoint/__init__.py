"""Atomic checkpoints of the port's trees, in the JAX package's format."""
from .checkpoint import all_steps, latest_step, restore, save

__all__ = ["all_steps", "latest_step", "restore", "save"]
