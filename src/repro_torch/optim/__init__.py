"""The port's optimizer: AdamW with global-norm clipping and a warmup +
cosine schedule."""
from .adamw import AdamW, AdamWState, global_norm, warmup_cosine

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine"]
