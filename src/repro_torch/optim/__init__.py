"""The optimiser of the training path (:mod:`.adamw`)."""
from .adamw import AdamW, AdamWState, cosine_schedule, global_norm  # noqa: F401
