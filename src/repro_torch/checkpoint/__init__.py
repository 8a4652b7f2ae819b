"""Atomic, asynchronous checkpoints of tensor trees (:mod:`.ckpt`)."""
from .ckpt import Checkpointer  # noqa: F401
