"""Fault tolerance and straggler timing of the trainer (:mod:`.fault`)."""
from . import fault  # noqa: F401
