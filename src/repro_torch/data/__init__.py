"""The training data pipeline (:mod:`.pipeline`)."""
from .pipeline import DataConfig, SyntheticLM, TokenFileSource, make_source  # noqa: F401
