from . import analysis, nets  # noqa: F401
