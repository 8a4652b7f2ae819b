"""The paper's stream model in PyTorch: bus words, activity, BIC, ZVG,
the SA coding menu and the calibrated energy model. Exports the same
names as the JAX package's ``core``."""
from . import (activity, bic, bits, monitor, power, precision,  # noqa: F401
               systolic, zvg)
from .bic import bic_decode, bic_encode, bic_transitions  # noqa: F401
from .monitor import MonitorConfig, monitor_matmul  # noqa: F401
from .power import DEFAULT_ENERGY, EnergyModel, sa_power  # noqa: F401
from .systolic import (  # noqa: F401
    MXU_SA, PAPER_SA, SAGeometry, sa_stream_report,
    streaming_activity_reduction,
)
from .zvg import zero_fraction, zvg_stream_report  # noqa: F401
