"""repro_torch.serve -- continuous-batching LM serving with per-request
power accounting (the slot engine of the JAX package's ``repro.serve``).

    from repro_torch.serve import ServeConfig, ServeEngine

    engine = ServeEngine(params, cfg, ServeConfig(max_slots=4,
                                                  cache_len=256,
                                                  power_monitor=True))
    engine.submit([1, 2, 3], max_new_tokens=32)
    finished = engine.run()
    print(finished[0].power.summary())

Run ``python -m repro_torch.serve --help`` for the serving driver.
"""
from .cache import SlotCache                                  # noqa: F401
from .engine import ServeConfig, ServeEngine                  # noqa: F401
from .power import PowerAccountant, RequestPowerReport        # noqa: F401
from .request import Request, RequestStatus                   # noqa: F401
from .sampling import GREEDY, SamplingParams, sample_tokens   # noqa: F401
from .scheduler import FIFOScheduler                          # noqa: F401
