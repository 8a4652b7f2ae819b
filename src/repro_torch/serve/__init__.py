"""repro_torch.serve -- continuous-batching LM serving with per-request
power accounting (the slot and paged engines of the JAX package's
``repro.serve``).

    from repro_torch.serve import ServeConfig, ServeEngine

    engine = ServeEngine(params, cfg, ServeConfig(max_slots=4,
                                                  cache_len=256,
                                                  power_monitor=True))
    engine.submit([1, 2, 3], max_new_tokens=32)
    finished = engine.run()
    print(finished[0].power.summary())

Set ``ServeConfig(paging=PagingConfig(...))`` and the same constructor
returns a :class:`PagedServeEngine`: one pool of KV pages behind per-row
page tables, chunked prefill, shared prompt prefixes and a preempting
class scheduler, with power reports that still sum to the serve-wide
trace.

Run ``python -m repro_torch.serve --help`` for the serving driver.
"""
from .cache import SlotCache                                  # noqa: F401
from .engine import ServeConfig, ServeEngine                  # noqa: F401
from .paging import (TRASH, ClassScheduler,                   # noqa: F401
                     PagedKVCache, PagedServeEngine, PagingConfig,
                     PrefixCache, SchedClass)
from .power import PowerAccountant, RequestPowerReport        # noqa: F401
from .request import Request, RequestStatus                   # noqa: F401
from .sampling import GREEDY, SamplingParams, sample_tokens   # noqa: F401
from .scheduler import FIFOScheduler                          # noqa: F401
