"""Block-paged KV serving: the page pool, the prefix trie, the class
scheduler and the engine over them. ``ServeEngine(params, cfg,
ServeConfig(paging=PagingConfig(...)))`` builds a
:class:`PagedServeEngine`."""
from .cache import TRASH, PagedKVCache                        # noqa: F401
from .config import PagingConfig, SchedClass                  # noqa: F401
from .engine import PagedServeEngine                          # noqa: F401
from .prefix import PrefixCache                               # noqa: F401
from .scheduler import ClassScheduler                         # noqa: F401

__all__ = ["ClassScheduler", "PagedKVCache", "PagedServeEngine",
           "PagingConfig", "PrefixCache", "SchedClass", "TRASH"]
