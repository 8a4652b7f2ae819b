"""95th percentile of every gap between consecutive output tokens of
every request, both tokens in the window (a token's time is the end of
the engine step that returned it; the first two tokens of a request come
from one step, a gap of 0). In a closed loop at capacity this tail is
set by the few steps that also admit requests: too few a window to hold
as an end-to-end metric, so it stands here beside ``tokens_per_s``."""
from perfbench.harness import stats


def read(run):
    v = stats.percentile(run.spans.get("token_gaps", []), 95)
    return None if v is None else v * 1e3
