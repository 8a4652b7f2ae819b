"""95th percentile, over every request sent in the window, of its first
token's time minus its send time. Where a cell's window holds too few
requests for this tail to repeat within an end-to-end bound (the paged
cell's runs spread 41-44%), it stands here beside ``tokens_per_s``."""
from perfbench.harness import stats


def read(run):
    v = stats.percentile(run.spans.get("ttft", []), 95)
    return None if v is None else v * 1e3
