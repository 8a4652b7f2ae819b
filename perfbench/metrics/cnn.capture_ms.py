"""Median host time of the forward with operand capture
(``nets.forward_with_traces``) over the window's analysis calls: the
harness's span around it, the card synchronized at both ends."""
from perfbench.harness import stats


def read(run):
    v = stats.median(run.spans.get("cnn.capture", []))
    return None if v is None else v * 1e3
