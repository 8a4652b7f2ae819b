"""Median host time of pricing every site for the design menu
(``analysis.analyze_trace``: the counter pass K1, the lane sums to the
host, the float32 pricing) with the selection and the summary: the
harness's span around them, the card synchronized at both ends."""
from perfbench.harness import stats


def read(run):
    v = stats.median(run.spans.get("cnn.count_price", []))
    return None if v is None else v * 1e3
