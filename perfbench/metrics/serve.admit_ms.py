"""Median, over the window's steps that admitted requests, of the step's
host time per request admitted (each admission is a batch-1 prefill, its
prompt accounting and its first token)."""
from perfbench.harness import stats


def read(run):
    v = stats.median(run.spans.get("step_admit_per_request", []))
    return None if v is None else v * 1e3
