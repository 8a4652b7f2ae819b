"""Median host time of the window's ``engine.step()`` calls that admitted
no request: one shared decode step with the accountant's sampled work
and the retirements (each step ends by copying its tokens to the host)."""
from perfbench.harness import stats


def read(run):
    v = stats.median(run.spans.get("step_no_admit", []))
    return None if v is None else v * 1e3
