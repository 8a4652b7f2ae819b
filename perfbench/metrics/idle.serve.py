"""Share of the profiled engine steps' wall time in which no operation
ran on the card (the union of the trace's device intervals)."""


def read(run):
    p = run.profiled
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
