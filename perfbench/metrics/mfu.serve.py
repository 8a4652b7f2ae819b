"""The whole serving step's share of the card's peak: 2 x the model's
matmul parameters (the layers' projections and the tied head) x the
tokens processed in the window (prompt rows prefilled at admission and
tokens generated), over the window, over 989 TFLOP/s (bfloat16, the
served precision)."""
from perfbench.harness import costs, peaks


def read(run):
    tokens = run.counts.get("prefill_tokens", 0) + run.counts.get("tokens",
                                                                   0)
    if not tokens or run.window_s <= 0:
        return None
    flops = 2.0 * costs.lm_matmul_params(run.config) * tokens
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
