"""The whole analysis's share of the card's peak: 2 x the forward's
multiply-accumulates (from the site shapes) x the calls completed, over
the window, over 67 TFLOP/s, the H100's float32 rate outside the tensor
cores -- the precision the forward computes in (``nets._full_f32``
switches TF32 off)."""
from perfbench.harness import costs, peaks


def read(run):
    calls = run.counts.get("calls", 0)
    if not calls or run.window_s <= 0:
        return None
    flops = costs.cnn_flops(run.config, int(run.traffic["batch"])) * calls
    return 100.0 * flops / run.window_s / peaks.F32_FLOPS
