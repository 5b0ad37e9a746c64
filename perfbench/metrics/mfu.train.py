"""Model FLOPs of the traced training calls (their steps, forward and
backward, and their occupancy refreshes; ``yardstick.step_flops``,
``refresh_flops``) over the window's wall time times the card's bf16 peak
(989 TFLOP/s), in %."""

from perfbench import yardstick as ys


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "train" or w is None or not w.kernels:
        return None
    c, k = run.c, run.work
    flops = k["count"] * ys.step_flops(c, k["flow_points"]) \
        + k["refreshes"] * ys.refresh_flops(c)
    return 100.0 * flops / (w.wall_s * ys.BF16_FLOP_PER_S)
