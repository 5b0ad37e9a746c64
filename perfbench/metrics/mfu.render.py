"""Model FLOPs of the traced LiDAR frames (the field and the LiDAR heads at
every ray of each marcher slab that ran; ``yardstick.slab_flops``) over
the window's wall time times the card's bf16 peak (989 TFLOP/s), in %."""

from perfbench import yardstick as ys


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "render_lidar" or w is None or not w.kernels:
        return None
    flops = run.work["slabs_run"] * ys.slab_flops(run.c)
    return 100.0 * flops / (w.wall_s * ys.BF16_FLOP_PER_S)
