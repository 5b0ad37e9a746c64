"""Model FLOPs of the traced refine steps (the U-Net's forward on the
batch, x3 with the backward; ``unet_counts.step_flops``) over the window's
wall time times the card's TF32 peak (494.7 TFLOP/s), in %: the share of
the whole step's peak."""

from perfbench import unet_counts as uc


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "refine" or w is None or not w.kernels:
        return None
    B, _, H, W = run.out["refine"]["x"].shape
    flops = run.work["count"] * uc.step_flops(run.cfg_file["unet"], B, H, W)
    return 100.0 * flops / (w.wall_s * uc.TF32_FLOP_PER_S)
