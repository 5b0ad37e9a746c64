"""The U-Net's convolutions' share of their roofline in the traced refine
steps: the sum of the least times of a step's convolution calls (each
call's bytes over 3.35 TB/s or its FLOPs over the TF32 peak of 494.7
TFLOP/s, whichever is larger; ``unet_counts.conv_calls``) times the steps,
over the device time of cuDNN's convolution kernels, in %. The kernels
are those whose names hold ``fprop`` (the forward), ``dgrad`` (the input's
gradient) or ``wgrad`` (the weight's gradient), in any case: on the H100
cuDNN names them ``sm90_xmma_fprop_implicit_gemm_...``,
``sm90_xmma_dgrad_implicit_gemm_...``, ``sm90_xmma_wgrad_implicit_gemm_...``
(and the ``cutlass`` and ``xmma`` kernels of its other engines the same
way)."""

from perfbench import unet_counts as uc

NAMES = ("fprop", "dgrad", "wgrad")


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "refine" or w is None:
        return None
    dev = sum(d for n, _, d in w.kernels
              if any(k in n.lower() for k in NAMES)) / 1e6
    if dev <= 0:
        return None
    B, _, H, W = run.out["refine"]["x"].shape
    bound = run.work["count"] * uc.conv_bound_s(run.cfg_file["unet"], B, H,
                                                W)
    return 100.0 * bound / dev
