"""The K-plane lookup kernel's share of its roofline in the traced LiDAR
frames: the least times of its calls in the marcher's slabs that ran
(``yardstick.slab_calls``, counted by the renderer's on-device slab
counter) over the device time of the kernels named
``multihot_fwd_kernel``, in %."""

from perfbench import yardstick as ys


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "render_lidar" or w is None:
        return None
    dev = w.kernel_time_s(ys.KERNEL_NAMES["multihot_fwd"])
    if dev <= 0:
        return None
    bound = run.work["slabs_run"] * ys.bound_of(ys.slab_calls(run.c))
    return 100.0 * bound / dev
