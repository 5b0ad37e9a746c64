"""The hand-written kernels' share of their roofline in the traced
training calls: the sum of the least times of their calls (bytes over
3.35 TB/s or operations over 67 TFLOP/s f32, whichever is larger;
``yardstick.step_calls``, ``refresh_calls``) over the device time of the
kernels named ``segment_add_rows_kernel``,
``segment_add_transpose_kernel``, ``multihot_fwd_kernel`` and
``multihot_bwd_kernel``, in %."""

from perfbench import yardstick as ys

NAMES = sum(ys.KERNEL_NAMES.values(), ())


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "train" or w is None:
        return None
    dev = w.kernel_time_s(NAMES)
    if dev <= 0:
        return None
    c, k = run.c, run.work
    bound = k["count"] * ys.bound_of(ys.step_calls(c, k["flow_points"])) \
        + k["refreshes"] * ys.bound_of(ys.refresh_calls(c))
    return 100.0 * bound / dev
