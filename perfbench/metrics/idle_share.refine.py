"""Share of the traced refine window in which no device operation ran
(1 - union of the device intervals / the window's wall time). Source:
the device trace of ``trace.Window``."""


def read(run):
    w = run.trace_data
    if run.mix["entry"] != "refine" or w is None or not w.kernels:
        return None
    return 100.0 * (1.0 - w.busy_s / w.wall_s)
