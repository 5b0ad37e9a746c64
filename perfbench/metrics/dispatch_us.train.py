"""Host us a training step spent dispatching it: the program's host
ranges ``nvsf/step.dispatch`` (the step's replay and its host work around
it) and ``nvsf/epoch.sums`` (adding up its metrics), on the device trace's
clock, less the CUDA runtime calls inside them, where the host waits on
the device: a launch blocked on a full queue is not dispatch work
(``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.host_us(run, ("nvsf/step.dispatch", "nvsf/epoch.sums"))
