"""Device ms a training step in the occupancy refresh: all device time
inside the program's ``refresh`` spans, its field queries included, over
the window's steps (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.inclusive_ms(run, "refresh")
