"""Device ms a training step in ray sampling and rendering: self time of
the program's ``sample`` span (ray indices, rays, ground-truth gathers,
render draws) and ``render`` spans (candidates, compaction, compositing,
forward and backward; the field's calls inside are their own spans),
outside the occupancy refresh (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.self_ms(run, ("sample", "render"))
