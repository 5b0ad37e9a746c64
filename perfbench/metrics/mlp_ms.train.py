"""Device ms a training step in the field's MLP heads: self time of the
program's ``mlp`` spans (the sigma net, the LiDAR and camera color heads
with their direction encodings; forward, recomputation and backward),
outside the occupancy refresh (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.self_ms(run, ("mlp",))
