"""Device ms a training step in the field's encoders: self time of the
program's ``encode.*`` spans (hash grids, K-planes, the flow field's hash
grid and MLP; forward, recomputation and backward, where B1, B3 and B4
run), outside the occupancy refresh (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.self_ms(run, ("encode",))
