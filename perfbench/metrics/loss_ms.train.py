"""Device ms a training step in the losses: self time of the program's
``loss`` spans (forward and backward; the flow loss's flow-field query is
``encode.flow``'s) (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    return spans.self_ms(run, ("loss",))
