"""Device ms a training step in the optimizer: self time of the program's
``optim`` spans (gradients zeroed, NaN gradients zeroed, Adam, the
error-map rows, and the EMA update once a call) (``perfbench/spans.py``).
"""

from perfbench import spans


def read(run):
    return spans.self_ms(run, ("optim",))
