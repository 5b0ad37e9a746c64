"""Device ms a refine step in the optimizer: self time of the program's
``optim`` spans (the gradients zeroed, Adam) (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    if run.mix["entry"] != "refine":
        return None
    return spans.self_ms(run, ("optim",))
