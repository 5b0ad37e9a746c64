"""Device ms a refine step in the U-Net: self time of the program's
``unet.*`` spans (``unet.down``: the in-conv and the four downs;
``unet.attn``; ``unet.up``: the four ups and the out-conv; each forward
and backward) (``perfbench/spans.py``)."""

from perfbench import spans


def read(run):
    if run.mix["entry"] != "refine":
        return None
    return spans.self_ms(run, ("unet",))
