"""Slabs the LiDAR marcher ran (``Renderer.slabs_run``, counted on the
device) over the slabs in the traced frames' chunks
(``yardstick.frame_slabs``), in %: lower is less marching past the
early exit."""

from perfbench import yardstick as ys


def read(run):
    if run.mix["entry"] != "render_lidar" or run.trace_data is None:
        return None
    k = run.work
    if not k.get("count"):
        return None
    Hl, Wl = run.scene["panos"].shape[1:3]
    return 100.0 * k["slabs_run"] / (k["count"] * ys.frame_slabs(run.c, Hl * Wl))
