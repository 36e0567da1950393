"""Points a frame at which the host waited for the device: `sync.*`
ranges in the profiled frames (camera set, launch, tonemap and the
8-bit frame's copy to the host) over the frames."""

from perfbench.metrics import _sync


def read(ctx):
    t = _sync.totals(ctx)
    return None if t is None or not ctx["frames"] else t[0] / ctx["frames"]
