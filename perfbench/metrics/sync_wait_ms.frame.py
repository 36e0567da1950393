"""Host ms a frame spent waiting for the device: the host time under
the `sync.*` ranges of the profiled frames over the frames."""

from perfbench.metrics import _sync


def read(ctx):
    t = _sync.totals(ctx)
    return None if t is None or not ctx["frames"] else t[1] / ctx["frames"]
