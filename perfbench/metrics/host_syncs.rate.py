"""Points a sample at which the host waited for the device: `sync.*`
ranges in the profiled launches over the samples they delivered."""

from perfbench.metrics import _sync


def read(ctx):
    t = _sync.totals(ctx)
    return None if t is None or not ctx["samples"] else t[0] / ctx["samples"]
