"""Host ms a sample spent waiting for the device: the host time under
the `sync.*` ranges of the profiled launches over the samples they
delivered."""

from perfbench.metrics import _sync


def read(ctx):
    t = _sync.totals(ctx)
    return None if t is None or not ctx["samples"] else t[1] / ctx["samples"]
