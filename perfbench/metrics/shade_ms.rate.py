"""Host ms a sample under the wave loop's shading block (the ranges of
_shade.RANGES) in the profiled launches."""

from perfbench.metrics import _shade


def read(ctx):
    ms = _shade.host_ms(ctx)
    return None if ms is None or not ctx["samples"] else ms / ctx["samples"]
