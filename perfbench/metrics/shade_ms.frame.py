"""Host ms a frame under the wave loop's shading block (the ranges of
_shade.RANGES) in the profiled frames."""

from perfbench.metrics import _shade


def read(ctx):
    ms = _shade.host_ms(ctx)
    return None if ms is None or not ctx["frames"] else ms / ctx["frames"]
