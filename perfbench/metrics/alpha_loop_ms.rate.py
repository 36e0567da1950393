"""Host ms a sample under the program's alpha loops (`alpha_retrace` +
`occl_recheck` ranges) in the profiled launches. 0 in a scene without
alpha-tested geometry, whose wave loop skips both loops."""

from perfbench.metrics import _alpha


def read(ctx):
    ms = _alpha.host_ms(ctx)
    return None if ms is None or not ctx["samples"] else ms / ctx["samples"]
