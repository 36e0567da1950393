"""Host ms a frame under the program's alpha loops (`alpha_retrace` +
`occl_recheck` ranges) in the profiled frames."""

from perfbench.metrics import _alpha


def read(ctx):
    ms = _alpha.host_ms(ctx)
    return None if ms is None or not ctx["frames"] else ms / ctx["frames"]
