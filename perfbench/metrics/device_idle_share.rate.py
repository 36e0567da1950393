"""Share of the profiled window in which no kernel, copy or set runs on
a card, averaged over the cell's cards (%)."""

from perfbench.metrics import _idle


def read(ctx):
    return _idle.idle_pct(ctx)
