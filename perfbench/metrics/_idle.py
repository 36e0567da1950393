"""Shared by device_idle_share.*: the share of the profiled window in
which no kernel, copy or set runs on a card (the union of its event
intervals), averaged over the cell's cards, in %."""


def idle_pct(ctx):
    if not ctx["on_card"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
