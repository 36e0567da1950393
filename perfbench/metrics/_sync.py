"""Shared by host_syncs.* and sync_wait_ms.*: the program's `sync.<site>`
ranges in the profiled window, one around each point where the host
waits for the device (tpurt_torch/utils/profiling.host_sync). Sync
ranges are leaves, so their host milliseconds add up without overlap."""

PREFIX = "sync."


def totals(ctx):
    """(ranges, host ms) summed over every `sync.*` name, or None when the
    trace saw no wave loop or the program opens no sync range."""
    ann = ctx["annotations"]
    if "wave0" not in ann:  # the trace saw no wave loop: nothing to read
        return None
    sites = [v for name, v in ann.items() if name.startswith(PREFIX)]
    if not sites:
        return None
    return sum(v["count"] for v in sites), sum(v["host_ms"] for v in sites)
