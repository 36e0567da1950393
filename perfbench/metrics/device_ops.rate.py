"""Device operations (kernels, copies and sets, as the profiler records
them on every card) a sample in the profiled launches."""


def read(ctx):
    n = len(ctx["device_events"])
    return n / ctx["samples"] if n and ctx["samples"] else None
