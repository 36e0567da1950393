"""Device operations (kernels, copies and sets) a frame in the profiled
frames, the frame's tonemap and copy to the host included."""


def read(ctx):
    n = len(ctx["device_events"])
    return n / ctx["frames"] if n and ctx["frames"] else None
