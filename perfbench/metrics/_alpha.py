"""Shared by alpha_loop_ms.*: host milliseconds under the program's two
alpha loops, `alpha_retrace` (the closest-hit re-trace of alpha-rejected
hits) and `occl_recheck` (the shadow rays' recheck and re-trace)."""

LOOPS = ("alpha_retrace", "occl_recheck")


def host_ms(ctx):
    ann = ctx["annotations"]
    if "wave0" not in ann:  # the trace saw no wave loop: nothing to read
        return None
    return sum(ann[name]["host_ms"] for name in LOOPS if name in ann)
