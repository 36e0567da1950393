"""Alpha re-trace passes a frame: the program's `alpha_retrace.pass` and
`occl_recheck.pass` ranges (one around each pass of the closest-hit and
the shadow rays' alpha loop) in the profiled frames, over the frames.
Nothing to read without a wave loop (`wave0`), or from a program that
opens no pass range."""

PASSES = ("alpha_retrace.pass", "occl_recheck.pass")


def read(ctx):
    ann = ctx["annotations"]
    if "wave0" not in ann or not any(n in ann for n in PASSES) or not ctx["frames"]:
        return None
    return sum(ann[n]["count"] for n in PASSES if n in ann) / ctx["frames"]
