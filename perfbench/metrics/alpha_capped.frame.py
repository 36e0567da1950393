"""Alpha loops a frame that ended at their pass cap (`max_alpha_skips`)
with hits still rejected: the program's `alpha_cap` ranges in the
profiled frames, over the frames; 0 where no loop reached its cap. A
loop cut there keeps a hit that the reference, which has no cap, would
pass: the reading tells how far the port departs from the reference,
and raising the cap to bring it to 0 costs frame time. Nothing to read
without a wave loop (`wave0`), or from a program that opens no pass
range (it opens no `alpha_cap` range either)."""

PASSES = ("alpha_retrace.pass", "occl_recheck.pass")


def read(ctx):
    ann = ctx["annotations"]
    if "wave0" not in ann or not any(n in ann for n in PASSES) or not ctx["frames"]:
        return None
    return ann.get("alpha_cap", {"count": 0})["count"] / ctx["frames"]
