"""Shared by shade_ms.*: host milliseconds under the wave loop's shading
block, summed over its disjoint ranges. A program that runs the block
as PyTorch ops opens `shade_attrs`, `textures`, `nee_sample`, `bounce`,
`mis_weights`, `shadow_spheres` and `shadow_payload`; one that runs it
as two kernels opens `shade_sample` and `shade_mis`. The shadow trace
between them (`trace_shadow`, the alpha recheck) is not counted."""

RANGES = ("shade_attrs", "textures", "nee_sample", "bounce", "mis_weights", "shadow_spheres",
          "shadow_payload", "shade_sample", "shade_mis")


def host_ms(ctx):
    ann = ctx["annotations"]
    if "wave0" not in ann:  # the trace saw no wave loop: nothing to read
        return None
    return sum(ann[name]["host_ms"] for name in RANGES if name in ann)
