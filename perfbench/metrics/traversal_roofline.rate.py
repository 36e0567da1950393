"""K1 + K2 (the wide closest-hit and occlusion walks, `wide_walk<false>`
and `wide_walk<true>` in csrc/wide_traverse.cu) against their memory
roofline, in %.

The least time is bytes over the card's peak bandwidth. The bytes count
what the estimator needs whatever implements the walk: each physical
ray it traced (the program's RayStats.physical: live wave lanes and one
shadow ray per triangle hit) read once (origin, direction, t range: 32
bytes) and its result written once (t, triangle, u, v: 16 bytes). Node
and triangle tables, tests and re-traces are not counted, because they
change with the tree and the table layout. The walk is bytes-bound under
this count: its arithmetic bound per ray is far below. The share is
against the published peak of an H100 SXM at 700 W."""

import re

from perfbench.peaks import HBM_BYTES_PER_S

KERNELS = re.compile(r"wide_walk(?:<|ILb)(true|false|1|0)")
BYTES_PER_RAY = 32 + 16


def read(ctx):
    ns = sum(dur for name, _, dur, _ in ctx["device_events"] if KERNELS.search(name))
    if not ns or not ctx["rays_physical"]:
        return None
    least_s = ctx["rays_physical"] * BYTES_PER_RAY / HBM_BYTES_PER_S
    return 100.0 * least_s / (ns / 1e9)
