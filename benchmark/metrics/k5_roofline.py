"""K5's share of its roofline: each step's least time, one forward (K5f)
and one forward plus adjoint (K5b) of its rays at the card's float32 peak
(``roofline/<config>.k5.json``, ``roofline/peaks.json``), summed over the
traced window's steps, over the device time of K5's kernels, in percent."""

import os

from harness import roofline, spec


def read(ctx):
    path = os.path.join(spec.BENCH_DIR, "roofline", ctx.cell.config_name + ".k5.json")
    if ctx.ops is None or not os.path.exists(path):
        return None
    census = spec.load_json(path)
    k5 = sum(e - s for name, _, s, e in ctx.ops if roofline.is_kernel(census, name))
    if k5 <= 0.0:
        return None
    return 100.0 * roofline.k5_bound_total_s(ctx, census) / k5
