"""The whole fit step's share of the devices' peak: K5's bound of every
step of the traced window over the window's seconds times the devices, in
percent. It bounds what K5's roofline share can claim."""

import os

from harness import roofline, spec


def read(ctx):
    path = os.path.join(spec.BENCH_DIR, "roofline", ctx.cell.config_name + ".k5.json")
    if ctx.ops is None or not ctx.calls or not os.path.exists(path):
        return None
    return roofline.share_of_peak(ctx, roofline.k5_bound_total_s(ctx, spec.load_json(path)))
