"""The whole call's share of the devices' peak: the K1 bound of every call
of the traced window over the window's seconds times the devices, in
percent. It bounds what any one kernel's roofline share can claim."""

from harness import roofline


def read(ctx):
    if ctx.ops is None or ctx.cell.roofline is None or not ctx.calls:
        return None
    return roofline.share_of_peak(ctx, roofline.bound_total_s(ctx))
