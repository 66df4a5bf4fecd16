"""K1's share of its roofline: the bound of every call of the traced window
(``harness/roofline.py``, from each call's own element counts) over the
device time of K1's kernels (``roofline/<config>.json`` names them) in the
trace, in percent."""

from harness import roofline


def read(ctx):
    if ctx.ops is None or ctx.cell.roofline is None:
        return None
    k1 = sum(e - s for name, _, s, e in ctx.ops if roofline.is_kernel(ctx.cell.roofline, name))
    if k1 <= 0.0:
        return None
    return 100.0 * roofline.bound_total_s(ctx) / k1
