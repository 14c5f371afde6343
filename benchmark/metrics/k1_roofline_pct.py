"""k1_roofline_pct: the extension kernel K1 (ops/extend.py ->
csrc/extend.cu, kernel extend_kernel) in the traced window's first pass:
the sum of its calls' bounds (sbench/bounds.py, counted on their own
jobs, the rows from the plain count) over their device time by kernel
name.  Nothing where that pass made no call or the trace shows no K1
time."""
from sbench import bounds


def read(ctx):
    tr, calls = ctx["trace"], ctx["calls"]
    if tr is None or not calls or not calls["extend"] or not tr.passes():
        return None
    _n, t0, t1 = tr.passes()[0]
    dev_s = tr.device_s("extend_kernel", t0, t1)
    if dev_s <= 0:
        return None
    bound = sum(bounds.extend_bound_s(a, ctx["kind"])
                for a in calls["extend"])
    return 100.0 * bound / dev_s
