"""getsv_s: the getsv stage a pass, the mean over the window's passes."""


def read(ctx):
    vals = [p["stages_s"]["getsv"] for p in ctx["passes"]
            if "getsv" in p["stages_s"]]
    return sum(vals) / len(vals) if vals else None
