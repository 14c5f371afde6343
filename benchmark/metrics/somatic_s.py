"""somatic_s: the somatic stage a pass (the normal's decode and getclip,
somatic, its filter), the mean over the window's passes; nothing where
no pass ran one."""


def read(ctx):
    vals = [p["stages_s"]["somatic"] for p in ctx["passes"]
            if "somatic" in p["stages_s"]]
    return sum(vals) / len(vals) if vals else None
