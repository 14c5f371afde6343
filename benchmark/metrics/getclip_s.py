"""getclip_s: decode + getclip a pass (the whole-BAM driver's read_bam
and getclip stages, or the streaming driver's scan_bam), the mean over
the window's passes."""


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        s = p["stages_s"]
        if "scan_bam" in s:
            vals.append(s["scan_bam"])
        elif "read_bam" in s:
            vals.append(s["read_bam"] + s["getclip"])
    return sum(vals) / len(vals) if vals else None
