"""records_per_s: BAM records consumed by the window's whole passes (a
pair: tumour and normal) over the window's elapsed seconds."""


def read(ctx):
    return sum(p["records"] for p in ctx["passes"]) / ctx["window_s"]
