"""scan_inflate_ready_pct: the share of the streamed decoder's compressed
windows whose inflate had finished before the record walk reached them
(the program's counters ``scan.windows_ready`` over ``scan.windows``),
over every scan of the window's recorded passes (the pair's normal
too); nothing where the program recorded no such counter."""
from sbench import program_counts


def read(ctx):
    return program_counts.share_pct(ctx, "scan.windows_ready",
                                    "scan.windows")
