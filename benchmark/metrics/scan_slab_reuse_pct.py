"""scan_slab_reuse_pct: the share of the streamed decoder's slabs whose
columns went into a buffer set that an earlier slab had handed back
(the program's counters ``scan.slabs_recycled`` over ``scan.slabs``),
over every scan of the window's recorded passes (the pair's normal
too); nothing where the program recorded no such counter."""
from sbench import program_counts


def read(ctx):
    return program_counts.share_pct(ctx, "scan.slabs_recycled",
                                    "scan.slabs")
