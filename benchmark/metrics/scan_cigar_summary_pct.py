"""scan_cigar_summary_pct: the share of the streamed decoder's slabs that
came with their records' CIGAR summary, which getclip and the scan's
statistics read instead of walking the CIGARs (the program's counters
``scan.slabs_summarised`` over ``scan.slabs``), over every scan of the
window's recorded passes (the pair's normal too); nothing where the
program recorded no ``scan.slabs_summarised`` (a program whose decoder
writes no summary)."""
from sbench import program_counts, program_spans

PART = "scan.slabs_summarised"


def read(ctx):
    ps = program_spans.load(ctx)
    if ps is None or not any(PART in counts
                             for _t0, counts, _spans in ps.records):
        return None
    return program_counts.share_pct(ctx, PART, "scan.slabs")
