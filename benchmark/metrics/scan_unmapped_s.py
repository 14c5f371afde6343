"""scan_unmapped_s: the seconds of getclip's pairing of unmapped mates
in the tumour's streamed scan a pass (``seeksv.scan.unmapped``, inside
each slab's ``seeksv.scan.getclip``, inside ``seeksv.stage.scan_bam``);
the mean over the window's passes, nothing where the program recorded
no such span (a program that does not open it)."""
from sbench import program_spans

SPAN = "seeksv.scan.unmapped"


def read(ctx):
    ps = program_spans.load(ctx)
    if ps is None or not any(s[0] == SPAN for s in ps.main):
        return None
    return program_spans.scan_seconds(ctx, (SPAN,))
