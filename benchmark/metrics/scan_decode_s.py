"""scan_decode_s: the decode thread's seconds in the tumour's streamed
scan a pass (``seeksv.scan.decode`` under ``seeksv.stage.scan_bam``: the
native BGZF inflate and parse of each slab, mapped from the program's
trace record onto the trace's clock), the mean over the window's passes;
nothing where the program recorded no such span."""
from sbench import program_spans


def read(ctx):
    return program_spans.decode_seconds(ctx)
