"""scan_stats_s: the getsv statistics' seconds in the tumour's streamed
scan a pass (``seeksv.scan.stats``, each slab's ``StreamStats.process``,
inside ``seeksv.stage.scan_bam``); the mean over the window's passes,
nothing where the program recorded no such span."""
from sbench import program_spans


def read(ctx):
    return program_spans.scan_seconds(ctx, ("seeksv.scan.stats",))
