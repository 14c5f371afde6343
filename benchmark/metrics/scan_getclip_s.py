"""scan_getclip_s: getclip's seconds in the tumour's streamed scan a
pass (``seeksv.scan.getclip``, each slab's ``GetclipStream.process``,
plus ``seeksv.scan.flush``, its close, inside ``seeksv.stage.scan_bam``);
the mean over the window's passes, nothing where the program recorded
no such span."""
from sbench import program_spans


def read(ctx):
    return program_spans.scan_seconds(
        ctx, ("seeksv.scan.getclip", "seeksv.scan.flush"))
