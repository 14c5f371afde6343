"""scan_wait_s: the seconds the consumers of the tumour's streamed scan
wait for the next slab a pass (``seeksv.scan.wait`` inside
``seeksv.stage.scan_bam``): the decode that the consumers do not hide;
the mean over the window's passes, nothing where the program recorded
no such span."""
from sbench import program_spans


def read(ctx):
    return program_spans.scan_seconds(ctx, ("seeksv.scan.wait",))
