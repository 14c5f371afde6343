"""scan_decode_mb_per_s: the decode thread's rate, compressed BAM
megabytes (1e6 bytes) decoded a second of ``seeksv.scan.decode``, over
every scan of a pass (the pair's normal too; the program's counter
``scan.bam_bytes``), the mean over the window's passes; nothing where
the program recorded no such counter or span."""
from sbench import program_spans


def read(ctx):
    return program_spans.decode_mb_per_s(ctx)
