"""getsv_window_records_per_s: the records that getsv's discordant-pair
windows cover a second of its window loop: the program's counter
``getsv.window_records`` (the records each junction's window overlaps,
summed over the junctions of a pass) over the seconds of the pass's
``seeksv.getsv.windows`` spans (the loop over the junctions, without the
counter's construction over every record), the mean over the window's
recorded passes; nothing where the program recorded no such counter or
no such span."""
from sbench import program_spans

COUNTER = "getsv.window_records"
SPAN = "seeksv.getsv.windows"


def read(ctx):
    ps = program_spans.load(ctx)
    if ps is None:
        return None
    per = ps.per_pass()
    vals = []
    for t0, counts, _spans in ps.records:
        i = ps.pass_of(t0)
        if i is None or COUNTER not in counts:
            continue
        sec = sum(s[2] - s[1] for s in per[i]["main"] if s[0] == SPAN)
        if sec > 0:
            vals.append(counts[COUNTER] / sec)
    return sum(vals) / len(vals) if vals else None
