"""Shares of the program's own counters (``seeksv_tpu_torch/utils/
trace.py``'s ``count``) in the traced window: the counts of every pass
the program recorded inside a ``bench.pass``, read from the trace that
``sbench/program_spans.py`` parses.  A program without the counters
leaves nothing here to read."""
from __future__ import annotations

from sbench import program_spans


def share_pct(ctx: dict, part: str, whole: str):
    """100 x the counter ``part`` over the counter ``whole``, each summed
    over the window's recorded passes; None where no pass recorded
    ``whole`` or it sums to 0."""
    ps = program_spans.load(ctx)
    if ps is None:
        return None
    num = den = 0
    for t0, counts, _spans in ps.records:
        if ps.pass_of(t0) is not None and whole in counts:
            num += counts.get(part, 0)
            den += counts[whole]
    return 100.0 * num / den if den else None
