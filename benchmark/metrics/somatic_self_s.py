"""somatic_self_s: the somatic stage a pass less the normal's scan
nested in it (``seeksv.stage.somatic`` less ``seeksv.somatic.scan``):
``somatic`` and ``somatic_filter`` alone; the mean over the window's
passes, nothing where no pass recorded the stage."""
from sbench import program_spans


def read(ctx):
    return program_spans.somatic_self_seconds(ctx)
