"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card (the profiler's device events); nothing
where the trace holds no device activity."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s())
