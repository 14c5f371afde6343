"""peak_rss_mb: the process's peak resident memory over set-up and the
window (getrusage's ru_maxrss, read as the window closes), in MB of 1e6
bytes; the dataset's and the index's builds run in subprocesses and
never count."""


def read(ctx):
    return ctx["peak_rss_mb"]
