"""queries_per_s: queries (a read once, not per frame) in the whole calls
of the window over the time from the window's start to the end of its
last call (host clock)."""


def read(run):
    if not run.calls:
        return None
    return sum(c.n for c in run.calls) / run.window_s
