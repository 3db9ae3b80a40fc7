"""device_idle_pct: 100 x (1 - the union of device kernel and copy
intervals over the traced window), from the profiler around the window's
first calls."""


def read(run):
    t = run.trace
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
