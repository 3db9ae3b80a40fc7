"""device_idle_pct.interactive: as device_idle_pct, over the traced
requests of a closed loop."""


def read(run):
    t = run.trace
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
