"""k1_roofline_pct: K1's least time over its measured device time, in
%, over the traced calls.  The least time of a launch is the larger of
its operations (11 per cell of the band its rows really need, see
harness/trace.py:k1_cells) over the card's integer peak and its bytes
(each input and output byte once) over the memory bandwidth
(harness/peaks.json); the device time is the profiler's for kernels
named sw_band_score_kernel."""


def read(run):
    t = run.trace
    if not t or not t["k1_s"] or t["k1_least_s"] is None:
        return None
    return 100.0 * t["k1_least_s"] / t["k1_s"]
