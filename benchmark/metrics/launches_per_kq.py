"""launches_per_kq: CUDA kernels the profiler saw per 1,000 queries of the
traced calls."""


def read(run):
    t = run.trace
    if not t or not t["queries"]:
        return None
    return 1e3 * t["launches"] / t["queries"]
