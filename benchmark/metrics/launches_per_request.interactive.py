"""launches_per_request.interactive: CUDA kernels the profiler saw per
traced request of a closed loop."""


def read(run):
    t = run.trace
    if not t or not t["calls"]:
        return None
    return t["launches"] / t["calls"]
