"""request_p95_ms: the 95th percentile (linear between ranks) over all
requests of the window of the time from the call into run_search to its
return with the m8 written (host clock)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return 1e3 * float(np.percentile([c.t1 - c.t0 for c in run.calls], 95))
