"""request_p95_ms: the 95th percentile of every request's wall in the
window, from the call into the index's search to its answers on the host;
a failed request counts as its wall."""

import numpy as np


def read(r):
    return float(np.percentile(np.asarray(r.walls) * 1e3, 95)) if r.kind == "search" else None
