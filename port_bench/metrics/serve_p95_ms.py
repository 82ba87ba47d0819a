"""serve_p95_ms: the 95th percentile of every answered serve request due
in the window, each timed from when it was due (open loop) to its
predictions on the host. Requests not answered count in ``failed``."""
import numpy as np


def read(run):
    if not run.serve_latency_ms:
        return None
    return float(np.percentile(run.serve_latency_ms, 95))
