"""query_p95_ms.service: 95th percentile of submit-to-result latency over
the queries returned inside the traced window (the harness's clock)."""

import numpy as np


def read(r):
    lat = [(c.t_done - c.t_submit) * 1e3 for c in r.completed]
    return float(np.percentile(lat, 95)) if lat else None
