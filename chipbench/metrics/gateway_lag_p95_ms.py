"""95th percentile of each arrival's delivery to the planner against its
due time (``serving.gateway``'s wall-clock drive loop), over the arrivals
due in the window; the harness stamps each delivery."""
from harness.stats import percentile

UNIT, LAYER, MOVES = "ms", "serving.gateway", "ttft_p95_ms"


def read(run):
    if not run.lags:
        return None
    return 1e3 * percentile(run.lags, 0.95)
