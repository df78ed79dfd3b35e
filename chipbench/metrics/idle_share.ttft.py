"""Share of the traced window in which no device operation ran, as
``idle_share.tokens``, in the cells whose end-to-end metric is the time
to first token."""
from harness.layers import idle_share

UNIT, LAYER, MOVES = "%", "device", "ttft_p95_ms"


def read(run):
    return idle_share(run)
