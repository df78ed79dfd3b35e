"""Share of the traced window in which no device operation ran (the
union of the profiler's device intervals)."""
from harness.layers import idle_share

UNIT, LAYER, MOVES = "%", "device", "tokens_per_s"


def read(run):
    return idle_share(run)
