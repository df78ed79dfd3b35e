"""The whole step's share of the chip's bf16 peak, as ``mfu.tokens``, in
the cells whose end-to-end metric is the time to first token."""
from harness.layers import mfu

UNIT, LAYER, MOVES = "%", "models.transformer and models.ssm", "ttft_p95_ms"


def read(run):
    return mfu(run)
