"""The whole step's share of the chip's bf16 peak: model FLOPs of every
prompt and output token the window's ticks processed, over the window's
seconds at 989 TFLOP/s."""
from harness.layers import mfu

UNIT, LAYER, MOVES = "%", "models.transformer and models.ssm", "tokens_per_s"


def read(run):
    return mfu(run)
