"""Kernel #6, ``ssd_scan`` (``kernels.ops``, the SSD scan of each packed
prefill): its least time over its profiled device time in the window. Per
layer and tick, from the plan's prompts (real tokens, no padding): x and y
in the activation type, dt in float32, B and C once, each segment's final
float32 state written once; the recurrence's 4 * heads * head_dim * state
operations per token (fewer than the chunked form computes, so the share
is never counted high)."""
from harness.layers import elem_bytes, roofline

UNIT, LAYER, MOVES = "%", "kernels.ops", "tokens_per_s"
SYMBOLS = ("ssd_kernel", "ssd_tc_kernel")


def work(cfg, tick):
    """(operations, bytes) of one layer's launch in ``tick``."""
    di = cfg["ssm_expand"] * cfg["d_model"]
    n_state, p = cfg["ssm_state"], cfg["ssm_head_dim"]
    h = di // p
    e = elem_bytes(cfg)
    lens = list(tick.first) + [hist + n for hist, n in tick.cont]
    flops = nbytes = 0.0
    for n in lens:
        flops += 4.0 * di * n_state * n
        nbytes += n * (2 * di * e + 4 * h + 2 * n_state * e)
        nbytes += 4 * h * n_state * p
    return flops, nbytes


def read(run):
    return roofline(run, SYMBOLS, work)
