"""Kernel #1, ``paged_decode_attention`` (``kernels.ops``): its least time
over its profiled device time in the window. Per layer and tick, from the
plan: every decoding slot's query and output once, and its K and V over
the keys it attends (its position + 1), and the block-table row that
maps them; 4 * heads * head_dim operations per key (scores and values)."""
from harness.layers import elem_bytes, roofline

UNIT, LAYER, MOVES = "%", "kernels.ops", "tokens_per_s"
SYMBOLS = ("paged_split_kernel", "paged_combine_splits")
PAGE = 16


def work(cfg, tick):
    """(operations, bytes) of one layer's launch in ``tick``."""
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    e = elem_bytes(cfg)
    flops = nbytes = 0.0
    for keys in tick.decode_ctx:
        flops += 4.0 * h * hd * keys
        nbytes += (2 * h * hd + 2 * keys * kv * hd) * e
        nbytes += 4 * (-(-keys // PAGE) + 1)
    return flops, nbytes


def read(run):
    return roofline(run, SYMBOLS, work)
