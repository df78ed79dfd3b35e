"""Kernel #2, ``segment_flash_attention`` (``kernels.ops``, the packed
prefill of admissions): its least time over its profiled device time in
the window. Per layer and tick, from the plan's first chunks: each
segment's queries, keys, values and outputs once (real tokens, no
padding), and causal attention within the segment, 4 * heads * head_dim
operations per (query, key) pair."""
from harness.layers import elem_bytes, roofline
from harness.work import segment_keys

UNIT, LAYER, MOVES = "%", "kernels.ops", "ttft_p95_ms"
SYMBOLS = ("segment_flash_kernel", "segment_tc_kernel")


def work(cfg, tick):
    """(operations, bytes) of one layer's launch in ``tick``."""
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    e = elem_bytes(cfg)
    flops = nbytes = 0.0
    for n in tick.first:
        flops += 4.0 * h * hd * segment_keys(0, n)
        nbytes += n * (2 * h + 2 * kv) * hd * e
    return flops, nbytes


def read(run):
    return roofline(run, SYMBOLS, work)
