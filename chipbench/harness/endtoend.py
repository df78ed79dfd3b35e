"""The end-to-end metrics a user of the system sees, from the clients'
stamps over the whole window (``--trace 0``)."""
from __future__ import annotations

from harness import stats


def tokens_per_s(run) -> float:
    """Output tokens that reached clients in the window, over its seconds."""
    return stats.tokens_in(run.records, run.w0, run.w1) / run.seconds


def ttft_p95_ms(run) -> float:
    """95th percentile over every request due in the window of its time
    from due to first token; a request refused or never served counts as
    infinite."""
    return 1e3 * stats.percentile(stats.ttfts(run.in_window), 0.95)


def tbt_p95_ms(run) -> float:
    """95th percentile of every gap between consecutive tokens of a
    request, both in the window."""
    return 1e3 * stats.percentile(stats.gaps_in(run.records, run.w0,
                                                run.w1), 0.95)


def setup_s(run) -> float:
    """Process start to the window's start."""
    return run.setup_s


METRICS = {"tokens_per_s": tokens_per_s, "ttft_p95_ms": ttft_p95_ms,
           "tbt_p95_ms": tbt_p95_ms, "setup_s": setup_s}
