"""Window arithmetic: percentiles over every sample, rates over the whole
window, a refused or unserved request counted as missing."""
import math

from harness import endtoend, stats
from harness.stats import Record


def rec(rid, due, stamps, refused=False):
    r = Record(rid, due, None, len(stamps))
    r.stamps = list(stamps)
    r.refused = refused
    return r


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 0.95) == 95
    assert stats.percentile(xs, 0.5) == 50
    assert stats.percentile([3.0], 0.95) == 3.0
    assert math.isnan(stats.percentile([], 0.95))


class _Run:
    def __init__(self, records, w0, w1):
        self.records, self.w0, self.w1 = records, w0, w1
        self.seconds = w1 - w0
        self.setup_s = 12.5

    @property
    def in_window(self):
        return stats.due_in(self.records, self.w0, self.w1)


def test_tokens_per_s_counts_every_token_in_the_window():
    rs = [rec(0, 0.0, [0.5, 1.5, 2.5, 10.5]), rec(1, 1.0, [3.0, 9.99]),
          rec(2, 2.0, [])]
    run = _Run(rs, 1.0, 11.0)
    # 1.5, 2.5, 10.5, 3.0, 9.99 lie in [1, 11)
    assert endtoend.tokens_per_s(run) == 5 / 10.0


def test_tbt_takes_every_gap_inside_the_window():
    rs = [rec(0, 0.0, [0.5, 1.5, 2.0, 12.0]), rec(1, 0.0, [2.0, 5.0])]
    gaps = sorted(stats.gaps_in(rs, 1.0, 11.0))
    assert gaps == [0.5, 3.0]
    assert endtoend.tbt_p95_ms(_Run(rs, 1.0, 11.0)) == 3000.0


def test_ttft_counts_refused_and_unserved_as_missing():
    rs = [rec(i, 1.0 + i * 0.1, [1.0 + i * 0.1 + 0.05]) for i in range(18)]
    rs.append(rec(18, 5.0, [], refused=True))
    rs.append(rec(19, 6.0, []))
    rs.append(rec(20, 0.5, []))            # due before the window
    run = _Run(rs, 1.0, 11.0)
    assert len(run.in_window) == 20
    # 18 of 20 served at 50 ms: the 95th percentile is missing
    assert math.isinf(endtoend.ttft_p95_ms(run))
    run.records = rs[:18] + [rec(18, 5.0, [5.2])]
    assert abs(endtoend.ttft_p95_ms(run) - 200.0) < 1e-6
    assert endtoend.setup_s(run) == 12.5
