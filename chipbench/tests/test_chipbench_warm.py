"""The warm-up reaches every step key a cell's admissions can: each list
of segment lengths within the bounds maps to a key one witness has."""
import itertools

import pytest

from harness.warm import witnesses


class _Keys:
    """The engine's step key of a packed batch, as
    ``InferenceEngine.segment_key`` computes it, at a slot length."""

    def __init__(self, slot_len):
        import torch
        from repro_torch.serving.engine import InferenceEngine
        self.eng = InferenceEngine.__new__(InferenceEngine)
        self.eng.slot_len = slot_len
        self.torch = torch

    def __call__(self, lens):
        return self.eng.segment_key(list(lens))


@pytest.mark.parametrize("n_max,lo,hi,sum_max,slot_len", [
    (4, 1, 20, 20, 64), (3, 5, 40, None, 32), (5, 3, 17, None, 4096),
    (2, 1, 64, 64, 48)])
def test_witnesses_cover_every_reachable_key(n_max, lo, hi, sum_max,
                                             slot_len):
    key = _Keys(slot_len)
    wit = witnesses(n_max, lo, hi, sum_max)
    for lens in wit:
        assert 1 <= len(lens) <= n_max
        assert all(lo <= n <= hi for n in lens)
        assert sum_max is None or sum(lens) <= sum_max
    have = {key(w) for w in wit}
    for n in range(1, n_max + 1):
        for lens in itertools.combinations_with_replacement(
                range(lo, hi + 1), n):
            if sum_max is None or sum(lens) <= sum_max:
                assert key(lens) in have, lens
