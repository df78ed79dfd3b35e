"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and draws requests.

Every seed gets the same work. The sizes of the requests (prompt and
output lengths) and, in an open loop, the arrival times are drawn from the
mix's own ``trace_seed`` (0 unless the mix says): one fixed trace. The
run's seed draws the prompt ids (and the harness draws the weights from
it), so runs with different seeds offer the same tokens at the same
moments and differ in what they say.

* ``"loop": "closed"``: ``clients`` clients, each sending its next request
  when the last one ends; ``client(i)`` yields client i's requests. The
  sizes come in blocks of ``clients * BLOCK`` requests dealt out to the
  clients. With
  ``"first_aged": true`` the loop starts as if it had run for ever: each
  client's first request is one caught in flight, its output length drawn
  in proportion to itself (a long request is in flight longer) and its age
  uniform below that; the tokens already served ride in its prompt and
  its budget is what is left.
* ``"loop": "open"``: arrivals on a schedule whatever the server does;
  ``arrivals(horizon)`` gives every request due before ``horizon``
  seconds. ``"process": "poisson"`` draws exponential gaps at ``rate``;
  ``"gamma"`` draws gamma gaps of the same mean with shape ``shape``
  (burstier below 1).

Lengths: ``uniform`` (integers lo..hi), ``loguniform`` (lo..hi) and
``lognormal`` (``median``, ``sigma``, clipped to lo..hi). Prompt ids are
uniform over 1..vocab-1. The arithmetic is that of
``repro_torch.serving.traffic`` (numpy's generator, exponential gaps),
sized here for wall time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

BLOCK = 64          # requests per client in one block of closed-loop sizes


@dataclasses.dataclass
class Draw:
    """One request as drawn: when it is due (open loop, seconds from the
    start; 0 in a closed one), its prompt and its output budget."""
    prompt: np.ndarray            # (prompt_len,) int32
    n_tokens: int
    due: float = 0.0


def draw_length(rng: np.random.Generator, spec: Dict[str, Any]) -> int:
    kind, lo, hi = spec["dist"], int(spec["lo"]), int(spec["hi"])
    if kind == "uniform":
        return int(rng.integers(lo, hi + 1))
    if kind == "loguniform":
        v = math.exp(rng.uniform(math.log(lo), math.log(hi + 1)))
        return int(min(hi, max(lo, math.floor(v))))
    if kind == "lognormal":
        v = float(spec["median"]) * math.exp(float(spec["sigma"])
                                            * rng.standard_normal())
        return int(min(hi, max(lo, round(v))))
    raise ValueError(f"unknown length distribution {kind!r}")


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (2 ** 64), *stream]))


class Traffic:
    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        self.mix = mix
        self.seed = seed
        self.vocab = vocab
        self.trace_seed = int(mix.get("trace_seed", 0))
        self.loop = mix["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self._blocks: Dict[int, List[Tuple[int, int]]] = {}
        self._aged_sizes = None

    def _size(self, rng) -> Tuple[int, int]:
        return (draw_length(rng, self.mix["prompt"]),
                draw_length(rng, self.mix["output"]))

    def _aged_size(self, rng) -> Tuple[int, int]:
        spec = self.mix["output"]
        while True:                       # length-biased: accept n / hi
            n = draw_length(rng, spec)
            if rng.uniform() * int(spec["hi"]) < n:
                break
        age = int(rng.integers(0, n))
        return draw_length(rng, self.mix["prompt"]) + age, n - age

    def _prompt(self, rng, length: int) -> np.ndarray:
        return rng.integers(1, self.vocab, size=length).astype(np.int32)

    # ------------------------------------------------------- closed loop
    @property
    def clients(self) -> int:
        return int(self.mix["clients"])

    def _block(self, b: int) -> List[Tuple[int, int]]:
        if b not in self._blocks:
            base = _rng(self.trace_seed, 1, b)
            sizes = [self._size(base) for _ in range(self.clients * BLOCK)]
            self._blocks[b] = sizes
        return self._blocks[b]

    def _aged(self) -> List[Tuple[int, int]]:
        if self._aged_sizes is None:
            base = _rng(self.trace_seed, 2)
            sizes = [self._aged_size(base) for _ in range(self.clients)]
            self._aged_sizes = sizes
        return self._aged_sizes

    def client(self, i: int) -> Iterator[Draw]:
        """Client ``i``'s requests, in the order it sends them."""
        ids = _rng(self.seed, 3, i)
        if self.mix.get("first_aged"):
            p, n = self._aged()[i]
            yield Draw(self._prompt(ids, p), n)
        k = 0
        while True:
            p, n = self._block(k // BLOCK)[i * BLOCK + k % BLOCK]
            yield Draw(self._prompt(ids, p), n)
            k += 1

    # --------------------------------------------------------- open loop
    def arrivals(self, horizon: float) -> List[Draw]:
        """Every request due in [0, horizon), in order of due time."""
        spec = self.mix["arrivals"]
        rate = float(spec["rate"])
        gaps = _rng(self.trace_seed, 4)
        times = []
        t = 0.0
        while True:
            if spec["process"] == "poisson":
                t += float(gaps.exponential(1.0 / rate))
            elif spec["process"] == "gamma":
                k = float(spec["shape"])
                t += float(gaps.gamma(k, 1.0 / (k * rate)))
            else:
                raise ValueError(f"unknown process {spec['process']!r}")
            if t >= horizon:
                break
            times.append(t)
        base = _rng(self.trace_seed, 5)
        sizes = [self._size(base) for _ in times]
        ids = _rng(self.seed, 6)
        return [Draw(self._prompt(ids, p), n, due=t)
                for t, (p, n) in zip(times, sizes)]
