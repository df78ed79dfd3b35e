"""Synthetic data pipeline: the JAX package's deterministic token stream
(``data/pipeline.py`` there) with torch tensors at the end.

No real corpora. The LM stream mixes a Zipfian unigram process with short
copy motifs, so a model trained a few hundred steps shows a clearly
falling loss. The stream is drawn from the same ``np.random.default_rng``
calls as the JAX package's, so a seed gives the same tokens in both.
Encoder models take stub frame embeddings from
``repro_torch.serving.modality.audio_frames``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.serving import modality


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    zipf_a: float = 1.2
    motif_prob: float = 0.3


class TokenPipeline:
    """Batches of ``tokens`` and next-token ``labels``, (batch, seq_len)
    int64 on ``device`` (default: the CUDA device; raises where there is
    none unless ``device="cpu"`` is passed)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, device=None):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(dcfg.seed)

    def _sequence(self) -> np.ndarray:
        d = self.dcfg
        v = self.cfg.vocab_size
        seq = np.minimum(self._rng.zipf(d.zipf_a, size=d.seq_len + 1) - 1, v - 1)
        # splice copy motifs (induction-head food)
        i = 0
        while i < d.seq_len - 8:
            if self._rng.random() < d.motif_prob:
                span = self._rng.integers(2, 5)
                seq[i + span: i + 2 * span] = seq[i: i + span]
                i += 2 * span
            else:
                i += 4
        return seq.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        d = self.dcfg
        arr = torch.from_numpy(
            np.stack([self._sequence() for _ in range(d.batch_size)])).long()
        batch = {"tokens": arr[:, :-1].to(self.device),
                 "labels": arr[:, 1:].to(self.device)}
        if self.cfg.has_encoder:
            batch["enc_embeds"] = modality.audio_frames(
                self.cfg, d.batch_size,
                seed=int(self._rng.integers(1 << 30))).to(self.device)
        return batch


def eval_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
               seed: int = 1234, device=None):
    pipe = TokenPipeline(cfg, DataConfig(batch_size, seq_len, seed), device)
    return next(iter(pipe))
