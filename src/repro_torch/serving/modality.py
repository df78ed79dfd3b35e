"""Modality front-end stubs of the port (the one sanctioned carve-out), as
in the JAX package's ``repro.serving.modality``.

Audio: instead of a mel spectrogram and a conv encoder, ``audio_frames``
emits frame embeddings of shape (B, encoder_seq, d_model). VLM: instead
of a VQ-GAN tokenizer, ``image_tokens`` emits VQ code ids inside the
shared vocabulary. Both draw from an explicit ``torch.Generator`` and
land on its device; torch's generator draws other numbers than
``jax.random`` from the same seed, so a comparison with the JAX package
feeds both the same arrays.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import dtype_of


def _generator(generator: Optional[torch.Generator], seed: int):
    """``generator``, or a CPU generator seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed(seed)


def audio_frames(cfg, batch: int, seed: int = 0,
                 generator: Optional[torch.Generator] = None, dtype=None):
    """Precomputed frame embeddings standing in for the conv front end:
    standard normal times 0.02, (batch, encoder_seq, d_model) in ``dtype``
    (default: the config's), drawn in float32 from ``generator`` (default:
    a CPU generator seeded with ``seed``) on its device."""
    gen = _generator(generator, seed)
    x = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return x.to(dtype_of(dtype or cfg.dtype)) * 0.02


def image_tokens(cfg, batch: int, n_tokens: int = 1024, seed: int = 0,
                 code_offset: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
    """VQ image-token ids (batch, n_tokens) int32; chameleon reserves the
    top 8192 codes of its vocabulary."""
    if code_offset is None:
        code_offset = max(0, cfg.vocab_size - 8192)
    gen = _generator(generator, seed)
    return torch.randint(code_offset, cfg.vocab_size, (batch, n_tokens),
                         generator=gen, dtype=torch.int32,
                         device=gen.device)


def interleave_multimodal(cfg, text_tokens, img_tokens):
    """Chameleon-style early fusion: [image tokens][text tokens]."""
    return torch.cat([img_tokens, text_tokens], dim=1)
