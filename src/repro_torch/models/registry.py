"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
fields carry the JAX package's names, so the serving engine never branches
on architecture:

  forward(params, batch, remat=False)            -> (logits (B, S, V), aux)
  prefill(params, batch, cache_len)              -> (last logits (B, V), cache)
  prefill_packed(params, packed, row_len)        -> (seg_logits, packed cache)
  prefill_chunk(params, packed, cache, row_len)  -> (seg_logits, argmax, cache)
  decode_step(params, token (B,), cache)         -> (logits (B, V), cache)
  prepare(params)                                -> params (what an engine
                                                    keeps: derived weights
                                                    made once)

``forward`` is differentiable for the transformer family (dense, experts,
``vlm``): ``repro_torch.training`` trains through it, ``remat`` running
each layer under activation checkpointing. The other families' forwards
raise under autograd or with ``remat``: their backwards (the SSD scan's,
the encoder-decoder's) are not ported.

``batch`` is ``{"tokens": (B, S) tensor}`` on the model's device, plus
``enc_embeds`` (B, encoder_seq, d_model) for an encoder model (``packed``
carries the per-segment stack). Every family of the JAX package is
ported: the dense family, the mixture-of-experts family (``moe``:
granite-moe, phi3.5-moe) and chameleon's early-fusion ``vlm``, which are
the same transformer, over ring (``init_cache``) and paged
(``init_paged_cache``) caches; the Mamba2 family (``ssm``), whose
per-sequence state has nothing to page; the hybrid family (``hybrid``,
zamba2-7b), whose shared attention block's K/V is paged beside the
per-slot Mamba state; and the encoder-decoder family (``audio``,
whisper-small), whose cross K/V is a per-slot leaf beside the paged
self-attention K/V. None of the last three ships a ``prefill_chunk``:
the engine runs their continuations by prefix recompute.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import weights


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    plan: Any
    init: Callable
    forward: Callable
    prefill: Callable
    # packed ragged prefill: a whole admission batch concatenated into one
    # (1, total_tokens) row; per-SEGMENT last logits plus a packed cache
    # whose per-token leaves the engine scatters straight into pages
    prefill_packed: Callable
    decode_step: Callable
    init_cache: Callable
    paged_keys: tuple = ()
    init_paged_cache: Optional[Callable] = None
    # incremental chunk attention over K/V resident in the page pool
    # (chunked-prefill continuations)
    prefill_chunk: Optional[Callable] = None
    # the parameters an engine keeps: the family's derived weights made
    # once per parameter set (Mamba2), or the parameters as given
    prepare: Callable = lambda params: params


def build_model(cfg: ModelConfig, device=None) -> ModelAPI:
    """The API of ``cfg`` on ``device`` (default: the CUDA device; raises
    where there is none unless ``device="cpu"`` is passed)."""
    mod = weights.FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)

    def init(generator: torch.Generator, dtype=torch.float32):
        return weights.init_params(cfg, generator, dev, dtype)

    def init_cache(batch, cache_len, dtype=None):
        return mod.init_cache(cfg, batch, cache_len, dtype, device=dev)

    init_paged = prefill_chunk = None
    prepare = ModelAPI.prepare
    if hasattr(mod, "prepare_params"):
        def prepare(params):
            return mod.prepare_params(params, cfg)
    if mod.PAGED_KEYS:
        def init_paged(batch, num_pages, page_size, max_pages, dtype=None):
            return mod.init_paged_cache(cfg, batch, num_pages, page_size,
                                        max_pages, dtype, device=dev)
    if hasattr(mod, "prefill_chunk"):
        def prefill_chunk(params, packed, cache, row_len):
            return mod.prefill_chunk(params, cfg, packed, cache, row_len)

    # an encoder model's batches also carry the frame embeddings
    extra = ("enc_embeds",) if cfg.has_encoder else ()
    return ModelAPI(
        cfg=cfg,
        device=dev,
        plan=mod.plan(cfg),
        init=init,
        forward=lambda params, batch, remat=False: mod.forward(
            params, cfg, batch["tokens"], *[batch[k] for k in extra],
            remat=remat),
        prefill=lambda params, batch, cache_len: mod.prefill(
            params, cfg, batch["tokens"], cache_len,
            *[batch[k] for k in extra]),
        prefill_packed=lambda params, packed, row_len: mod.prefill_packed(
            params, cfg, packed, row_len),
        decode_step=lambda params, token, cache: mod.decode_step(
            params, cfg, token, cache),
        init_cache=init_cache,
        paged_keys=tuple(mod.PAGED_KEYS),
        init_paged_cache=init_paged,
        prefill_chunk=prefill_chunk,
        prepare=prepare,
    )
