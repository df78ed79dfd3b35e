"""Model API of the port: ``build_model(cfg)`` returns a ``ModelAPI`` whose
fields carry the JAX package's names, so the serving engine never branches
on architecture:

  forward(params, batch, remat=False)            -> (logits (B, S, V), aux)
  prefill(params, batch, cache_len)              -> (last logits (B, V), cache)
  prefill_packed(params, packed, row_len)        -> (seg_logits, packed cache)
  prefill_chunk(params, packed, cache, row_len)  -> (seg_logits, argmax, cache)
  decode_step(params, token (B,), cache, mask=None)
                                                 -> (logits (B, V), cache)
  prepare(params)                                -> params (what an engine
                                                    keeps: derived weights
                                                    made once)

``decode_step``'s ``mask`` (B,) bool is the slot step's: a family with
per-slot recurrent state (Mamba2, the hybrid) then advances that state
IN PLACE on the masked rows and returns the cache's own tensor, leaving
the other rows untouched; the other families take no mask and step as
without it. Without a mask every family is functional, as in the JAX
package.

``forward`` is differentiable for every family: ``repro_torch.training``
trains through it, ``remat`` running each layer under activation
checkpointing (the encoder-decoder's decoder layers only, as in the JAX
package). On the card its attention goes through ``flash_vjp`` (#5 and
its backward kernel) and its SSD scan through ``ssd_scan.ssd_vjp`` (#6
forward, the plain scan's gradients).

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

The sharding methods are the JAX package's: ``param_specs``,
``cache_specs`` and ``input_shardings`` map the plans' logical axes to a
mesh (``utils.sharding``); ``abstract_params``, ``abstract_cache`` and
``input_specs`` give ``meta`` tensors of the same shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import weights
from repro_torch.utils.sharding import resolve_spec, tree_specs


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
    # the caches' ParamDef plans (shapes and logical axes):
    # cache_plan(batch, cache_len), paged_cache_plan(batch, num_pages,
    # page_size, max_pages) — None for a family with nothing to page
    cache_plan: Optional[Callable] = None
    paged_cache_plan: Optional[Callable] = None

    # ------------------------------------------------------------- sharding
    def param_specs(self, mesh):
        return tree_specs(self.plan, mesh)

    def cache_specs(self, mesh, batch: int, cache_len: int):
        return tree_specs(self.cache_plan(batch, cache_len), mesh)

    def abstract_params(self, dtype=torch.float32):
        return L.abstract_params(self.plan, dtype_of(dtype))

    def abstract_cache(self, batch: int, cache_len: int, dtype=None):
        """The ring cache's leaves on the ``meta`` device: int32 for the
        0/1-D per-sequence positions, float32 for the 5-D ``ssm_heads``
        state, ``dtype`` (default the config's) for the rest."""
        dtype = dtype_of(dtype or self.cfg.dtype)

        def leaf(pd):
            if len(pd.shape) <= 1:
                dt = torch.int32
            elif pd.spec and "ssm_heads" in pd.spec and len(pd.shape) == 5:
                dt = torch.float32
            else:
                dt = dtype
            return torch.empty(tuple(pd.shape), dtype=dt, device="meta")

        def walk(tree):
            if isinstance(tree, L.ParamDef):
                return leaf(tree)
            return {k: walk(v) for k, v in tree.items()}

        return walk(self.cache_plan(batch, cache_len))

    # -------------------------------------------------------------- inputs
    def input_specs(self, shape: InputShape, mesh=None) -> Dict[str, Any]:
        """``meta`` stand-ins for every model input of this shape."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(dims, dt=torch.int32):
            return torch.empty(dims, dtype=dt, device="meta")

        if shape.kind == "train":
            specs = {"tokens": meta((b, s)), "labels": meta((b, s))}
        elif shape.kind == "prefill":
            specs = {"tokens": meta((b, s))}
        else:  # decode: ONE new token against a seq_len-sized cache
            specs = {"token": meta((b,))}
        if cfg.has_encoder and shape.kind != "decode":
            specs["enc_embeds"] = meta((b, cfg.encoder_seq, cfg.d_model),
                                       dtype_of(cfg.dtype))
        return specs

    def input_shardings(self, shape: InputShape, mesh):
        out = {}
        for name, x in self.input_specs(shape).items():
            logical = ("batch",) + (None,) * (x.dim() - 1)
            out[name] = resolve_spec(logical, tuple(x.shape), mesh)
        return out


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

    init_paged = paged_plan = prefill_chunk = None
    prepare = ModelAPI.prepare
    if hasattr(mod, "prepare_params"):
        def prepare(params):
            return mod.prepare_params(params, cfg)
    if mod.PAGED_KEYS:
        def paged_plan(batch, num_pages, page_size, max_pages):
            return mod.paged_cache_plan(cfg, batch, num_pages, page_size,
                                        max_pages)

        def init_paged(batch, num_pages, page_size, max_pages, dtype=None):
            return mod.init_paged_cache(cfg, batch, num_pages, page_size,
                                        max_pages, dtype, device=dev)
    if hasattr(mod, "prefill_chunk"):
        def prefill_chunk(params, packed, cache, row_len):
            return mod.prefill_chunk(params, cfg, packed, cache, row_len)

    # an encoder model's batches also carry the frame embeddings
    extra = ("enc_embeds",) if cfg.has_encoder else ()
    masked = "mask" in inspect.signature(mod.decode_step).parameters

    def decode_step(params, token, cache, mask=None):
        if mask is None or not masked:
            return mod.decode_step(params, cfg, token, cache)
        return mod.decode_step(params, cfg, token, cache, mask=mask)

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
        decode_step=decode_step,
        init_cache=init_cache,
        paged_keys=tuple(mod.PAGED_KEYS),
        init_paged_cache=init_paged,
        prefill_chunk=prefill_chunk,
        prepare=prepare,
        cache_plan=lambda batch, cache_len: mod.cache_plan(cfg, batch,
                                                           cache_len),
        paged_cache_plan=paged_plan,
    )
