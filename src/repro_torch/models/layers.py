"""Model-building primitives of the port: the dense-decoder and
encoder-decoder subset of the JAX package's ``repro.models.layers``, as
plain functions on tensors — for padded and packed prefill (self- and
cross-attention), and decode over ring or paged caches.

Parameters are declared through a *plan* of ``ParamDef``s (same shapes,
logical axes and initialisers as the JAX package: the axes drive
``utils.sharding``), and the apply functions take the same
parameter dictionaries with the same leaf names, so weights convert
between the two packages leaf for leaf (``repro_torch.models.weights``).

Attention on the serving path goes through ``repro_torch.kernels.ops``: the
hand-written CUDA kernels for tensors on a GPU, their plain versions —
the JAX CPU path's arithmetic — for tensors on the CPU.

On DTensors under ``utils.sharding.use_mesh`` (the dry run, a sharded
run) the same functions run SPMD: the JAX package's constraint sites
(``maybe_constrain``, ``constrain_q_prefill``/``_decode``), the
sequence-sharded ``cp_attention``, attention per head-group shard
(``per_head_shards``), and the residual stream pinned to the JAX
layer-carry layout (``residual``) where DTensor's own choice would
flatten two sharded dims. On plain tensors none of it does anything.

Sampling (``top_k_top_p_filter``, ``sample_logits``) is the JAX package's
plain sampler: ``jax.random.categorical`` is the arg-max of Gumbel noise
plus the logits, and the noise comes from an explicit ``torch.Generator``
through ``gumbel_noise``, the one function that draws.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import flash_vjp, ops
from repro_torch.kernels.flash_attention import (attention_dense,
                                                 repeat_kv, rows_to_segments,
                                                 segments_to_rows)
from repro_torch.utils import sharding
from repro_torch.utils.sharding import is_dtensor, maybe_constrain, whole

__all__ = [
    "ParamDef", "stack_plan", "abstract_params", "plan_zeros", "norm_plan",
    "attn_plan", "mlp_plan", "embed_plan", "layer_params", "apply_norm",
    "rope_tables", "apply_rope", "attn_qkv", "attn_out", "residual",
    "apply_mlp", "embed_tokens", "unembed",
    "repeat_kv",
    "attention_dense", "run_layer", "big_attention", "cp_attention",
    "cp_shard", "per_head_shards",
    "constrain_q_prefill", "constrain_q_decode", "kv_cache_spec",
    "paged_kv_cache_spec",
    "packed_positions",
    "segments_to_rows", "rows_to_segments", "packed_prefill_attention",
    "packed_cross_attention", "cache_row_update", "paged_cache_update",
    "decode_attention", "paged_decode_attention", "paged_chunk_attention",
    "decode_index", "carry_cache_meta", "gumbel_noise",
    "top_k_top_p_filter", "sample_logits",
]


# --------------------------------------------------------------------------
# parameter plans
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    spec: Optional[Tuple[Optional[str], ...]]        # logical axes
    init: str = "normal"                             # normal | zeros | ones
    std: float = 0.02


def stack_plan(plan, n: int):
    """The plan of ``n`` copies of ``plan`` stacked on a leading axis (the
    logical ``stack`` axis, never sharded)."""
    if isinstance(plan, ParamDef):
        spec = plan.spec or (None,) * len(plan.shape)
        return ParamDef((n,) + tuple(plan.shape), ("stack",) + tuple(spec),
                        plan.init, plan.std)
    return {k: stack_plan(v, n) for k, v in plan.items()}


def plan_zeros(pd: ParamDef, dtype, device, like=None):
    """Zeros of ``pd``'s shape on ``device``; when ``like`` is a DTensor
    (a sharded run), a DTensor of local zeros on its mesh, placed by
    ``pd``'s logical axes, so no device holds the whole leaf."""
    if not is_dtensor(like):
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    mesh = like.device_mesh
    spec = sharding.resolve_spec(pd.spec, pd.shape, mesh)
    local = torch.zeros(sharding.local_shape(pd.shape, spec, mesh),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, sharding.placements(spec, mesh),
                              run_check=False)


def abstract_params(plan, dtype=torch.float32):
    """The plan's tensors on the ``meta`` device: shapes and dtypes, no
    storage (the counterpart of ``jax.ShapeDtypeStruct``)."""
    if isinstance(plan, ParamDef):
        return torch.empty(tuple(plan.shape), dtype=dtype, device="meta")
    return {k: abstract_params(v, dtype) for k, v in plan.items()}


def layer_params(tree, i: int):
    """Layer ``i``'s parameters: a view into every stacked leaf."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def norm_plan(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), "ones"),
                "bias": ParamDef((d,), ("embed",), "zeros")}
    if kind == "layernorm_nonparam":
        return {}
    raise ValueError(kind)


def attn_plan(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    # head_dim is deliberately not a fallback shard axis (the JAX
    # package's note: a head_dim-sharded q/k makes every score tile a
    # partial-sum all-reduce); non-divisible head counts replicate the
    # projections and shard the KV cache's sequence instead
    p = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((h, hd), ("heads", None), "zeros")
        p["bk"] = ParamDef((kv, hd), ("kv_heads", None), "zeros")
        p["bv"] = ParamDef((kv, hd), ("kv_heads", None), "zeros")
    return p


def mlp_plan(cfg, d_ff: Optional[int] = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamDef((d, ff), ("embed", "mlp")),
        "wi_up": ParamDef((d, ff), ("embed", "mlp")),
        "wo": ParamDef((ff, d), ("mlp", "embed")),
    }


def embed_plan(cfg) -> dict:
    v = cfg.padded_vocab
    p = {"embedding": ParamDef((v, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return p


# --------------------------------------------------------------------------
# norms, rotary embeddings, projections
# --------------------------------------------------------------------------
def _last_dim_sharded(x) -> bool:
    from torch.distributed.tensor import Shard
    return is_dtensor(x) and any(isinstance(p, Shard) and p.dim == x.dim()
                                 - 1 for p in x.placements)


def mean_last(x):
    """The mean over the last dim, kept, and whole on every device
    (``sharding.whole``). Where a DTensor's last dim is sharded it is a sum
    over n: a mean there leaves ``Partial(avg)``, whose gradient cannot
    meet the ``Partial(sum)`` of a sharded matmul's."""
    if _last_dim_sharded(x):
        return whole(x.sum(-1, keepdim=True)) / x.shape[-1]
    return whole(x.mean(-1, keepdim=True))


def apply_norm(p, x, kind: str, eps: float = 1e-5):
    """RMS or layer norm over the last dim, statistics in float32 (by
    ``mean_last``)."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(mean_last(xf * xf) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = mean_last(xf)
    if _last_dim_sharded(xf):
        var = mean_last((xf - mu) * (xf - mu))
    else:
        var = whole(xf.var(-1, keepdim=True, unbiased=False))
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    # the JAX package's float32 numpy formula, uploaded once per device
    half = d // 2
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / d))
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def clear_caches() -> None:
    """Drop the tensors cached per device (the rotary frequencies)."""
    _inv_freq.cache_clear()


def rope_tables(positions, d: int, theta: float):
    """(cos, sin) of shape positions.shape + (1, d // 2), float32 — built
    once per dispatch and shared by every layer's q and k."""
    freq = _inv_freq(d, float(theta), positions.device)
    ang = positions[..., None].float() * freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x, cos, sin):
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x[..., 2 * half:]], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding. x: (..., S, H, D); positions:
    broadcastable to (..., S)."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


def attn_qkv(p, cfg, x, rope):
    """Project + rotate. x: (B, S, d) -> q (B, S, H, hd), k, v
    (B, S, KV, hd); ``rope`` is ``rope_tables`` of the positions."""
    b, s, d = x.shape
    x = residual(x)

    def proj(w):
        return (x.reshape(b * s, d) @ w.reshape(d, -1).to(x.dtype)).reshape(
            b, s, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if not cfg.learned_pos_emb:
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)
    return q, k, v


def attn_out(p, x_dtype, attn):
    """attn: (..., H, hd) -> (..., d_model)."""
    w = p["wo"]
    lead = attn.shape[:-2]
    attn = maybe_constrain(attn, "batch", *(None,) * (attn.dim() - 3),
                           "heads", None)
    y = attn.reshape(-1, w.shape[0] * w.shape[1]) @ w.reshape(
        -1, w.shape[2]).to(x_dtype)
    return y.reshape(*lead, w.shape[2])


def residual(x):
    """Activations (B, ..., d) in the JAX package's layer-carry layout
    (batch over the batch axes, d_model over ``model``) under a mesh;
    ``x`` itself on one device. DTensor chooses each op's layout alone and
    may shard a sequence dim beside the batch, which a matmul's flattening
    of the leading dims cannot take: the projections and the residual
    adds pin it here first."""
    return maybe_constrain(x, "batch", *(None,) * (x.dim() - 2),
                           "act_embed")


def _row_layout(y, lead):
    """(rows, n) rows laid out over the batch axes (the batch ``lead[0]``
    leads the rows), or whole where the batch itself does not divide them
    (JAX replicates such a batch: ``residual``), n over ``model``."""
    mesh = sharding.active_mesh()
    rows = "batch" if mesh is None or sharding.resolve_spec(
        ("batch",), lead[:1], mesh) else None
    return maybe_constrain(y, rows, "act_embed")


def _rows(x):
    """(x as (rows, d), its leading shape): a DTensor laid out by
    ``residual`` first; a plain tensor stays as it is (its matmul folds
    the leading dims itself). The rows are pinned to that layout on both
    sides of the reshape, so their gradient comes back in it: DTensor
    cannot view a gradient of another layout back (a d_model split over
    ``pod`` in the two-pod mesh's backward)."""
    if not is_dtensor(x) or x.dim() <= 2:
        return x, None
    lead = x.shape[:-1]
    return _row_layout(residual(x).reshape(-1, x.shape[-1]), lead), lead


def _unrows(y, lead):
    """``_rows``'s inverse: (rows, n) back to lead + (n,), pinned to
    ``_row_layout`` before the reshape and to ``residual`` after it."""
    if lead is None:
        return y
    return residual(_row_layout(y, lead).reshape(*lead, -1))


def apply_mlp(p, x):
    x, lead = _rows(x)
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return _unrows(h @ p["wo"].to(x.dtype), lead)


def embed_tokens(p, tokens, dtype):
    return p["embedding"][tokens].to(dtype)


def unembed(p, x, cfg):
    """Logits over the padded vocab; pad rows masked to -1e9."""
    w = p.get("lm_head")
    x, lead = _rows(x)
    if w is None:
        logits = x @ p["embedding"].to(x.dtype).T
    else:
        logits = x @ w.to(x.dtype)
    logits = _unrows(logits, lead)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


# --------------------------------------------------------------------------
# padded (dense) attention
# --------------------------------------------------------------------------
def run_layer(body, remat: bool, *args):
    """``body(*args)``, under ``torch.utils.checkpoint`` (non-reentrant:
    only the layer's inputs are kept, its activations are recomputed in
    the backward) with ``remat``, as the JAX package wraps its scanned
    layer in ``jax.checkpoint``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return body(*args)


def per_head_shards(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` on DTensors, run shard by shard: attention
    is independent per batch row and per KV head group, so q, k and v are
    laid out with at most their batch dims over the batch axes and their
    head dims over ``model`` (q's heads only where the KV heads shard
    alike; every other dim whole), and each device runs ``fn`` on its
    local shards (``local_map``). A tensor of ``rest`` is a per-row vector
    (B,), laid out as the batch. The output is laid out as q."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh

    def spec(x, logical):
        return sharding.resolve_spec(logical, tuple(x.shape), mesh)

    def at(sp, d):
        return sp[d] if d < len(sp) else None

    hd = q.dim() - 2
    lead = ("batch",) + (None,) * (hd - 1)
    sq = spec(q, lead + ("heads", None))
    sk = spec(k, ("batch", None, "kv_heads", None))
    if at(sq, hd) != at(sk, 2):
        sq, sk = spec(q, lead), spec(k, ("batch",))
    q_pl = sharding.placements(sq, mesh)
    kv_pl = sharding.placements(sk, mesh)
    rest_pl = tuple(sharding.placements(spec(x, ("batch",)), mesh)
                    if isinstance(x, torch.Tensor) else None for x in rest)
    return local_map(fn, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl) + rest_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, *rest)


def big_attention(q, k, v, *, causal: bool, window: int = 0):
    """Attention of a padded batch; on DTensors (a sharded run) through
    ``per_head_shards``. q: (B, S, H, D); k, v: (B, Sk, KV, D),
    Sk != S only for non-causal attention without a window (an encoder's
    frames under a decoder's queries). On a GPU every length goes through
    the flash kernel (it masks the ragged edges, so there is no
    tile-multiple gate); on the CPU the plain version runs
    ``attention_dense`` under the causal/window mask, as the JAX CPU path
    does.

    Under autograd (grad mode on and q, k or v requiring grad) it is the
    training path's ``flash_vjp.flash_attention_vjp``: on a GPU the flash
    kernel with its lse and the hand-written backward; on the CPU, as the
    JAX CPU path, ``attention_dense`` under autograd up to 1024 tokens and
    the plain flash VJP (chunks of 512 where they divide) beyond."""
    if is_dtensor(q):
        return per_head_shards(functools.partial(
            big_attention, causal=causal, window=window), q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        s, sk = q.shape[1], k.shape[1]
        if q.device.type == "cuda" or max(s, sk) > 1024:
            return flash_vjp.flash_attention_vjp(
                q, k, v, causal=causal, window=window,
                chunk_q=512 if s % 512 == 0 else s,
                chunk_k=512 if sk % 512 == 0 else sk)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def constrain_q_prefill(cfg, q, tp: int = 16):
    """Context parallelism for archs whose q-head count doesn't divide the
    TP width (qwen2: 14, whisper: 12, granite: 24): shard the q SEQUENCE so
    attention compute splits tp-ways with only a tiny all-gather of the
    (GQA-small) k/v — instead of replicating the whole S² computation."""
    if cfg.num_heads % tp:
        return maybe_constrain(q, "batch", "kv_seq", None, None)
    return q


def _cp_sharded(cfg, q, mesh) -> bool:
    """The JAX package's gate of the sequence-sharded branch: a DTensor q
    under a mesh whose ``model`` axis exists, does not divide the head
    count, divides S in units of 512, and whose batch axes divide B."""
    if mesh is None or not is_dtensor(q):
        return False
    sizes = sharding.axis_sizes(mesh)
    if "model" not in sizes or cfg.num_heads % sizes["model"] == 0:
        return False
    nb = int(np.prod([sizes[a] for a in sharding.batch_axes(mesh)]))
    return (q.shape[1] % (sizes["model"] * 512) == 0
            and q.shape[0] % max(1, nb) == 0)


def cp_shard(q_l, k_l, v_l, rank: int, *, causal: bool, window: int = 0):
    """One rank's part of the sequence-sharded ``cp_attention``: its slice
    q_l (B, S/m, H, D) of the queries against the whole k, v, the masks
    shifted to the slice's first position ``rank * S/m``
    (``flash_vjp.flash_attention_vjp`` at that ``q_offset``: #5 and #7 on
    the card)."""
    return flash_vjp.flash_attention_vjp(q_l, k_l, v_l, causal=causal,
                                         window=window,
                                         q_offset=rank * q_l.shape[1])


def cp_attention(cfg, q, k, v, *, causal: bool, window: int = 0):
    """Context-parallel self-attention for replicated-head architectures.

    Under a mesh that passes ``_cp_sharded``'s gate, each rank of the
    ``model`` axis runs ``flash_vjp.flash_attention_vjp`` on its sequence
    slice of q against the whole (small, GQA) k/v, with the causal and
    window masks shifted by the slice's offset (``q_offset``): a
    ``local_map`` over DTensors, q sharded on the sequence over ``model``
    and on the batch over the batch axes, k and v replicated over
    ``model`` (their gradients are partial sums there). Otherwise
    ``big_attention`` after ``constrain_q_prefill``, as in the JAX
    package."""
    mesh = sharding.active_mesh()
    if not _cp_sharded(cfg, q, mesh):
        q = constrain_q_prefill(cfg, q)
        return big_attention(q, k, v, causal=causal, window=window)

    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    ba = sharding.batch_axes(mesh)
    bspec = ba if len(ba) > 1 else (ba[0] if ba else None)
    q_pl = sharding.placements(sharding.P(bspec, "model"), mesh)
    kv_pl = sharding.placements(sharding.P(bspec), mesh)
    names = sharding.axis_names(mesh)
    kv_grad = tuple(Partial() if a == "model" else pl
                    for a, pl in zip(names, kv_pl))
    def local(q_l, k_l, v_l):
        return cp_shard(q_l, k_l, v_l, mesh.get_local_rank("model"),
                        causal=causal, window=window)

    fn = local_map(local, out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def constrain_q_decode(cfg, q, tp: int = 16):
    """Against a sequence-sharded cache (kv heads non-divisible), the
    single-token q must be replicated across the TP group: scores are then
    computed per cache shard and combined by a (batch, heads)-sized
    distributed softmax — bytes, not gigabytes, of all-reduce."""
    if cfg.num_kv_heads % tp:
        return maybe_constrain(q, "batch", None, None)
    return q


def kv_cache_spec(cfg, tp: int = 16):
    """Sharding for a (layers, batch, seq, kv_heads, head_dim) cache.

    KV heads shard when they divide the TP width (zero-communication local
    decode attention); otherwise the *sequence* dim shards — decode
    attention then does a distributed softmax whose all-reduce is only
    (batch, heads[, head_dim]) per layer."""
    if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0:
        return ("stack", "batch", None, "kv_heads", None)
    return ("stack", "batch", "kv_seq", None, None)


def paged_kv_cache_spec(cfg, tp: int = 16):
    """Sharding for a (layers, num_pages, page_size, kv_heads, head_dim)
    paged pool: KV heads shard when they divide the TP width, otherwise
    the *page* dim shards (pages are the paged analogue of the sequence
    dim; the block table stays replicated)."""
    if cfg.num_kv_heads and cfg.num_kv_heads % tp == 0:
        return ("stack", None, None, "kv_heads", None)
    return ("stack", "kv_seq", None, None, None)


# --------------------------------------------------------------------------
# packed ragged prefill
# --------------------------------------------------------------------------
def packed_positions(seg_ids, seg_starts):
    """Within-segment position of every token of a packed row; padding
    tokens (id == S) get position 0."""
    t = torch.arange(seg_ids.shape[0], device=seg_ids.device,
                     dtype=seg_ids.dtype)
    s = seg_starts.shape[0]
    start = seg_starts[torch.clamp(seg_ids, max=s - 1)]
    return torch.where(seg_ids < s, t - start, torch.zeros_like(t))


def packed_prefill_attention(q, k, v, seg_ids, positions, seg_starts,
                             seg_lens, *, row_len: int, window: int = 0):
    """Segment-blocked causal self-attention over a packed token row.
    q: (1, T, H, D); k/v: (1, T, KV, D). Token i attends token j iff
    their segment ids are equal and j <= i. On a GPU every packed length
    goes through the segment flash kernel."""
    return ops.segment_flash_attention(q, k, v, seg_ids, positions,
                                       seg_starts, seg_lens,
                                       row_len=row_len, window=window)


def packed_cross_attention(q, k_cross, v_cross, seg_ids, positions,
                           seg_starts, seg_lens, *, row_len: int):
    """Per-segment cross-attention of a packed encoder-decoder prefill.
    q: (1, T, H, D) packed decoder queries; k_cross, v_cross:
    (S, enc_seq, KV, D), one read-only encoder block per segment. Each
    packed token attends its OWN segment's encoder output: the queries
    gather to per-segment rows (S, row_len, H, D), attend their block
    non-causally — the flash kernel on a GPU (B = S, Sq = row_len, Sk =
    enc_seq, no (S, H, row_len, enc_seq) scores held), its plain version
    (the JAX package's ``attention_dense``) on the CPU — and gather
    back."""
    qr = segments_to_rows(q[0], seg_starts, seg_lens, row_len)
    ar = ops.flash_attention(qr, k_cross, v_cross, causal=False)
    return rows_to_segments(ar, seg_ids, positions)[None]


# --------------------------------------------------------------------------
# ring and paged KV caches
# --------------------------------------------------------------------------
def cache_row_update(buf, new, slot):
    """Write ``new`` (B, 1, ...) IN PLACE into ``buf`` (B, C, ...) at
    per-row ring position ``slot`` (B,): one row per sequence. A DTensor
    ``buf`` (the sharded dry run) is written shard by shard
    (``_sharded_row_update``)."""
    if is_dtensor(buf):
        return _sharded_row_update(buf, new[:, 0], slot)
    bidx = torch.arange(buf.shape[0], device=buf.device)
    buf[bidx, slot.long()] = new[:, 0].to(buf.dtype)
    return buf


def _shard_offset(mesh, pls, dim: int, local: int) -> int:
    """The global index of this device's first element along ``dim`` of a
    DTensor placed by ``pls`` whose local extent there is ``local``."""
    from torch.distributed.tensor import Shard
    idx = 0
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * local


def write_prefix(buf, i: int, new):
    """``buf[i, :, :n] = new`` for a stacked cache leaf ``buf`` (layers,
    B, C, ...) and ``new`` (B, n, ...): a prefill's keys into rows 0..n-1
    of layer i. A DTensor ``buf`` (the ring dim may be sharded) is written
    shard by shard: each device writes the rows of its ring shard below
    n, in place in its local shard, from ``new`` laid out as the buffer
    with its ring dim whole."""
    if not is_dtensor(buf):
        buf[i, :, :new.shape[1]] = new
        return buf
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pls, n = buf.device_mesh, buf.placements, new.shape[1]
    new_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim != 2
                   else Replicate() for p in pls)

    def local(buf_l, new_l):
        nc = buf_l.shape[2]
        c0 = _shard_offset(mesh, pls, 2, nc)
        lo, hi = min(max(c0, 0), n), min(c0 + nc, n)
        if hi > lo:
            buf_l[i, :, lo - c0:hi - c0] = new_l[:, lo:hi].to(buf_l.dtype)
        return buf_l

    local_map(local, out_placements=list(pls), in_placements=(pls, new_pl),
              device_mesh=mesh, redistribute_inputs=True)(buf, new)
    return buf


def _sharded_row_update(buf, new, slot):
    """``cache_row_update`` on a DTensor ``buf`` (B, C, ...) whose batch
    and ring dims may be sharded: each device writes the rows of its batch
    shard whose slot falls in its ring shard (an unchanged entry
    elsewhere), in place in its local shard; ``new`` (B, ...) is
    redistributed to the buffer's layout less its ring dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = buf.device_mesh
    pls = buf.placements
    new_pl = tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
                   and p.dim != 1 else Replicate() for p in pls)

    def local(buf_l, new_l, slot_g):
        nb, nc = buf_l.shape[:2]
        b0 = _shard_offset(mesh, pls, 0, nb)
        c0 = _shard_offset(mesh, pls, 1, nc)
        s = slot_g[b0:b0 + nb].long() - c0
        inside = ((s >= 0) & (s < nc)).reshape((nb,) + (1,) * (new_l.dim()
                                                              - 1))
        rows = torch.arange(nb, device=buf_l.device)
        s = s.clamp(0, nc - 1)
        buf_l[rows, s] = torch.where(inside, new_l.to(buf_l.dtype),
                                     buf_l[rows, s])
        return buf_l

    rep = (Replicate(),) * mesh.ndim
    local_map(local, out_placements=list(pls),
              in_placements=(pls, new_pl, rep),
              device_mesh=mesh, redistribute_inputs=True)(buf, new, slot)
    return buf


def decode_attention(q, k_cache, v_cache, valid_len):
    """Single-token attention over contiguous per-row caches. q: (B, H, D);
    caches: (B, C, KV, D); valid_len: (B,) lengths (0 = zeros) or one int
    for every row (cross-attention's encoder length). On a GPU every C
    goes through the decode kernel (no tile-multiple gate). An int length
    is filled on the device, so a captured step holds no host copy. On
    DTensors the lengths are laid out as the batch: an int fills each
    shard's own rows, a (B,) DTensor (a step's positions) is cut by
    ``per_head_shards``."""
    if is_dtensor(q):
        if isinstance(valid_len, int):
            return per_head_shards(functools.partial(
                decode_attention, valid_len=valid_len), q, k_cache, v_cache)
        return per_head_shards(ops.decode_attention, q, k_cache, v_cache,
                               valid_len)
    if isinstance(valid_len, int):
        lengths = torch.full((q.shape[0],), valid_len, dtype=torch.int32,
                             device=q.device)
    else:
        lengths = torch.broadcast_to(
            torch.as_tensor(valid_len, dtype=torch.int32,
                            device=q.device).reshape(-1),
            (q.shape[0],)).contiguous()
    return ops.decode_attention(q, k_cache, v_cache, lengths)


def paged_cache_update(buf, new, pages, slots):
    """Write ``new`` (B, 1, ...) IN PLACE into the paged pool ``buf``
    (P, page_size, ...) at physical page ``pages`` (B,) and in-page offset
    ``slots`` (B,). Live rows own disjoint pages; vacant rows all target
    the never-read null page 0, where duplicate writes are harmless."""
    buf[pages.long(), slots.long()] = new[:, 0].to(buf.dtype)
    return buf


def paged_decode_attention(q, k_pages, v_pages, block_tables, valid_len):
    """Single-token attention over a block-table paged cache. q: (B, H, D);
    pages: (P, page_size, KV, D); block_tables: (B, max_pages) int32;
    valid_len: (B,) int32 lengths (0 = zeros)."""
    return ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      valid_len)


def paged_chunk_attention(q_rows, k_pages, v_pages, k_rows, v_rows,
                          block_tables, hist_lens, seg_lens):
    """Incremental chunk attention: R new tokens per segment attend the
    segment's paged history plus the chunk's own K/V causally. Rows
    r >= seg_lens[s] are padding (callers discard them)."""
    return ops.paged_chunk_attention(q_rows, k_pages, v_pages, k_rows,
                                     v_rows, block_tables, hist_lens,
                                     seg_lens)


def decode_index(pos, cache, key):
    """Per-row write/read machinery of one decode step over either cache
    layout (``block_tables`` present = paged). pos: (B,) int32 positions;
    ``key``: the K leaf the layout is read from. Returns ``(update,
    attend, valid)``: ``update(buf, new)`` writes the step's (B, 1, ...)
    entries in place at each row's coordinates — (page, offset) when
    paged, ring row ``pos % C`` otherwise; ``attend(q, kc, vc, window=0)``
    runs decode attention against the updated buffer; ``valid`` is the
    (B,) lengths vector."""
    if "block_tables" in cache:
        tables = cache["block_tables"]
        page_size = cache[key].shape[2]
        max_pages = tables.shape[1]
        bidx = torch.arange(pos.shape[0], device=pos.device)
        # past-capacity clamp is belt-and-braces: the engine caps every
        # slot's budget at its page capacity (vacant rows sit at pos 0,
        # null page)
        page = tables[bidx, torch.clamp(pos // page_size, max=max_pages - 1)]
        slot = pos % page_size
        valid = torch.clamp(pos + 1, max=max_pages * page_size).to(
            torch.int32)

        def update(buf, new):
            return paged_cache_update(buf, new, page, slot)

        def attend(q, kc, vc, window: int = 0):
            if window:
                # a paged slot keeps its full history (pages never evict),
                # so a window would need page-level masking that is not
                # written; windowed configs stay on ring slots
                raise NotImplementedError(
                    "sliding-window attention over a paged cache")
            return paged_decode_attention(q, kc, vc, tables, valid)

        return update, attend, valid

    cache_len = cache[key].shape[2]
    slot = pos % cache_len if cache_len > 0 else torch.zeros_like(pos)
    valid = torch.clamp(pos + 1, max=cache_len).to(torch.int32)

    def update(buf, new):
        return cache_row_update(buf, new, slot)

    def attend(q, kc, vc, window: int = 0):
        # a ring slot's overwrite is its window: nothing more to mask
        return decode_attention(q, kc, vc, valid)

    return update, attend, valid


def carry_cache_meta(out, cache):
    """Carry the leaves a decode step only reads (``block_tables``) from
    the old cache into the new one."""
    if "block_tables" in cache:
        out["block_tables"] = cache["block_tables"]
    return out


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------
def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` of ``shape`` in float32 on
    the generator's device, U uniform on [tiny, 1) — what
    ``jax.random.gumbel`` draws from a key. Every sampled token of the port
    draws its noise here."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_k_top_p_filter(logits: torch.Tensor, *, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus to -1e30.
    ``top_k``/``top_p`` are Python values (one captured step per pair). The
    arg-max token is always kept, so a degenerate ``top_p`` can never mask
    the whole vocabulary."""
    if top_k and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass BEFORE them is < top_p
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).amin(-1, keepdim=True).to(logits.dtype)
        logits = logits.masked_fill(logits < thresh, -1e30)
    return logits


def sample_logits(generator: torch.Generator, logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Next tokens (B,) from (B, V) logits. ``temperature <= 0`` is the
    greedy arg-max; otherwise temperature-scaled top-k/top-p sampling by
    the Gumbel trick: the arg-max of ``gumbel_noise`` plus the filtered
    float32 logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, -1)
    lg = logits.float() / temperature
    lg = top_k_top_p_filter(lg, top_k=top_k, top_p=top_p)
    return torch.argmax(gumbel_noise(generator, lg.shape) + lg, -1)
