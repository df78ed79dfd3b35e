"""Plain float32 reference of OLMo-1B (arXiv:2402.00838), from the
published description: a pre-norm decoder with non-parametric layer norm,
rotary embeddings (half split, theta 10000) on queries and keys, causal
multi-head attention, a SwiGLU feed-forward block, and the unembedding
tied to the embedding.

Plain PyTorch over the whole sequence, no cache and no batching; it
imports nothing of the program. ``logits`` takes the parameters as the
nested dict the benchmark draws (``layout``: every layer's leaf stacked
on a leading axis) and returns float32 logits at every position.
``mm`` is every product of two operands: plain float32 for the
reference, a lower precision for the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness.weights import Leaf


def layout(cfg):
    """The parameters: names, shapes and how each is drawn (matrices
    normal with std ``init_std``, 0.02 unless the configuration says)."""
    std = cfg.get("init_std", 0.02)
    d, h, hd = cfg["d_model"], cfg["num_heads"], cfg["head_dim"]
    kv, ff, n = cfg["num_kv_heads"], cfg["d_ff"], cfg["num_layers"]
    return {
        "embed": {"embedding": Leaf((cfg["padded_vocab"], d), std=std)},
        "layers": {
            "ln1": {}, "ln2": {},
            "attn": {"wq": Leaf((n, d, h, hd), std=std),
                     "wk": Leaf((n, d, kv, hd), std=std),
                     "wv": Leaf((n, d, kv, hd), std=std),
                     "wo": Leaf((n, h, hd, d), std=std)},
            "mlp": {"wi_gate": Leaf((n, d, ff), std=std),
                    "wi_up": Leaf((n, d, ff), std=std),
                    "wo": Leaf((n, ff, d), std=std)},
        },
        "final_norm": {},
    }


def plain_mm(a, b):
    return a @ b


def layer_norm(x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rope(x, theta):
    """x: (S, H, D) at positions 0..S-1."""
    s, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                       device=x.device) * 2.0 / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm, heads_per_block: int = 4):
    """Causal softmax attention. q: (S, H, D); k, v: (S, KV, D)."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, h, heads_per_block):
        sl = slice(h0, h0 + heads_per_block)
        qh, kh, vh = (t[:, sl].transpose(0, 1) for t in (q, k, v))
        scores = mm(qh, kh.transpose(1, 2)) / math.sqrt(d)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, sl] = mm(p, vh).transpose(0, 1)
    return out


@torch.no_grad()
def logits(w, cfg, tokens, mm=plain_mm):
    """tokens: (S,) -> float32 logits (S, vocab) at every position."""
    d, h, hd = cfg["d_model"], cfg["num_heads"], cfg["head_dim"]
    kv, eps, theta = cfg["num_kv_heads"], cfg["norm_eps"], cfg["rope_theta"]
    s = tokens.shape[0]
    emb = w["embed"]["embedding"]
    x = emb[tokens].float()
    att, mlp = w["layers"]["attn"], w["layers"]["mlp"]
    for i in range(cfg["num_layers"]):
        hn = layer_norm(x, eps)
        q = mm(hn, att["wq"][i].float().reshape(d, h * hd)).view(s, h, hd)
        k = mm(hn, att["wk"][i].float().reshape(d, kv * hd)).view(s, kv, hd)
        v = mm(hn, att["wv"][i].float().reshape(d, kv * hd)).view(s, kv, hd)
        o = attention(rope(q, theta), rope(k, theta), v, mm)
        x = x + mm(o.reshape(s, h * hd), att["wo"][i].float().reshape(
            h * hd, d))
        hn = layer_norm(x, eps)
        g = mm(hn, mlp["wi_gate"][i].float())
        u = mm(hn, mlp["wi_up"][i].float())
        x = x + mm(F.silu(g) * u, mlp["wo"][i].float())
    x = layer_norm(x, eps)
    return mm(x, emb.float().T)[:, :cfg["vocab_size"]]
