"""Plain float32 reference of Mamba2-1.3B (arXiv:2405.21060), from the
published description of the Mamba2 block: RMSNorm, an input projection
to (z, x, B, C, dt), a causal depthwise conv of width 4 over (x, B, C)
with SiLU, dt through softplus with its bias, the SSD recurrence with
A = -exp(A_log) per head (one group of B and C), the skip D, a gated
RMSNorm (y * silu(z), normalised over the inner width), the output
projection, and the unembedding tied to the embedding.

The SSD is the paper's chunked form of the exact recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t: within a chunk
the quadratic form, between chunks the states. Plain PyTorch over the
whole sequence; it imports nothing of the program. It works out again what
the program derives from the weights (A from A_log, the concatenated conv
taps, float32 copies). ``mm`` is every product of a weight and an
activation: plain float32 for the reference, a lower precision for the
control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from harness.weights import Leaf

CHUNK = 256


def layout(cfg):
    """The parameters: names, shapes and how each is drawn (matrices
    normal with std ``init_std``, 0.02 unless the configuration says)."""
    std = cfg.get("init_std", 0.02)
    d, n, nl = cfg["d_model"], cfg["ssm_state"], cfg["num_layers"]
    di = cfg["ssm_expand"] * d
    h, w = di // cfg["ssm_head_dim"], cfg["ssm_conv_width"]
    return {
        "embed": {"embedding": Leaf((cfg["padded_vocab"], d), std=std)},
        "layers": {
            "norm": {"scale": Leaf((nl, d), "ones")},
            "wz": Leaf((nl, d, di), std=std), "wx": Leaf((nl, d, di), std=std),
            "wB": Leaf((nl, d, n), std=std), "wC": Leaf((nl, d, n), std=std),
            "wdt": Leaf((nl, d, h), std=std),
            "dt_bias": Leaf((nl, h), "dt_bias", lo=0.001, hi=0.1),
            "A_log": Leaf((nl, h), "a_log", lo=1.0, hi=16.0),
            "D": Leaf((nl, h), "ones"),
            "conv_x": Leaf((nl, w, di), std=0.2),
            "conv_B": Leaf((nl, w, n), std=0.2),
            "conv_C": Leaf((nl, w, n), std=0.2),
            "gate_norm": {"scale": Leaf((nl, di), "ones")},
            "wo": Leaf((nl, di, d), std=std),
        },
        "final_norm": {"scale": Leaf((d,), "ones")},
    }


def plain_mm(a, b):
    return a @ b


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def causal_conv(x, w):
    """Depthwise causal conv. x: (S, C); w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[i:i + x.shape[0]] * w[i] for i in range(width))


def segsum(x):
    """x: (..., T) -> (..., T, T): out[i, j] = sum of x[j+1..i] for
    j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, dt, a, b, c, chunk=CHUNK):
    """x: (S, H, P); dt: (S, H); a: (H,); b, c: (S, N) -> y (S, H, P)."""
    s, h, p = x.shape
    pad = (-s) % chunk
    xd = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    ad = F.pad(dt * a, (0, 0, 0, pad))                 # exp(0) = 1 pads
    b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xd = xd.view(nc, chunk, h, p)
    ad = ad.view(nc, chunk, h).permute(2, 0, 1)       # (H, NC, L)
    b, c = b.view(nc, chunk, -1), c.view(nc, chunk, -1)
    a_cs = torch.cumsum(ad, dim=-1)
    # within each chunk: y_i = sum_{j<=i} (C_i . B_j) exp(a_i..j) x_j dt_j
    cb = torch.einsum("cln,csn->cls", c, b)
    decay = torch.exp(segsum(ad))                     # (H, NC, L, L)
    y = torch.einsum("hcls,cshp->clhp", decay * cb[None], xd)
    # each chunk's final state, then the states carried across chunks
    states = torch.einsum("csn,hcs,cshp->chpn", b,
                          torch.exp(a_cs[..., -1:] - a_cs), xd)
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    carry = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))  # (H, C+1, C+1)
    states = torch.einsum("hzc,chpn->zhpn", carry, states)[:-1]
    y = y + torch.einsum("cln,chpn,hcl->clhp", c, states, torch.exp(a_cs))
    return y.reshape(nc * chunk, h, p)[:s]


@torch.no_grad()
def logits(w, cfg, tokens, mm=plain_mm):
    """tokens: (S,) -> float32 logits (S, vocab) at every position."""
    d, n, eps = cfg["d_model"], cfg["ssm_state"], cfg["norm_eps"]
    di = cfg["ssm_expand"] * d
    p = cfg["ssm_head_dim"]
    h = di // p
    s = tokens.shape[0]
    emb = w["embed"]["embedding"]
    x = emb[tokens].float()
    lw = w["layers"]
    for i in range(cfg["num_layers"]):
        hn = rms_norm(x, lw["norm"]["scale"][i].float(), eps)
        z = mm(hn, lw["wz"][i].float())
        xbc = torch.cat([mm(hn, lw["wx"][i].float()),
                         mm(hn, lw["wB"][i].float()),
                         mm(hn, lw["wC"][i].float())], dim=-1)
        dt = F.softplus(mm(hn, lw["wdt"][i].float())
                        + lw["dt_bias"][i].float())
        taps = torch.cat([lw["conv_x"][i], lw["conv_B"][i],
                          lw["conv_C"][i]], dim=-1).float()
        xbc = F.silu(causal_conv(xbc, taps))
        xs, b, c = torch.split(xbc, [di, n, n], dim=-1)
        xs = xs.reshape(s, h, p)
        a = -torch.exp(lw["A_log"][i].float())
        y = ssd(xs, dt, a, b, c)
        y = y + xs * lw["D"][i].float()[None, :, None]
        g = y.reshape(s, di) * F.silu(z)
        g = rms_norm(g, lw["gate_norm"]["scale"][i].float(), eps)
        x = x + mm(g, lw["wo"][i].float())
    x = rms_norm(x, w["final_norm"]["scale"].float(), eps)
    return mm(x, emb.float().T)[:, :cfg["vocab_size"]]
