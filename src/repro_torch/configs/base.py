"""Model configuration dataclass — a copy of the JAX package's
``ModelConfig`` (same fields, ``padded_vocab``, ``param_count`` and
``reduced()``), kept here so the port imports nothing of that package.

It drives model construction (``repro_torch.models.registry.build_model``)
and parameter counting. ``InputShape`` and ``INPUT_SHAPES`` are the JAX
package's four dry-run shapes (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation (arXiv id / model card)

    # transformer backbone ------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int                   # query heads; 0 => attention-free
    num_kv_heads: int
    d_ff: int                        # per-expert ffn width for MoE
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # attention flavour ----------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention; >0 = window size
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_nonparam

    # mixture-of-experts ---------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0

    # state-space (mamba2) --------------------------------------------------
    ssm_state: int = 0               # N — SSD state dimension
    ssm_head_dim: int = 64           # P — SSD head dim
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 128             # SSD chunk length
    ssm_conv_width: int = 4

    # hybrid (zamba2-style): one *shared* full-attention block applied
    # every ``attn_every`` mamba layers.
    attn_every: int = 0

    # encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame-embedding length
    learned_pos_emb: bool = False

    # misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ api
    @property
    def padded_vocab(self) -> int:
        """Vocab padded (Megatron-style) so the vocab dim always shards over
        a 16-way tensor-parallel axis; padded logit rows are masked to -inf
        in the unembedding. Already-divisible vocabs are left alone."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_encoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    # ---------------------------------------------------------- param count
    def param_count(self) -> int:
        """Exact dense parameter count of the model we construct."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += v * d                              # lm head
        norm_params = d if self.norm != "layernorm_nonparam" else 0
        if self.norm == "layernorm":
            norm_params *= 2                        # scale + bias

        def attn_params() -> int:
            p = d * (self.num_heads * hd)           # q
            p += 2 * d * (self.num_kv_heads * hd)   # k, v
            p += (self.num_heads * hd) * d          # o
            if self.qkv_bias:
                p += (self.num_heads + 2 * self.num_kv_heads) * hd
            return p

        def mlp_params(ff: int) -> int:
            return 3 * d * ff                       # gate, up, down

        if self.family == "ssm":
            # mamba2 block: in_proj (z,x,B,C,dt), conv, A, D, norm, out_proj
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ns + nh)        # in_proj
            per += self.ssm_conv_width * (di + 2 * ns)
            per += 2 * nh                           # A_log, D
            per += di                               # gated norm
            per += di * d                           # out_proj
            per += norm_params
            return n + self.num_layers * per
        if self.family == "hybrid":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ns + nh)
            per += self.ssm_conv_width * (di + 2 * ns)
            per += 2 * nh + di + di * d + norm_params
            total = n + self.num_layers * per
            # one shared attention block (+ its mlp)
            total += attn_params() + mlp_params(self.d_ff) + 2 * norm_params
            return total
        per = attn_params() + 2 * norm_params
        if self.num_experts:
            per += d * self.num_experts             # router
            per += self.num_experts * mlp_params(self.d_ff)
        else:
            per += mlp_params(self.d_ff)
        total = n + self.num_layers * per
        if self.has_encoder:
            # encoder layers: self-attn + mlp; decoder additionally has
            # cross-attn (already counted once per layer above? no — add).
            total += self.encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * norm_params)
            total += self.num_layers * attn_params()      # cross attention
            if self.learned_pos_emb:
                total += (self.encoder_seq + 32768) * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE uses experts_per_token)."""
        if not self.num_experts:
            return self.param_count()
        dense_like = dataclasses.replace(self, num_experts=0, experts_per_token=0)
        per_expert = 3 * self.d_model * self.d_ff
        n = dense_like.param_count() - self.num_layers * per_expert
        n += self.num_layers * (self.experts_per_token * per_expert
                                + self.d_model * self.num_experts)
        return n

    # ------------------------------------------------------------- variants
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, heads) if heads else 0
        # preserve GQA ratio flavour where possible
        if heads and self.num_kv_heads < self.num_heads:
            kv = max(1, heads // 2)
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64 if heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_seq else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
