"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

81 mamba2 layers; one *shared* (weight-tied) full-attention block applied
every ``attn_every`` layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
)
