"""Granite-MoE 3B (800M active) [hf:ibm-granite/granite-3.0-1b-a400m-base].

40 experts, top-8 routing, narrow (d_ff=512) experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
)
