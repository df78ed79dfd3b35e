"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

16 experts, top-2 routing, GQA kv=8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    norm="layernorm",
)
