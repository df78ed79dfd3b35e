"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM.

VQ image tokens live in the shared 65536 vocab, so the backbone is a plain
dense decoder; the VQ-GAN image tokenizer is a STUB frontend per the brief.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    norm="layernorm",
)
