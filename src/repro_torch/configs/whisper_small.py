"""Whisper-small [arXiv:2212.04356] — enc-dec transformer backbone.

The mel-spectrogram + conv frontend is a STUB per the brief: ``input_specs``
provides precomputed frame embeddings of shape (batch, encoder_seq, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,             # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    encoder_layers=12,
    encoder_seq=1536,   # 1500 mel-frames padded to a 512-divisible stub length
    learned_pos_emb=True,
    tie_embeddings=True,
)
