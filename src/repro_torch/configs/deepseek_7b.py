"""DeepSeek-7B [arXiv:2401.02954] — llama-arch, MHA (kv=32)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    source="arXiv:2401.02954",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
)
