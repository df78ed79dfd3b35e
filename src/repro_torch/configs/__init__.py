"""Architecture registry of the port: ``get_config`` resolves the
configurations the port serves so far (the dense main-path models and
the Mamba2 family)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mamba2_13b import CONFIG as _mamba2
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.qwen2_05b import CONFIG as _qwen2

ARCHS = {c.name: c for c in [_olmo, _qwen2, _mamba2]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
