"""Architecture registry of the port: ``get_config`` resolves the ten
configurations of the JAX package's zoo, in its order. The profiles and
the simulator plan over all ten; the model registry builds only the
families ported so far (``repro_torch.models.registry``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.granite_moe import CONFIG as _granite
from repro_torch.configs.mamba2_13b import CONFIG as _mamba2
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.phi35_moe import CONFIG as _phi35
from repro_torch.configs.qwen2_05b import CONFIG as _qwen2
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2

ARCHS = {
    c.name: c
    for c in [
        _olmo, _phi35, _yi, _zamba2, _qwen2,
        _deepseek, _whisper, _granite, _chameleon, _mamba2,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
