"""Architecture registry of the port: ``get_config`` resolves the ten
configurations of the JAX package's zoo, in its order, by name or by the
JAX package's aliases. The profiles and
the simulator plan over all ten; the model registry builds only the
families ported so far (``repro_torch.models.registry``)."""
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
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

# convenience aliases (filesystem-safe ids)
ALIASES = {
    "olmo-1b": "olmo-1b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "yi-9b": "yi-9b",
    "zamba2-7b": "zamba2-7b",
    "qwen2-0.5b": "qwen2-0.5b",
    "deepseek-7b": "deepseek-7b",
    "whisper-small": "whisper-small",
    "granite-moe": "granite-moe-3b-a800m",
    "chameleon-34b": "chameleon-34b",
    "mamba2-1.3b": "mamba2-1.3b",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = [
    "ARCHS", "ALIASES", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "get_config", "get_shape",
]
