"""Assigned-architecture configs (public-literature sources; see each file).

Mirrors `src/repro/configs/__init__.py`; every file here is a copy of its
namesake there with the imports pointed at `repro_torch`."""
from repro_torch.configs.base import (ModelConfig, HeadConfig, ServeConfig,
                                ShapeConfig, LM_SHAPES, shape_by_name)

from repro_torch.configs.qwen2_moe_a2p7b import CONFIG as qwen2_moe_a2p7b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m
from repro_torch.configs.llama3_2_1b import CONFIG as llama3_2_1b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.starcoder2_15b import CONFIG as starcoder2_15b
from repro_torch.configs.llama3_2_vision_11b import CONFIG as llama3_2_vision_11b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.paper_lm import CONFIG as paper_lm

ARCHS = {
    c.name: c for c in (
        qwen2_moe_a2p7b, granite_moe_1b_a400m, zamba2_7b, smollm_135m,
        llama3_2_1b, qwen3_14b, starcoder2_15b, llama3_2_vision_11b,
        whisper_tiny, mamba2_370m, paper_lm)
}


def get_config(name: str) -> ModelConfig:
    name = name.replace("_", "-")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
