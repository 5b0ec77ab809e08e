"""Architecture registry: the 10 assigned configs.

A copy of ``repro.configs``'s registry (the port imports nothing of the
JAX package).  ``get_config(arch_id)`` returns the full-scale config;
``.smoke()`` gives the reduced same-family config used by CPU tests.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "whisper_base",
    "llama32_vision_90b",
    "qwen2_0_5b",
    "chatglm3_6b",
    "stablelm_3b",
    "yi_6b",
    "grok1_314b",
    "granite_moe_3b",
    "zamba2_2_7b",
    "falcon_mamba_7b",
]

# CLI aliases (--arch accepts either form)
ALIASES = {
    "whisper-base": "whisper_base",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "qwen2-0.5b": "qwen2_0_5b",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-3b": "stablelm_3b",
    "yi-6b": "yi_6b",
    "grok-1-314b": "grok1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = ALIASES.get(arch_id, arch_id).replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG
