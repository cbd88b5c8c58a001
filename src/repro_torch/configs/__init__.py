"""Architecture registry of the port: ``get_config(arch_id)``.

Own copies of the JAX package's configurations for the decoder-only
families: the dense full-attention ones, gemma3_27b (5 local : 1 global
windowed attention), the mixture-of-experts qwen2_moe_a2_7b and
llama4_scout_17b_a16e, the M-RoPE qwen2_vl_7b, the RG-LRU hybrid
recurrentgemma_9b and the RWKV-6 rwkv6_3b.  The encoder-decoder family of
``repro.configs`` needs modules the port does not have yet, and
``get_config`` names the ROADMAP item that brings it.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ["qwen3_1_7b", "deepseek_7b", "qwen2_5_14b", "gemma3_27b",
         "qwen2_moe_a2_7b", "llama4_scout_17b_a16e", "qwen2_vl_7b",
         "recurrentgemma_9b", "rwkv6_3b"]

# dashed aliases as the JAX registry lists them
ALIASES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "gemma3-27b": "gemma3_27b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-7b": "deepseek_7b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

# families not ported yet -> the ROADMAP item (queue 1 of ROADMAP.md)
NOT_PORTED = {
    "seamless_m4t_large_v2": "encoder-decoder models",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it needs {NOT_PORTED[mod_name]} "
            "(ROADMAP.md, queue 1)")
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port serves "
                         f"{ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
