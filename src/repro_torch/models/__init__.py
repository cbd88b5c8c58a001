"""Models of the port: config and the decoder-only stack (dense, windowed,
MoE, M-RoPE, RG-LRU and RWKV-6 layers)."""

from .config import (ATTN, GLOBAL_WINDOW, RGLRU, RWKV, LayerSpec, ModelConfig,
                     scale_down)
from .model import (cache_shapes, decode_step, forward, init, init_cache,
                    param_shapes, prefill)

__all__ = [
    "ATTN", "GLOBAL_WINDOW", "LayerSpec", "ModelConfig", "RGLRU", "RWKV",
    "cache_shapes", "decode_step", "forward", "init", "init_cache",
    "param_shapes", "prefill", "scale_down",
]
