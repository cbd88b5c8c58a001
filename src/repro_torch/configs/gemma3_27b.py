"""Gemma-3 27B: dense, 5 local : 1 global attention, 128k context.

[hf:google/gemma-3-*; unverified]
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, qk-norm,
window=1024 for local layers.  62 = 10*(5 local + 1 global) + 2 local
tail.  5/6 of layers have bounded KV => long_500k RUNS (global layers
hold the full 512k KV, sequence-sharded).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec(window=1024)
_GLOBAL = LayerSpec(window=-1)

CONFIG = ModelConfig(
    name="gemma3-27b",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262144,
    period=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    qk_norm=True,
    rope_theta=1e6,
)
