"""Qwen3-1.7B: dense GQA with qk-norm.

[hf:Qwen/Qwen3-1.7B; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
Full attention => long_500k skipped.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    period=(LayerSpec(),),
    qk_norm=True,
    rope_theta=1e6,
)
