"""Qwen2.5-14B: dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-14B; hf]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
Full attention => long_500k skipped.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    period=(LayerSpec(),),
    qkv_bias=True,
    rope_theta=1e6,
)
