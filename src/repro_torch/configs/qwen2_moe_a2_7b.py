"""Qwen1.5/2-MoE A2.7B: 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=151936.
60 % 16 != 0 => expert-internal d_ff TP fallback (DESIGN.md §5).
Full attention => long_500k skipped.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    period=(LayerSpec(moe=True),),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1e6,
)
