"""Llama-4 Scout 17B-active / 16-expert MoE (early-fusion multimodal LM).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048; 16 routed
experts top-1 + 1 shared expert per layer.  Pure full attention =>
long_500k is skipped (DESIGN.md §4).  109B total params => 2D (FSDP x TP)
weight sharding.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    period=(LayerSpec(moe=True),),
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    rope_theta=5e5,
    weight_sharding="fsdp_tp",
)
