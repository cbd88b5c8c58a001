"""Qwen2-VL 7B language backbone with M-RoPE.

[arXiv:2409.12191; hf]
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision
frontend (dynamic-resolution ViT) is a STUB: input_specs() provides
3D position ids (t/h/w) and precomputed patch embeddings.  Full
attention => long_500k skipped.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    period=(LayerSpec(),),
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
)
