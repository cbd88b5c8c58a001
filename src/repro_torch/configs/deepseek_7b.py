"""DeepSeek-LLM 7B: llama-architecture dense MHA.

[arXiv:2401.02954; hf]
30L d_model=4096 32H (kv=32, MHA) d_ff=11008 vocab=102400.
Full attention => long_500k skipped.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    period=(LayerSpec(),),
    rope_theta=1e4,
    tie_embeddings=False,
)
