"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427; unverified]
38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
38 = 12 * (rec, rec, attn) + tail (rec, rec).  Constant-size recurrent
state + bounded window KV.
"""

from repro_torch.models.config import ATTN, LayerSpec, ModelConfig, RGLRU

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    period=(
        LayerSpec(kind=RGLRU),
        LayerSpec(kind=RGLRU),
        LayerSpec(kind=ATTN, window=2048),
    ),
    lru_width=4096,
    conv1d_width=4,
    rope_theta=1e4,
)
