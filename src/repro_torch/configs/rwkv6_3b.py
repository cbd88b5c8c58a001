"""RWKV-6 "Finch" 3B: attention-free, data-dependent decay.

[arXiv:2404.05892; hf]
32L d_model=2560 d_ff~=8960 (3.5x) vocab=65536, head_size=64 (40 heads).
Constant-size state (O(1) decode state).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, RWKV

CONFIG = ModelConfig(
    name="rwkv6-3b",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    period=(LayerSpec(kind=RWKV),),
    rwkv_head_size=64,
)
