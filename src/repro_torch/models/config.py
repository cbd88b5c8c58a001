"""Model configuration (own copy of ``repro.models.config``).

One dataclass describes dense / MoE / hybrid (RG-LRU) / SSM (RWKV6) /
encoder-decoder / VLM backbones.  Layer stacks are expressed as a repeating
``period``: a tuple of :class:`LayerSpec` tiled ``n_layers//len`` times;
parameters of the same period position are stacked along a leading axis.
The port serves the decoder-only families; the other fields (the
encoder-decoder's, the TPU sharding hints) are kept so the dataclass stays
equal to the JAX one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

# layer mixer kinds
ATTN = "attn"          # softmax attention (causal/bidir/windowed via window)
RGLRU = "rglru"        # Griffin recurrent block (RG-LRU + conv1d)
RWKV = "rwkv"          # RWKV-6 time-mix (data-dependent decay)

GLOBAL_WINDOW = -1     # window sentinel: full attention


@dataclass(frozen=True)
class LayerSpec:
    kind: str = ATTN
    window: int = GLOBAL_WINDOW    # sliding-window size; -1 = full attention
    moe: bool = False              # MoE MLP instead of dense MLP


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    period: tuple = (LayerSpec(),)  # repeating layer pattern
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False                  # 3D multimodal RoPE (qwen2-vl)
    mrope_sections: tuple = (16, 24, 24)  # t/h/w splits of d_head/2
    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # per-expert hidden (0 -> d_ff)
    capacity_factor: float = 1.25
    # recurrent (RG-LRU / RWKV)
    lru_width: int = 0                   # 0 -> d_model
    conv1d_width: int = 4
    rwkv_head_size: int = 64
    # encoder-decoder
    encoder_layers: int = 0              # >0 => enc-dec model
    decoder_ratio: int = 4               # dec_len = seq_len // ratio
    # embeddings / housekeeping
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 256        # pad vocab for clean TP sharding
    dtype: str = "bfloat16"
    # distribution
    weight_sharding: str = "tp"          # "tp" | "fsdp_tp" | "fsdp_full"
    batch_sharding: str = "dp"           # "dp" | "full" (batch over all axes)
    moe_constraint: str = ""             # "" | "ep_model" | "ep_data" |
                                         # "tokens_data" -- explicit sharding
                                         # constraints on the MoE dispatch
                                         # buffers (perf hillclimb knob)
    rwkv_state_tp: bool = True           # shard the (dh) state axis over TP
                                         # (baseline; False = batch-only,
                                         # recurrence stays collective-free)
    moe_groups: int = 1                  # >1: per-group (DP-shard-local)
                                         # dispatch -- capacity per group,
                                         # no cross-shard sort/scatter
    kv_cache_dtype: str = ""             # "" (model dtype) | "int8"
                                         # (quantized KV, static scale)
    remat: bool = True
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    # dry-run instrumentation: XLA cost_analysis counts while-loop bodies
    # ONCE, so the dry-run compiles small unrolled variants to calibrate the
    # per-layer-group cost (see launch/dryrun.py)
    unroll_layers: bool = False
    unroll_q_chunks: bool = False

    # ---------------------------------------------------------------- derived
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return math.ceil(self.vocab / m) * m

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    @property
    def n_groups(self) -> int:
        """Number of full period repetitions (remainder layers go to the
        unrolled tail -- e.g. gemma3's 62 = 10*6 + 2)."""
        return self.n_layers // len(self.period)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.period)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def max_window(self) -> int:
        return max((s.window for s in self.period), default=GLOBAL_WINDOW)

    def full_attention_everywhere(self) -> bool:
        """True if every mixer is full softmax attention (=> long_500k skip)."""
        return all(s.kind == ATTN and s.window == GLOBAL_WINDOW
                   for s in self.period)

    def layer_specs(self) -> list[LayerSpec]:
        return list(self.period) * self.n_groups + list(self.period[: self.n_tail])

    # -- parameter count (for roofline MODEL_FLOPS = 6*N*D) -------------------
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        dense_mlp = 3 * d * self.d_ff
        ep = self.expert_d_ff
        total = 0
        for spec in self.layer_specs():
            if spec.kind == ATTN:
                total += attn
            elif spec.kind == RGLRU:
                w = self.lru_dim
                total += 2 * d * w + w * d + self.conv1d_width * w + 3 * w
            elif spec.kind == RWKV:
                total += 4 * d * d + d * d  # r,k,v,g,o (decay LoRAs are small)
            if spec.kind == RWKV:
                total += 2 * d * int(3.5 * d)  # channel-mix
            elif spec.moe:
                n_e = self.top_k if active_only else self.n_experts
                total += n_e * 3 * d * ep + d * self.n_experts
                total += self.n_shared_experts * 3 * d * ep
            else:
                total += dense_mlp
            total += 2 * d  # norms
        total += self.padded_vocab * d  # embed (tied)
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        if self.is_encdec:
            # encoder stack (self-attn + mlp) and decoder cross-attention
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            cross = self.n_layers * attn
            total += enc + cross
        return total


def _scale_sections(sections: tuple, d_half: int) -> tuple:
    """Rescale M-RoPE t/h/w sections to a smaller half-head-dim."""
    total = sum(sections)
    scaled = [max(1, s * d_half // total) for s in sections]
    scaled[0] += d_half - sum(scaled)
    return tuple(scaled)


def scale_down(cfg: ModelConfig, layers: int = 2, d_model: int = 64,
               n_heads: int = 4, n_kv_heads: int | None = None,
               d_ff: int = 128, vocab: int = 512) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period_len = len(cfg.period)
    n_layers = max(layers, period_len)
    n_layers -= n_layers % period_len
    n_kv = n_kv_heads if n_kv_heads is not None else min(cfg.n_kv_heads, n_heads)
    return replace(
        cfg,
        n_layers=n_layers or period_len,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=max(1, n_kv),
        d_head=d_model // n_heads,
        d_ff=d_ff,
        vocab=vocab,
        vocab_pad_multiple=16,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else 1,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_d_ff=d_ff if cfg.n_experts else 0,
        lru_width=d_model if cfg.lru_width else 0,
        rwkv_head_size=d_model // n_heads,
        mrope_sections=_scale_sections(cfg.mrope_sections,
                                       (d_model // n_heads) // 2)
        if cfg.mrope else cfg.mrope_sections,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        period=tuple(
            replace(s, window=min(s.window, 64) if s.window > 0 else s.window)
            for s in cfg.period
        ),
        weight_sharding="tp",
        remat=False,
    )
