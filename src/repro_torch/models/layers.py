"""Building blocks of the dense attention families (port of
``repro.models.layers``).

Functions take explicit parameter dicts under the JAX tree's names, so the
same weights drive both packages.  Attention goes through the port's
kernels (``kernels.ops``): ``flash_attention`` for a prompt,
``decode_attention`` for one new token over a cache.  The JAX model runs a
chunked jnp attention here and leaves its Pallas kernels aside; the port's
kernels compute the same function (fully masked rows give 0 in both).  The
projections, the MLP and the unembedding are plain matrix products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in the ``(1 + scale)`` form; the variance in float32."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + scale)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def _rope_angles(positions: torch.Tensor, d_half: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, d_half), float32."""
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=positions.device) / d_half)
    return positions[..., None].float() * freqs


def rope_cos_sin(positions: torch.Tensor, d_half: int, theta: float,
                 dtype: torch.dtype):
    """cos and sin of the angles, (B, S, 1, d_half), cast to ``dtype``."""
    ang = _rope_angles(positions, d_half, theta)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               cos_sin=None) -> torch.Tensor:
    """x: (B, S, H, dh), positions: (B, S).  ``cos_sin`` from
    ``rope_cos_sin`` saves recomputing the angles for every layer."""
    d_half = x.shape[-1] // 2
    cos, sin = cos_sin or rope_cos_sin(positions, d_half, theta, x.dtype)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention(q, k, v, lengths=None, *, causal=True, window=-1,
              softmax_scale=None, force=None):
    """GQA attention through the port's kernels.

    Without ``lengths``: q (B, Sq, Hq, dh) over k / v (B, Sk, Hkv, dh) with
    suffix-aligned positions -> ``ops.flash_attention``.  With ``lengths``
    (B,): q (B, 1, Hq, dh) is one new token over the first ``lengths[b]``
    entries of a cache k / v -> ``ops.decode_attention``.  Returns
    (B, Sq, Hq, dh).  ``force`` goes to the dispatch (``"ref"``: the plain
    version)."""
    if lengths is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale, force=force)
    if q.shape[1] != 1:
        raise ValueError(f"decode attention takes one query, got "
                         f"{q.shape[1]}")
    if window > 0 or not causal:
        raise NotImplementedError(
            "windowed or bidirectional decode over a cache is not ported "
            "yet (ROADMAP.md, queue 1: windowed ring-buffer decode)")
    out = ops.decode_attention(q[:, 0], k, v, lengths,
                               softmax_scale=softmax_scale, force=force)
    return out[:, None]


# ---------------------------------------------------------------------------
# attention layer (projections + qk-norm + rope)
# ---------------------------------------------------------------------------
def attn_params_shapes(cfg, cross: bool = False) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    shapes = {
        "wq": (d, cfg.n_heads * dh),
        "wk": (d, cfg.n_kv_heads * dh),
        "wv": (d, cfg.n_kv_heads * dh),
        "wo": (cfg.n_heads * dh, d),
    }
    if cfg.qkv_bias and not cross:
        shapes |= {"bq": (cfg.n_heads * dh,), "bk": (cfg.n_kv_heads * dh,),
                   "bv": (cfg.n_kv_heads * dh,)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (dh,), "k_norm": (dh,)}
    return shapes


def attn_project_qkv(p: dict, x: torch.Tensor, cfg, positions,
                     rope: bool = True, cos_sin=None):
    """q (B, S, Hq, dh) and k, v (B, S, Hkv, dh): projections, bias,
    qk-norm and RoPE (M-RoPE is not ported)."""
    B, S, _ = x.shape
    dh = cfg.head_dim

    def proj(w, b, heads):
        y = x @ p[w]
        if b in p:
            y = y + p[b]
        return y.reshape(B, S, heads, dh)

    q = proj("wq", "bq", cfg.n_heads)
    k = proj("wk", "bk", cfg.n_kv_heads)
    v = proj("wv", "bv", cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:
        if cfg.mrope:
            raise NotImplementedError(
                "M-RoPE is not ported yet (ROADMAP.md, queue 1: M-RoPE)")
        q = apply_rope(q, positions, cfg.rope_theta, cos_sin)
        k = apply_rope(k, positions, cfg.rope_theta, cos_sin)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_params_shapes(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
