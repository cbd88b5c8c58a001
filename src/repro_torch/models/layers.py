"""Building blocks of the decoder families (port of
``repro.models.layers``): norms, RoPE, attention, the SwiGLU MLP, the
RG-LRU recurrent block (Griffin / RecurrentGemma) and the RWKV-6 time and
channel mix.

Functions take explicit parameter dicts under the JAX tree's names, so the
same weights drive both packages.  The kernels of ``kernels.ops`` carry the
hot loops: ``flash_attention`` for a prompt, ``decode_attention`` for one
new token over a cache, ``rglru_scan`` for the RG-LRU recurrence and
``rwkv6_scan`` for the RWKV-6 one.  The JAX model runs jnp code in those
places (a chunked attention, ``lax.scan`` recurrences) and leaves its
Pallas kernels aside; the port's kernels compute the Pallas kernels'
function.  Where the two differ: fully masked attention rows give 0 in
both; the Pallas recurrences carry their state in float32 (the JAX model's
RG-LRU rounds h to the model dtype every step, its time mix rounds
k v^T and S + u k v^T before the product with r), which agrees exactly in
float32 and within bfloat16 rounding otherwise.  The projections, MLPs and
the unembedding are plain matrix products.
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


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm of the RWKV time-mix output, x (..., H, dh); the
    statistics in float32, the variance without Bessel's correction."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale


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
    if not causal:
        raise NotImplementedError(
            "bidirectional decode over a cache is not ported yet "
            "(ROADMAP.md, queue 1)")
    if 0 < window < k.shape[1]:
        # the model's windowed caches hold at most ``window`` entries (a
        # ring), so every valid entry lies in the window
        raise NotImplementedError(
            f"decode over a cache of {k.shape[1]} entries with window "
            f"{window}: only a ring of at most the window is ported "
            "(ROADMAP.md, queue 1)")
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


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------
def rglru_params_shapes(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_dim
    return {
        "w_x": (d, w), "w_y": (d, w), "w_out": (w, d),
        "conv_w": (cfg.conv1d_width, w), "conv_b": (w,),
        "w_rg": (w, w), "b_rg": (w,),       # recurrence gate
        "w_ig": (w, w), "b_ig": (w,),       # input gate
        "lambda": (w,),                      # per-channel decay parameter
    }


def _rglru_coeffs(p: dict, x: torch.Tensor, c: float = 8.0):
    """x (..., w) -> (a, gated input), both in x's dtype: the decay and the
    input of each step."""
    r = torch.sigmoid(x @ p["w_rg"] + p["b_rg"])
    i = torch.sigmoid(x @ p["w_ig"] + p["b_ig"])
    log_a = -c * F.softplus(p["lambda"]) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a.to(x.dtype), beta.to(x.dtype) * i * x


def rglru_block(p: dict, x: torch.Tensor, cfg, state: dict, *,
                force=None):
    """Griffin recurrent block: a gelu gate branch and a branch of causal
    conv1d then RG-LRU (``ops.rglru_scan``).  ``state``: ``h`` (B, w) and
    ``conv`` (B, width - 1, w), the carried context (zeros for a fresh
    prompt).  Returns (out (B, S, d), new state)."""
    S = x.shape[1]
    width = cfg.conv1d_width
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    xb = x @ p["w_x"]
    xc = torch.cat([state["conv"], xb], dim=1)          # (B, S+width-1, w)
    kernel = p["conv_w"]
    conv = sum(xc[:, i:i + S] * kernel[i] for i in range(width))
    conv = conv + p["conv_b"]
    a, gx = _rglru_coeffs(p, conv)
    hs, hT = ops.rglru_scan(a.contiguous(), gx.contiguous(),
                            state["h"].contiguous(), force=force)
    out = (gate * hs) @ p["w_out"]
    return out, {"h": hT, "conv": xc[:, S:] if width > 1 else state["conv"]}


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch") time mix + channel mix
# ---------------------------------------------------------------------------
RWKV_LORA = 32


def rwkv_params_shapes(cfg) -> dict:
    d = cfg.d_model
    h = cfg.rwkv_heads
    dh = cfg.rwkv_head_size
    f = int(3.5 * d)
    return {
        # time mix
        "mu": (5, d),                       # static token-shift mixes
        "maa_w1": (d, 5 * RWKV_LORA), "maa_w2": (5, RWKV_LORA, d),
        "w0": (d,), "wd_w1": (d, RWKV_LORA * 2), "wd_w2": (RWKV_LORA * 2, d),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
        "u": (h, dh),                       # bonus of the current token
        "ln_x": (d,),
        # channel mix
        "cm_mu_k": (d,), "cm_mu_r": (d,),
        "cm_wk": (d, f), "cm_wv": (f, d), "cm_wr": (d, d),
    }


def _rwkv_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous step at each position.  x (B, S, d),
    x_prev (B, d)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg, state: dict, *,
                  force=None):
    """``state``: ``shift`` (B, d) and ``wkv`` (B, H, dh, dh) float32.
    Returns (out (B, S, d), {"shift", "wkv"}); the recurrence goes through
    ``ops.rwkv6_scan``."""
    B, S, d = x.shape
    H, dh = cfg.rwkv_heads, cfg.rwkv_head_size
    dx = _rwkv_shift(x, state["shift"]) - x
    # data-dependent token-shift mixing: five LoRA'd mixes, in the order
    # the JAX model unpacks them
    xxx = x + dx * p["mu"][0]
    lora = torch.tanh(xxx @ p["maa_w1"]).reshape(B, S, 5, RWKV_LORA)
    mixes = torch.einsum("bsfr,frd->bsfd", lora, p["maa_w2"]) + p["mu"]
    xw, xk, xv, xr, xg = (x + dx * mixes[:, :, i] for i in range(5))

    # data-dependent per-channel decay in (0, 1), float32
    ww = torch.tanh(xw @ p["wd_w1"]) @ p["wd_w2"]
    w = torch.exp(-torch.exp((p["w0"] + ww).float()))

    r = (xr @ p["wr"]).reshape(B, S, H, dh)
    k = (xk @ p["wk"]).reshape(B, S, H, dh)
    v = (xv @ p["wv"]).reshape(B, S, H, dh)
    g = F.silu(xg @ p["wg"])
    out, wkv = ops.rwkv6_scan(r.contiguous(), k.contiguous(), v.contiguous(),
                              w.reshape(B, S, H, dh).contiguous(), p["u"],
                              state["wkv"], force=force)
    out = group_norm_heads(out, 1.0 + p["ln_x"].reshape(H, dh))
    out = (out.reshape(B, S, d) * g) @ p["wo"]
    return out, {"shift": x[:, -1], "wkv": wkv}


def rwkv_channel_mix(p: dict, x: torch.Tensor, state: dict):
    """``state``: ``cm_shift`` (B, d).  Returns (out, {"cm_shift"})."""
    dx = _rwkv_shift(x, state["cm_shift"]) - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ p["cm_wk"]))
    out = torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])
    return out, {"cm_shift": x[:, -1]}
