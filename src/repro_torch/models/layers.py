"""Building blocks of the decoder families (port of
``repro.models.layers``): norms, RoPE and M-RoPE, attention, the SwiGLU
MLP, the mixture of experts, the RG-LRU recurrent block (Griffin /
RecurrentGemma) and the RWKV-6 time and channel mix.

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
the unembedding, and the experts' products, are plain matrix products,
as the JAX model leaves them to XLA.
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
def _rope_angles(positions: torch.Tensor, d_half: int, theta: float,
                 sections: tuple | None = None) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, d_half), float32.  With
    ``sections`` (M-RoPE), positions (3, ..., S) for (t, h, w): the rotary
    dimension is split into ``sections`` (summing to d_half), each part
    rotated by its own stream at the frequencies of its indices."""
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=positions.device) / d_half)
    if sections is None:
        return positions[..., None].float() * freqs
    if sum(sections) != d_half or positions.shape[0] != len(sections):
        raise ValueError(f"M-RoPE sections {sections} over d_half {d_half} "
                         f"and positions {tuple(positions.shape)}")
    parts, off = [], 0
    for sec, pos in zip(sections, positions):
        parts.append(pos[..., None].float() * freqs[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def rope_sections(cfg) -> tuple | None:
    """The M-RoPE sections of ``cfg``, or None for plain RoPE."""
    return tuple(cfg.mrope_sections) if cfg.mrope else None


def rope_cos_sin(positions: torch.Tensor, d_half: int, theta: float,
                 dtype: torch.dtype, sections: tuple | None = None):
    """cos and sin of the angles, (B, S, 1, d_half), cast to ``dtype``;
    positions (B, S), or (3, B, S) with M-RoPE ``sections``."""
    ang = _rope_angles(positions, d_half, theta, sections)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def _rotate(x: torch.Tensor, cos_sin) -> torch.Tensor:
    d_half = x.shape[-1] // 2
    cos, sin = cos_sin
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               cos_sin=None) -> torch.Tensor:
    """x: (B, S, H, dh), positions: (B, S).  ``cos_sin`` from
    ``rope_cos_sin`` saves recomputing the angles for every layer."""
    return _rotate(x, cos_sin or rope_cos_sin(positions, x.shape[-1] // 2,
                                              theta, x.dtype))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple,
                theta: float = 1e6, cos_sin=None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, H, dh), positions: (3, B, S)
    for (t, h, w); the rotary dimension is split into ``sections`` (summing
    to dh / 2), each rotated by its own positional stream.  With the three
    streams equal it is ``apply_rope``."""
    return _rotate(x, cos_sin or rope_cos_sin(
        positions, x.shape[-1] // 2, theta, x.dtype, tuple(sections)))


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
    qk-norm and RoPE (M-RoPE with ``cfg.mrope``, positions (3, B, S))."""
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
        cos_sin = cos_sin or rope_cos_sin(positions, dh // 2, cfg.rope_theta,
                                          q.dtype, rope_sections(cfg))
        q, k = _rotate(q, cos_sin), _rotate(k, cos_sin)
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
# Mixture of Experts (capacity dispatch sorted by expert)
# ---------------------------------------------------------------------------
def moe_params_shapes(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    shapes = {
        "router": (d, e),
        "e_gate": (e, d, f),
        "e_up": (e, d, f),
        "e_down": (e, f, d),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        shapes |= {"s_gate": (d, fs), "s_up": (d, fs), "s_down": (fs, d)}
    return shapes


def moe_route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """The router of ``moe_mlp``: a float32 softmax over the experts of each
    of the T tokens of ``xt`` (T, d), the k largest gates (the lower expert
    first on a tie, as ``lax.top_k``) renormalised.  Returns (weights (T,
    k) float32, experts (T, k)).  ``moe_mlp`` looks it up here at each
    call, so a check can record or impose the routing."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    # a stable descending sort keeps equal gates in expert order
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    return top_w / top_w.sum(-1, keepdim=True), top_i


def moe_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Top-k routed experts with capacity, as the JAX model dispatches
    them: each token's k experts and weights (``moe_route``), the (token,
    choice) pairs sorted stably by expert, the first ``cap = max(1,
    int(capacity_factor T k / E))`` of each expert kept (the rest go to an
    overflow row and count 0), every expert's (cap, d) rows through its
    SwiGLU, and the weighted sum; then the shared experts.

    Nothing here reads a value on the host, so a decode step with MoE
    layers can be captured in a CUDA graph: the expert counts are a
    ``scatter_add_`` into E zeros, and each token's k contributions are
    put back in choice order and summed there, so the result does not
    depend on the order of atomic adds.  ``moe_constraint`` (a TPU
    sharding hint) is ignored."""
    if cfg.moe_groups > 1:
        raise NotImplementedError(
            "grouped MoE dispatch (moe_groups > 1) is not ported "
            "(ROADMAP.md, queue 1)")
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * T * k / E))
    xt = x.reshape(T, d)
    top_w, top_i = moe_route(p["router"], xt, k)

    flat_e = top_i.reshape(T * k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    sorted_t = order // k
    sorted_w = top_w.reshape(T * k)[order]
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts
    pos_in_e = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, E * cap)

    # the overflow row E * cap takes every dropped pair and is cut off
    xe = xt.new_zeros(E * cap + 1, d).index_copy_(0, slot, xt[sorted_t])
    xe = xe[:-1].reshape(E, cap, d)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, p["e_gate"]))
         * torch.einsum("ecd,edf->ecf", xe, p["e_up"]))
    ye = torch.einsum("ecf,efd->ecd", h, p["e_down"]).reshape(E * cap, d)
    contrib = ye[slot.clamp(max=E * cap - 1)] * (
        sorted_w * keep).to(x.dtype)[:, None]
    y = torch.empty_like(contrib).index_copy_(0, order, contrib)
    y = y.reshape(T, k, d).sum(1)
    if cfg.n_shared_experts:
        y = y + (F.silu(xt @ p["s_gate"]) * (xt @ p["s_up"])) @ p["s_down"]
    return y.reshape(B, S, d)


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
