"""Decoder stack of the dense, windowed, mixture-of-experts, M-RoPE and
recurrent families (port of ``repro.models.model``).

Parameters are the JAX package's tree under the same names: ``embed``,
``final_norm``, ``lm_head`` (untied models), ``groups/pos{i}``, whose
leaves are stacked over the ``n_groups`` repetitions of the period, and
``tail/layer{i}`` for the layers past the last whole period (a
``n_layers`` that is not a multiple of the period, as recurrentgemma_9b's
38 = 12 x 3 + 2 or gemma3_27b's 62 = 10 x 6 + 2).  A layer holds ``attn``
+ ``mlp`` (``moe`` in a MoE layer), ``rglru`` + ``mlp`` or RWKV-6 ``tm`` +
``cm``.  The stack runs as a Python loop over the groups
(JAX scans), then the tail.  Caches are trees of the same kind: ``k``, ``v``
(B, Sc, Hkv, dh) for attention, where a windowed layer keeps a ring of
``Sc = min(window, cache_len)`` entries; ``h`` (B, w) and ``conv`` (B,
width - 1, w) for RG-LRU; ``shift``, ``wkv`` (B, H, dh, dh, float32) and
``cm_shift`` for RWKV-6.  ``prefill`` and ``decode_step`` write them in
place and return them, where JAX returns new arrays.

``decode_step`` takes ``pos`` as an int or as a 0-dim integer tensor on the
parameters' device, as JAX's traced ``jnp.int32(pos)``: the RoPE
positions, the cache slot written and the keys seen are computed from it on
the device, so the step reads nothing on the host and can be captured in a
CUDA graph whose ``pos`` advances between replays.

Public entry points:
  init(cfg, seed, device)                       -> params
  init_cache(cfg, batch, cache_len, device=)    -> cache
  prefill(params, cfg, batch, cache)            -> logits, cache
  decode_step(params, cfg, tokens, cache, pos)  -> logits, cache

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
int8 KV, grouped MoE dispatch (``moe_groups > 1``), encoder-decoder models
and the training ``forward``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device
from . import layers as L
from .config import ATTN, RGLRU, RWKV, LayerSpec, ModelConfig

_ROADMAP = "(ROADMAP.md, queue 1)"
# elements of a parameter drawn at once by ``init``: a larger leaf (an
# expert stack, a large vocabulary) is drawn in pieces of this many, so its
# float32 draw never needs memory beside the finished leaf
INIT_DRAW = 1 << 27


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    for spec in cfg.period:
        if spec.kind not in (ATTN, RGLRU, RWKV):
            raise ValueError(f"unknown layer kind {spec.kind!r}")
        if spec.moe and cfg.moe_groups > 1:
            raise NotImplementedError(
                f"grouped MoE dispatch (moe_groups > 1) is not ported "
                f"{_ROADMAP}")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"encoder-decoder models are not ported yet {_ROADMAP}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(f"int8 KV caches are not ported yet "
                                  f"{_ROADMAP}")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _map(fn, tree):
    """Apply ``fn`` to the leaves of a dict tree, keys in sorted order (the
    order JAX flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _stack(shapes: dict, n: int) -> dict:
    return _map(lambda s: (n, *s), shapes)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    shapes: dict = {"ln1": (d,), "ln2": (d,)}
    if spec.kind == ATTN:
        shapes["attn"] = L.attn_params_shapes(cfg)
    elif spec.kind == RGLRU:
        shapes["rglru"] = L.rglru_params_shapes(cfg)
    if spec.kind == RWKV:
        rwkv = L.rwkv_params_shapes(cfg)
        shapes["tm"] = {k: v for k, v in rwkv.items()
                        if not k.startswith("cm_")}
        shapes["cm"] = {k: v for k, v in rwkv.items() if k.startswith("cm_")}
    elif spec.moe:
        shapes["moe"] = L.moe_params_shapes(cfg)
    else:
        shapes["mlp"] = L.mlp_params_shapes(cfg)
    return shapes


def _with_tail(cfg: ModelConfig, layer_tree) -> dict:
    """``groups/pos{i}`` stacked over the groups, and ``tail/layer{i}`` for
    the layers past the last whole period; ``layer_tree(spec)`` gives one
    layer's tree."""
    tree: dict = {"groups": {
        f"pos{i}": _stack(layer_tree(spec), cfg.n_groups)
        for i, spec in enumerate(cfg.period)}}
    if cfg.n_tail:
        tree["tail"] = {f"layer{i}": layer_tree(cfg.period[i])
                        for i in range(cfg.n_tail)}
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """Full parameter shape tree (leaves are shape tuples)."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    tree: dict = {"embed": (V, d), "final_norm": (d,)}
    tree |= _with_tail(cfg, lambda spec: _layer_shapes(cfg, spec))
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, V)
    return tree


def init(cfg: ModelConfig, seed: int | torch.Generator, device=None) -> dict:
    """Random parameters by the JAX package's rule: zeros for leaves of
    rank <= 1, else normal / sqrt(shape[-2]), drawn in float32 from a
    ``torch.Generator`` on the target device (``seed`` or a generator) and
    cast to ``cfg.dtype``, a leaf of more than ``INIT_DRAW`` elements in
    pieces of that many.  The numbers differ from JAX's; tests move JAX's
    parameters across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = torch_dtype(cfg.dtype)

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.div_(math.sqrt(fan_in)).to(dtype)

    def make(shape):
        if len(shape) <= 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        n = math.prod(shape)
        if n <= INIT_DRAW:
            return draw(shape, shape[-2])
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, n, INIT_DRAW):
            flat[i:i + INIT_DRAW] = draw((min(INIT_DRAW, n - i),),
                                         shape[-2])
        return out

    return _map(make, param_shapes(cfg))


def _layer_cache_shapes(cfg: ModelConfig, spec: LayerSpec, batch: int,
                        cache_len: int) -> dict:
    if spec.kind == ATTN:
        s = cache_len if spec.window <= 0 else min(spec.window, cache_len)
        kv = (batch, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": kv, "v": kv}
    if spec.kind == RGLRU:
        w = cfg.lru_dim
        return {"h": (batch, w), "conv": (batch, cfg.conv1d_width - 1, w)}
    dh = cfg.rwkv_head_size
    return {"shift": (batch, cfg.d_model),
            "wkv": (batch, cfg.rwkv_heads, dh, dh),
            "cm_shift": (batch, cfg.d_model)}


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    check_supported(cfg)
    return _with_tail(cfg, lambda spec: _layer_cache_shapes(
        cfg, spec, batch, cache_len))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zeros in the model dtype (``dtype`` overrides it), the RWKV state
    ``wkv`` in float32 as in JAX."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)

    def make(tree):
        return {k: make(v) if isinstance(v, dict) else torch.zeros(
            v, dtype=torch.float32 if k == "wkv" else dt, device=dev)
            for k, v in tree.items()}

    return make(cache_shapes(cfg, batch, cache_len))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@dataclass
class Ctx:
    cfg: ModelConfig
    positions: torch.Tensor       # (B, S), or (3, B, S) with M-RoPE
    mode: str                     # "prefill" | "decode"
    pos: torch.Tensor | None = None   # decode write index, 0-dim int32
    lengths: dict | None = None   # decode: cache length Sc -> keys seen,
                                  # made by the first layer of that Sc
    cos_sin: tuple | None = None  # RoPE tables shared by all layers
    force: str | None = None      # kernel dispatch ("ref": plain versions)


def _attn_sublayer(p, spec: LayerSpec, x, ctx: Ctx, cache: dict):
    cfg = ctx.cfg
    B, S, _ = x.shape
    q, k_new, v_new = L.attn_project_qkv(p["attn"], x, cfg, ctx.positions,
                                         cos_sin=ctx.cos_sin)
    Sc = cache["k"].shape[1]
    if ctx.mode == "decode":
        # a window that fits the cache makes it a ring: position pos lives
        # in slot pos % Sc, and the valid keys are the first min(pos + 1,
        # Sc) slots, all within the window.  Otherwise the JAX slot
        # min(pos, Sc - 1) and the keys idx <= pos: the same lengths.  All
        # on the device, from the 0-dim pos.
        if 0 < spec.window <= Sc:
            slot = ctx.pos % Sc
        else:
            slot = ctx.pos.clamp(max=Sc - 1)
        slot = slot.reshape(1).long()
        for name, new in (("k", k_new), ("v", v_new)):
            cache[name].index_copy_(1, slot, new.to(cache[name].dtype))
        lengths = ctx.lengths.get(Sc)
        if lengths is None:
            lengths = ctx.lengths[Sc] = (ctx.pos + 1).clamp(max=Sc).to(
                torch.int32).expand(B)
        out = L.attention(q, cache["k"], cache["v"], lengths,
                          window=spec.window, force=ctx.force)
    else:
        out = L.attention(q, k_new, v_new, causal=True, window=spec.window,
                          force=ctx.force)
        for name, new in (("k", k_new), ("v", v_new)):
            if S >= Sc:     # position s lands in slot s % Sc, as in JAX
                cache[name].copy_(torch.roll(new[:, -Sc:], S % Sc, dims=1))
            else:
                cache[name][:, :S] = new
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["attn"]["wo"]


def _write(cache: dict, new: dict) -> None:
    for name, value in new.items():
        cache[name].copy_(value)


def apply_layer(p: dict, spec: LayerSpec, x: torch.Tensor, ctx: Ctx,
                cache: dict) -> torch.Tensor:
    """Pre-norm residual layer: attention, RG-LRU or RWKV-6 time mix, then
    SwiGLU, the mixture of experts or the RWKV-6 channel mix; writes
    ``cache``."""
    cfg = ctx.cfg
    h = L.rms_norm(x, p["ln1"])
    if spec.kind == ATTN:
        out = _attn_sublayer(p, spec, h, ctx, cache)
    elif spec.kind == RGLRU:
        out, new = L.rglru_block(p["rglru"], h, cfg, cache, force=ctx.force)
        _write(cache, new)
    else:
        out, new = L.rwkv_time_mix(p["tm"], h, cfg, cache, force=ctx.force)
        _write(cache, new)
    x = x + out
    h = L.rms_norm(x, p["ln2"])
    if spec.kind == RWKV:
        out, new = L.rwkv_channel_mix(p["cm"], h, cache)
        _write(cache, new)
    elif spec.moe:
        out = L.moe_mlp(p["moe"], h, cfg)
    else:
        out = L.swiglu_mlp(p["mlp"], h)
    return x + out


def _take(tree, g: int):
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


def _run_stack(params: dict, x: torch.Tensor, ctx: Ctx, cache: dict):
    """The groups in order, each the period's layers (JAX scans them),
    then the tail."""
    cfg = ctx.cfg
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.period):
            key = f"pos{i}"
            x = apply_layer(_take(params["groups"][key], g), spec, x, ctx,
                            _take(cache["groups"][key], g))
    for i in range(cfg.n_tail):
        key = f"layer{i}"
        x = apply_layer(params["tail"][key], cfg.period[i], x, ctx,
                        cache["tail"][key])
    return x


def _embed(params, cfg, tokens, embeds=None):
    """Token embeddings, or ``embeds`` (B, S, d) given in their place (the
    vision frontend's stub, as in JAX) in the model dtype."""
    if embeds is not None:
        return torch.as_tensor(embeds, device=params["embed"].device).to(
            torch_dtype(cfg.dtype))
    return params["embed"][tokens]


def _unembed(params, x):
    x = L.rms_norm(x, params["final_norm"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head


def _default_positions(cfg, B: int, S: int, offset=0, device=None):
    """Positions offset .. offset + S - 1 of each row, (B, S), or (3, B, S)
    with M-RoPE (t, h and w all equal, as JAX's default); ``offset`` an
    int or a 0-dim tensor on ``device``."""
    pos = torch.arange(S, dtype=torch.int32, device=device) + offset
    pos = pos[None].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.mrope else pos


def _context(cfg, positions, mode, force, **kw) -> Ctx:
    cos_sin = None
    if any(spec.kind == ATTN for spec in cfg.period):
        cos_sin = L.rope_cos_sin(positions, cfg.head_dim // 2,
                                 cfg.rope_theta, torch_dtype(cfg.dtype),
                                 L.rope_sections(cfg))
    return Ctx(cfg=cfg, positions=positions, mode=mode, cos_sin=cos_sin,
               force=force, **kw)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict, *,
            force: str | None = None):
    """Prompt processing on the parameters' device; fills ``cache``
    (from ``init_cache``) in place and returns (last-token logits (B, V),
    cache).  ``batch``: ``tokens`` (B, S), optionally ``positions`` ((3, B,
    S) with M-RoPE) and ``embeds`` (B, S, d), which take the tokens' place
    as the JAX model's ``_embed`` takes them.  Attention masks by token
    index, as the kernels do; the JAX model masks by the positions (M-RoPE:
    the t positions), which is the same while they increase along the
    prompt."""
    check_supported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, device=dev)
    else:
        positions = torch.as_tensor(positions, device=dev)
    ctx = _context(cfg, positions, "prefill", force)
    x = _run_stack(params, _embed(params, cfg, tokens, batch.get("embeds")),
                   ctx, cache)
    return _unembed(params, x[:, -1:, :])[:, 0, :], cache


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict,
                pos, *, force: str | None = None):
    """One decode step on the parameters' device.  ``tokens`` (B,) int;
    ``pos`` the current index, an int or a 0-dim integer tensor (on the
    parameters' device, it is read there and never on the host: the step
    can be captured in a CUDA graph).  Writes the new K / V and recurrent
    states into ``cache`` in place and returns (logits (B, V), cache)."""
    check_supported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos.dim() != 0:
        raise ValueError(f"pos must be a scalar, got shape "
                         f"{tuple(pos.shape)}")
    ctx = _context(cfg, _default_positions(cfg, B, 1, pos, dev), "decode",
                   force, pos=pos, lengths={})
    x = _run_stack(params, _embed(params, cfg, tokens[:, None]), ctx, cache)
    return _unembed(params, x)[:, 0, :], cache


def forward(*_args, **_kw):
    """The training forward is not ported yet (ROADMAP.md, queue 1:
    training)."""
    raise NotImplementedError(f"the training forward is not ported yet "
                              f"{_ROADMAP}")
