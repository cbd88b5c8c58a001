"""Decoder stack of the dense full-attention families (port of
``repro.models.model``).

Parameters are the JAX package's tree under the same names: ``embed``,
``final_norm``, ``lm_head`` (untied models) and ``groups/pos{i}``, whose
leaves are stacked over the ``n_groups`` repetitions of the period.  The
stack runs as a Python loop over the groups (JAX scans).  Caches are trees
of the same kind, ``groups/pos{i}/{k, v}`` of shape (n_groups, B, Sc, Hkv,
dh); ``prefill`` and ``decode_step`` write them in place and return them,
where JAX returns new arrays.

Public entry points:
  init(cfg, seed, device)                       -> params
  init_cache(cfg, batch, cache_len, device=)    -> cache
  prefill(params, cfg, batch, cache)            -> logits, cache
  decode_step(params, cfg, tokens, cache, pos)  -> logits, cache

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
windowed layers and the ring-buffer decode, int8 KV, MoE, M-RoPE, RG-LRU,
RWKV, encoder-decoder models, the period tail and the training
``forward``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..device import resolve_device
from . import layers as L
from .config import ATTN, ModelConfig

_ROADMAP = "(ROADMAP.md, queue 1)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    for spec in cfg.period:
        if spec.kind != ATTN:
            raise NotImplementedError(
                f"{spec.kind} layers are not ported yet {_ROADMAP}")
        if spec.window > 0:
            raise NotImplementedError(
                f"windowed layers and the ring-buffer decode are not ported "
                f"yet {_ROADMAP}")
        if spec.moe:
            raise NotImplementedError(f"MoE layers are not ported yet "
                                      f"{_ROADMAP}")
    if cfg.mrope:
        raise NotImplementedError(f"M-RoPE is not ported yet {_ROADMAP}")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"encoder-decoder models are not ported yet {_ROADMAP}")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(f"int8 KV caches are not ported yet "
                                  f"{_ROADMAP}")
    if cfg.n_tail:
        raise NotImplementedError(
            f"a period tail (n_layers not a multiple of the period) is not "
            f"ported yet {_ROADMAP}")


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
def _layer_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": (d,), "ln2": (d,), "attn": L.attn_params_shapes(cfg),
            "mlp": L.mlp_params_shapes(cfg)}


def param_shapes(cfg: ModelConfig) -> dict:
    """Full parameter shape tree (leaves are shape tuples)."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    tree: dict = {
        "embed": (V, d),
        "final_norm": (d,),
        "groups": {f"pos{i}": _stack(_layer_shapes(cfg), cfg.n_groups)
                   for i in range(len(cfg.period))},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, V)
    return tree


def init(cfg: ModelConfig, seed: int | torch.Generator, device=None) -> dict:
    """Random parameters by the JAX package's rule: zeros for leaves of
    rank <= 1, else normal / sqrt(shape[-2]), drawn in float32 from a
    ``torch.Generator`` on the target device (``seed`` or a generator) and
    cast to ``cfg.dtype``.  The numbers differ from JAX's; tests move JAX's
    parameters across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    dtype = torch_dtype(cfg.dtype)

    def make(shape):
        if len(shape) <= 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.div_(math.sqrt(shape[-2])).to(dtype)

    return _map(make, param_shapes(cfg))


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    check_supported(cfg)
    kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"groups": {f"pos{i}": _stack({"k": kv, "v": kv}, cfg.n_groups)
                       for i in range(len(cfg.period))}}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=None) -> dict:
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    return _map(lambda s: torch.zeros(s, dtype=dt, device=dev),
                cache_shapes(cfg, batch, cache_len))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@dataclass
class Ctx:
    cfg: ModelConfig
    positions: torch.Tensor       # (B, S)
    mode: str                     # "prefill" | "decode"
    pos: int = 0                  # decode write index
    lengths: torch.Tensor | None = None   # decode: keys each row sees
    cos_sin: tuple | None = None  # RoPE tables shared by all layers
    force: str | None = None      # kernel dispatch ("ref": plain versions)


def _attn_sublayer(p, x, ctx: Ctx, cache: dict):
    cfg = ctx.cfg
    B, S, _ = x.shape
    q, k_new, v_new = L.attn_project_qkv(p["attn"], x, cfg, ctx.positions,
                                         cos_sin=ctx.cos_sin)
    Sc = cache["k"].shape[1]
    if ctx.mode == "decode":
        # the JAX slot min(pos, Sc - 1); keys idx <= pos, i.e. the first
        # min(pos + 1, Sc) entries, are the lengths
        slot = min(ctx.pos, Sc - 1)
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        out = L.attention(q, cache["k"], cache["v"], ctx.lengths,
                          force=ctx.force)
    else:
        out = L.attention(q, k_new, v_new, causal=True, force=ctx.force)
        for name, new in (("k", k_new), ("v", v_new)):
            if S >= Sc:     # position s lands in slot s % Sc, as in JAX
                cache[name].copy_(torch.roll(new[:, -Sc:], S % Sc, dims=1))
            else:
                cache[name][:, :S] = new
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["attn"]["wo"]


def apply_layer(p: dict, x: torch.Tensor, ctx: Ctx,
                cache: dict) -> torch.Tensor:
    """Pre-norm residual attention + SwiGLU layer; writes ``cache``."""
    x = x + _attn_sublayer(p, L.rms_norm(x, p["ln1"]), ctx, cache)
    return x + L.swiglu_mlp(p["mlp"], L.rms_norm(x, p["ln2"]))


def _take(tree, g: int):
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


def _run_stack(params: dict, x: torch.Tensor, ctx: Ctx, cache: dict):
    """The groups in order, each the period's layers (JAX scans them)."""
    cfg = ctx.cfg
    for g in range(cfg.n_groups):
        for i in range(len(cfg.period)):
            key = f"pos{i}"
            x = apply_layer(_take(params["groups"][key], g), x, ctx,
                            _take(cache["groups"][key], g))
    return x


def _embed(params, tokens):
    return params["embed"][tokens]


def _unembed(params, x):
    x = L.rms_norm(x, params["final_norm"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head


def _default_positions(B: int, S: int, offset: int = 0, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device) + offset
    return pos[None].expand(B, S)


def _context(cfg, positions, mode, force, **kw) -> Ctx:
    dtype = torch_dtype(cfg.dtype)
    cos_sin = L.rope_cos_sin(positions, cfg.head_dim // 2, cfg.rope_theta,
                             dtype)
    return Ctx(cfg=cfg, positions=positions, mode=mode, cos_sin=cos_sin,
               force=force, **kw)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict, *,
            force: str | None = None):
    """Prompt processing on the parameters' device; fills ``cache``
    (from ``init_cache``) in place and returns (last-token logits (B, V),
    cache).  ``batch``: ``tokens`` (B, S) and optionally ``positions``."""
    check_supported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(B, S, device=dev)
    else:
        positions = torch.as_tensor(positions, device=dev)
    ctx = _context(cfg, positions, "prefill", force)
    x = _run_stack(params, _embed(params, tokens), ctx, cache)
    return _unembed(params, x[:, -1:, :])[:, 0, :], cache


def decode_step(params: dict, cfg: ModelConfig, tokens, cache: dict,
                pos: int, *, force: str | None = None):
    """One decode step on the parameters' device.  ``tokens`` (B,) int;
    ``pos`` the current index (a Python int).  Writes the new K / V into
    ``cache`` in place and returns (logits (B, V), cache)."""
    check_supported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    pos = int(pos)
    Sc = cache["groups"]["pos0"]["k"].shape[2]
    lengths = torch.full((B,), min(pos + 1, Sc), dtype=torch.int32,
                         device=dev)
    ctx = _context(cfg, _default_positions(B, 1, pos, dev), "decode", force,
                   pos=pos, lengths=lengths)
    x = _run_stack(params, _embed(params, tokens[:, None]), ctx, cache)
    return _unembed(params, x)[:, 0, :], cache


def forward(*_args, **_kw):
    """The training forward is not ported yet (ROADMAP.md, queue 1:
    training)."""
    raise NotImplementedError(f"the training forward is not ported yet "
                              f"{_ROADMAP}")
