"""The port's model against the JAX model, on the CPU.

The JAX package initialises the parameters; ``convert.params_from_numpy``
carries them across, so both packages compute the same function from the
same weights.  Scaled-down configurations (``scale_down``) of qwen3_1_7b
(GQA, qk-norm, tied head), deepseek_7b (MHA, untied head), qwen2_5_14b
(qkv bias), rwkv6_3b (RWKV-6 time and channel mix) and recurrentgemma_9b
(RG-LRU, RG-LRU, MQA attention with a window of 64): one group of 3
layers, and 5 layers so that the 2-layer tail runs), in float32 and
bfloat16.  Compared: ``prefill`` logits and every cache leaf (``k``, ``v``,
``h``, ``conv``, ``shift``, ``wkv``, ``cm_shift``), and 12 greedy
``decode_step``s from token 0 (the serving engine's loop); and a prompt
longer than recurrentgemma's window, so its ring buffer wraps in prefill
and again in decode.

Tolerances, relative to the largest |logit| of the step:
- float32: 1e-4, and the greedy tokens are equal.  The two packages run the
  same float32 arithmetic with sums in other orders (observed ~1e-6).
- bfloat16: 5e-2, tokens not compared (both packages go on with JAX's
  token, since a near-tie may flip).  Both round to bfloat16 after every
  operation, but at other places: XLA on the CPU fuses chains of bf16
  elementwise operations (RMS norm, RoPE, SwiGLU) and rounds once at the
  end of each fusion, where PyTorch rounds after each operation; and the
  JAX model's attention rounds the normalised probabilities to bf16 while
  the port's kernels round the unnormalised ones.  A few bf16 ulps (2^-8)
  per layer add up to the observed ~2-3%.  The recurrences follow the
  Pallas kernels, not the JAX model: the RG-LRU carries h in float32 within
  a call (the JAX model rounds it to bf16 every step) and the RWKV-6 time
  mix multiplies in float32 (the JAX model rounds k v^T and S + u k v^T to
  bf16 before the product with r).  The RG-LRU stays within the same 5e-2.
- bfloat16, rwkv6_3b: 1e-1.  The JAX model alone, jitted against run op
  by op (``jax.disable_jit``), differs by up to 3.3% over these 12 decode
  steps, and the port's float32 products in the recurrence add to that:
  up to 7.3% at one step (4.1% in prefill), 5.2% when the port's plain
  recurrence is made to round k v^T and S + u k v^T to bf16 as the JAX
  model does.  The per-head group norm (head size 16 here) amplifies
  bf16 noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode
from repro.models import init as jax_init
from repro.models import init_cache as jax_init_cache
from repro.models import prefill as jax_prefill
from repro.models import scale_down as jax_scale_down
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import (LayerSpec, decode_step, forward, init,
                                init_cache, param_shapes, prefill,
                                scale_down)
from repro_torch.models.model import check_supported

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RWKV_BF16_TOL = 1e-1


def _tol(arch, dtype):
    if arch == "rwkv6_3b" and dtype == "bfloat16":
        return RWKV_BF16_TOL
    return TOL[dtype]
CASES = [("qwen3_1_7b", 4, "float32"), ("qwen3_1_7b", 4, "bfloat16"),
         ("deepseek_7b", 2, "float32"), ("deepseek_7b", 2, "bfloat16"),
         ("qwen2_5_14b", 2, "float32"),
         ("rwkv6_3b", 2, "float32"), ("rwkv6_3b", 2, "bfloat16"),
         ("recurrentgemma_9b", 3, "float32"),
         ("recurrentgemma_9b", 3, "bfloat16"),
         ("recurrentgemma_9b", 5, "float32"),    # 1 group + a 2-layer tail
         ("recurrentgemma_9b", 5, "bfloat16")]


@functools.lru_cache(maxsize=None)
def _pair(arch, layers, dtype):
    """(jax cfg, jax params, port cfg, port params) for one case.
    ``scale_down`` rounds ``layers`` down to whole periods; a ``layers``
    that is not a multiple of the period is set afterwards, so the tail
    runs."""
    jcfg = dataclasses.replace(jax_scale_down(jax_config(arch),
                                              layers=layers), dtype=dtype)
    tcfg = dataclasses.replace(scale_down(get_config(arch), layers=layers),
                               dtype=dtype)
    if tcfg.n_layers != layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax_init(jcfg, jax.random.PRNGKey(len(arch) + layers))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _leaves(tree, path=()):
    """``{path: leaf}`` of a dict tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _leaves(v, path + (k,))
        else:
            out[path + (k,)] = v
    return out


def _check_cache(jcache, tcache, tol, S=None):
    """Every leaf of the port's cache against JAX's: same paths, shapes
    and dtypes, values within the tolerance; attention slots past a prompt
    of ``S`` tokens still 0."""
    want, got = _leaves(jcache), _leaves(tcache)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if _np(w).any():
            assert _rel(w, g) < tol, path
        else:
            assert not _np(g).any(), path
        if S is not None and path[-1] in ("k", "v"):
            assert not _np(g)[:, :, S:].any(), path


def _n_kind(cfg, kind):
    """Layers of ``kind`` in the whole stack."""
    return sum(spec.kind == kind for spec in cfg.layer_specs())


@pytest.mark.parametrize("arch,layers,dtype", CASES)
def test_prefill_matches_jax(arch, layers, dtype):
    jcfg, jparams, tcfg, tparams = _pair(arch, layers, dtype)
    B, S, Sc = 2, 7, 12
    tokens = np.random.default_rng(layers).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jax.jit(functools.partial(jax_prefill, cfg=jcfg))(
        jparams, batch={"tokens": jnp.asarray(tokens)},
        cache=jax_init_cache(jcfg, B, Sc))
    tlog, tcache = prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)},
                           init_cache(tcfg, B, Sc, device="cpu"))
    assert tlog.shape == (B, tcfg.padded_vocab) and tlog.dtype == getattr(
        torch, dtype)
    assert _rel(jlog, tlog) < _tol(arch, dtype)
    _check_cache(jcache, tcache, _tol(arch, dtype), S)


@pytest.mark.parametrize("arch,layers,dtype", CASES)
def test_greedy_decode_matches_jax(arch, layers, dtype):
    """The serving engine's loop: 12 greedy steps from token 0."""
    jcfg, jparams, tcfg, tparams = _pair(arch, layers, dtype)
    step = jax.jit(functools.partial(jax_decode, cfg=jcfg))
    jcache = jax_init_cache(jcfg, 1, 20)
    tcache = init_cache(tcfg, 1, 20, device="cpu")
    jtok = jnp.zeros((1,), jnp.int32)
    ttok = torch.zeros((1,), dtype=torch.int32)
    ops.reset_launches()
    worst = 0.0
    for pos in range(12):
        jlog, jcache = step(jparams, tokens=jtok, cache=jcache,
                            pos=jnp.int32(pos))
        tlog, tcache = decode_step(tparams, tcfg, ttok, tcache, pos)
        worst = max(worst, _rel(jlog, tlog))
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1).to(torch.int32)
        if dtype == "float32":
            assert int(jtok[0]) == int(ttok[0]), f"token {pos} differs"
        else:       # near-ties may flip in bf16: both go on with JAX's token
            ttok = torch.from_numpy(np.array(jtok))
    assert worst < _tol(arch, dtype), worst
    _check_cache(jcache, tcache, _tol(arch, dtype))
    n = ops.launches()
    assert n["decode_attention"]["plain"] == 12 * _n_kind(tcfg, "attn")
    assert n["rglru_scan"]["plain"] == 12 * _n_kind(tcfg, "rglru")
    assert n["rwkv6_scan"]["plain"] == 12 * _n_kind(tcfg, "rwkv")


def test_prefill_then_decode_matches_jax():
    """Decode continues a prefilled cache: slot = pos, lengths pos + 1."""
    jcfg, jparams, tcfg, tparams = _pair("qwen3_1_7b", 4, "float32")
    B, S, Sc = 2, 5, 9
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S))
    jlog, jcache = jax_prefill(jparams, jcfg, {"tokens": jnp.asarray(
        tokens, jnp.int32)}, jax_init_cache(jcfg, B, Sc))
    tlog, tcache = prefill(tparams, tcfg, {"tokens": torch.from_numpy(
        tokens)}, init_cache(tcfg, B, Sc, device="cpu"))
    step = jax.jit(functools.partial(jax_decode, cfg=jcfg))
    # pos 8 fills the last slot, pos 9 and 10 overwrite it (slot Sc - 1)
    for pos in range(S, Sc + 2):
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1).to(torch.int32)
        assert np.array_equal(np.asarray(jtok), ttok.numpy())
        jlog, jcache = step(jparams, tokens=jtok, cache=jcache,
                            pos=jnp.int32(pos))
        tlog, tcache = decode_step(tparams, tcfg, ttok, tcache, pos)
        assert _rel(jlog, tlog) < TOL["float32"]
    assert _rel(jcache["groups"]["pos0"]["k"],
                tcache["groups"]["pos0"]["k"]) < TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_ring_wraps_in_prefill_and_decode(dtype):
    """recurrentgemma, window 64 and a cache of 100: the attention layer's
    ring holds Sc = 64 slots.  A prompt of 80 tokens wraps it in prefill
    (position s in slot s % 64), and 12 decode steps write slots 16-27
    (pos % 64) over the ring, each seeing the 64 newest keys."""
    jcfg, jparams, tcfg, tparams = _pair("recurrentgemma_9b", 3, dtype)
    B, S, cache_len = 2, 80, 100
    assert tcfg.period[2].window == 64 < S
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab, (B, S))
    jlog, jcache = jax.jit(functools.partial(jax_prefill, cfg=jcfg))(
        jparams, batch={"tokens": jnp.asarray(tokens, jnp.int32)},
        cache=jax_init_cache(jcfg, B, cache_len))
    tlog, tcache = prefill(tparams, tcfg, {"tokens": torch.from_numpy(
        tokens)}, init_cache(tcfg, B, cache_len, device="cpu"))
    assert tcache["groups"]["pos2"]["k"].shape[2] == 64
    assert _rel(jlog, tlog) < TOL[dtype]
    _check_cache(jcache, tcache, TOL[dtype])
    step = jax.jit(functools.partial(jax_decode, cfg=jcfg))
    for pos in range(S, S + 12):
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok))
        if dtype == "float32":
            assert torch.equal(ttok, tlog.argmax(-1).to(torch.int32))
        jlog, jcache = step(jparams, tokens=jtok, cache=jcache,
                            pos=jnp.int32(pos))
        tlog, tcache = decode_step(tparams, tcfg, ttok, tcache, pos)
        assert _rel(jlog, tlog) < TOL[dtype], pos
    _check_cache(jcache, tcache, TOL[dtype])


def test_init_follows_the_jax_rule():
    cfg = scale_down(get_config("deepseek_7b"), layers=2)
    a = init(cfg, 3, "cpu")
    b = init(cfg, 3, "cpu")
    shapes = param_shapes(cfg)
    assert a["lm_head"].shape == shapes["lm_head"] == (64, 512)
    assert a["embed"].dtype == torch.bfloat16
    assert not a["final_norm"].any()                       # rank 1: zeros
    w = a["groups"]["pos0"]["mlp"]["w_down"].float()       # (2, 128, 64)
    assert w.shape == (2, 128, 64)
    assert abs(w.std().item() * np.sqrt(128) - 1) < 0.1    # 1/sqrt(fan_in)
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], init(cfg, 4, "cpu")["embed"])


def test_params_from_numpy_checks_the_tree():
    jcfg, jparams, tcfg, _ = _pair("qwen3_1_7b", 4, "float32")
    tree = jax.tree.map(np.asarray, jparams)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(tree, tcfg, "cpu")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["groups"]["pos0"]["attn"]["q_norm"]
    with pytest.raises(ValueError, match="attn"):
        params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch,layers,kinds", [
    ("rwkv6_3b", 2, {"tm", "cm"}),
    ("recurrentgemma_9b", 5, {"rglru", "mlp", "attn"}),
])
def test_params_from_numpy_carries_the_recurrent_trees(arch, layers, kinds):
    """The RWKV-6 (``tm``, ``cm``) and RG-LRU (``rglru``) subtrees and the
    ``tail`` cross as they are, in the JAX tree's shapes; a missing or
    misshapen leaf in them raises."""
    jcfg, jparams, tcfg, tparams = _pair(arch, layers, "float32")
    tree = jax.tree.map(np.asarray, jparams)
    assert set(_leaves(tparams)) == set(_leaves(tree))
    for path, leaf in _leaves(tree).items():
        assert np.array_equal(_np(_leaves(tparams)[path]), leaf), path
    groups = {k for pos in tparams["groups"].values() for k in pos}
    assert kinds <= groups
    assert ("tail" in tparams) == (tcfg.n_tail > 0)
    if tcfg.n_tail:
        assert set(tparams["tail"]) == {"layer0", "layer1"}
        assert "rglru" in tparams["tail"]["layer1"]
        bad = jax.tree.map(np.asarray, jparams)
        bad["tail"]["layer1"]["rglru"]["lambda"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="tail/layer1/rglru/lambda"):
            params_from_numpy(bad, tcfg, "cpu")
    else:
        bad = jax.tree.map(np.asarray, jparams)
        del bad["groups"]["pos0"]["tm"]["u"]
        with pytest.raises(ValueError, match="tm"):
            params_from_numpy(bad, tcfg, "cpu")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("seamless_m4t_large_v2")
    base = scale_down(get_config("qwen3_1_7b"))
    moe = scale_down(get_config("qwen2_moe_a2_7b"))
    for cfg in (dataclasses.replace(base, kv_cache_dtype="int8"),
                dataclasses.replace(base, encoder_layers=2),
                dataclasses.replace(moe, moe_groups=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_supported(cfg)
    # windows, recurrent layers, a tail, MoE, M-RoPE and gemma3's periods
    # (5 local : 1 global, and its 2-layer tail) are ported
    for change in (dict(period=(LayerSpec(window=16),)),
                   dict(period=(LayerSpec(kind="rglru"),)),
                   dict(period=(LayerSpec(kind="rwkv"),)),
                   dict(period=(LayerSpec(), LayerSpec(window=8)),
                        n_layers=3)):
        check_supported(dataclasses.replace(base, **change))
    for arch in ("gemma3_27b", "qwen2_moe_a2_7b", "llama4_scout_17b_a16e",
                 "qwen2_vl_7b"):
        check_supported(get_config(arch))
    gemma = get_config("gemma3_27b")
    assert (gemma.n_groups, gemma.n_tail) == (10, 2)
    check_supported(dataclasses.replace(scale_down(gemma), n_layers=8))
    check_supported(dataclasses.replace(base, mrope=True))
    with pytest.raises(ValueError, match="kind"):
        check_supported(dataclasses.replace(
            base, period=(LayerSpec(kind="mamba"),)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward({}, base, {})


def test_default_device_is_cuda():
    cfg = scale_down(get_config("qwen3_1_7b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
