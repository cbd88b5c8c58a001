"""The port's model against the JAX model, on the CPU.

The JAX package initialises the parameters; ``convert.params_from_numpy``
carries them across, so both packages compute the same function from the
same weights.  Scaled-down configurations (``scale_down``) of qwen3_1_7b
(GQA, qk-norm, tied head), deepseek_7b (MHA, untied head) and qwen2_5_14b
(qkv bias) at 2-4 layers, in float32 and bfloat16.  Compared: ``prefill``
logits and caches, and 12 greedy ``decode_step``s from token 0 (the serving
engine's loop).

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
  per layer add up to the observed ~2-3%.
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
CASES = [("qwen3_1_7b", 4, "float32"), ("qwen3_1_7b", 4, "bfloat16"),
         ("deepseek_7b", 2, "float32"), ("deepseek_7b", 2, "bfloat16"),
         ("qwen2_5_14b", 2, "float32")]


@functools.lru_cache(maxsize=None)
def _pair(arch, layers, dtype):
    """(jax cfg, jax params, port cfg, port params) for one case."""
    jcfg = dataclasses.replace(jax_scale_down(jax_config(arch),
                                              layers=layers), dtype=dtype)
    tcfg = dataclasses.replace(scale_down(get_config(arch), layers=layers),
                               dtype=dtype)
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
    assert _rel(jlog, tlog) < TOL[dtype]
    for name in ("k", "v"):
        want = jcache["groups"]["pos0"][name]
        got = tcache["groups"]["pos0"][name]
        assert got.shape == want.shape
        assert _rel(want, got) < TOL[dtype]
        assert not _np(got)[:, :, S:].any()        # slots past the prompt


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
    assert worst < TOL[dtype], worst
    assert ops.launches()["decode_attention"]["plain"] == 12 * tcfg.n_layers


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


def test_unported_families_raise():
    for arch in ("recurrentgemma_9b", "rwkv6_3b", "gemma3_27b",
                 "qwen2_moe_a2_7b", "qwen2_vl_7b", "seamless_m4t_large_v2"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    base = scale_down(get_config("qwen3_1_7b"))
    for change in (dict(period=(LayerSpec(window=16),)),
                   dict(period=(LayerSpec(moe=True),)),
                   dict(period=(LayerSpec(kind="rglru"),)),
                   dict(mrope=True), dict(kv_cache_dtype="int8"),
                   dict(encoder_layers=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_supported(dataclasses.replace(base, **change))
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
