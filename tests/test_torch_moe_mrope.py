"""The port's mixture of experts, M-RoPE and the four decoder-only families
they bring (gemma3_27b, qwen2_moe_a2_7b, llama4_scout_17b_a16e,
qwen2_vl_7b) against the JAX package, on the CPU.

The inputs are numpy arrays from seeds, or the JAX package's parameters
carried across by ``convert.params_from_numpy``; both packages compute
the same function from them.

Tolerances, relative to the largest |output| (``moe_mlp``, M-RoPE) or the
largest |logit| of the step (the models), as ``tests/test_torch_model.py``
states them:
- float32: 1e-4 (sums in another order; observed ~1e-6).
- bfloat16: 5e-2 (both round to bf16 after each operation, at other
  places: XLA fuses elementwise chains and rounds once a fusion).  The
  expert combine also differs: JAX adds a token's k contributions into a
  bf16 zero one by one, the port sums them in float32 and rounds once.
  The MoE models run in float32 only: with bf16 activations that differ
  between the packages the router may pick another expert at a near-tie,
  which is routing, not rounding; ``moe_mlp`` alone takes the same bf16
  inputs in both and is held to 5e-2.
- bfloat16, gemma3_27b (8 layers, qk-norm): 1e-1.  The JAX model's own
  bf16 run lies up to 6.7% from its float32 run on the same (widened)
  weights over these steps, and the port's up to 7.0%; the two bf16 runs
  up to 6.1% from each other.  So the bf16 cases also hold the port's run
  to at most ``WITNESS_RATIO`` (1.25) times the JAX bf16 run's distance
  from JAX's float32 run: rounding, not a fault (the ratio is 1.05 for
  gemma3_27b and 1.06 for qwen2_vl_7b).
- ``apply_mrope`` with the three position streams equal is
  ``apply_rope``, exactly (the same angles, elementwise).
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
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.models import scale_down as jax_scale_down
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import decode_step, init_cache, prefill, scale_down
from repro_torch.models import layers as L
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BF16_TOL = {"gemma3_27b": 1e-1}
WITNESS_RATIO = 1.25
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def _moe_case(seed, dtype, cf, T, tie=False):
    """(cfg, numpy params, numpy x (2, T // 2, d)) of scaled-down
    qwen2_moe_a2_7b (4 experts, top-2, a shared expert) at capacity factor
    ``cf``; ``tie`` makes router columns 1 and 2 equal, so every token's
    gates for experts 1 and 2 tie exactly."""
    cfg = dataclasses.replace(scale_down(get_config("qwen2_moe_a2_7b")),
                              capacity_factor=cf, dtype=dtype)
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in L.moe_params_shapes(cfg).items()}
    if tie:
        p["router"][:, 2] = p["router"][:, 1]
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _dropped(cfg, p, x):
    """(token, choice) pairs past their expert's capacity, as JAX counts
    them (float32 router, top-k)."""
    T = x.shape[0] * x.shape[1]
    cap = max(1, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
    logits = x.reshape(T, -1) @ p["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    counts = np.bincount(top.ravel(), minlength=cfg.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,T,tie", [
    (1.25, 8, False),     # the configs' capacity factor
    (0.5, 32, False),     # capacity 8 for 16 pairs an expert: overflow
    (1.25, 32, True),     # tied gates: the lower expert, as lax.top_k
])
def test_moe_mlp_matches_jax(dtype, cf, T, tie):
    cfg, p, x = _moe_case(T + int(tie), dtype, cf, T, tie)
    jdt, tdt = DT[dtype]
    if cf < 1:
        assert _dropped(cfg, p, x) > 0
    want = jax_layers.moe_mlp({k: jnp.asarray(v, jdt) for k, v in p.items()},
                              jnp.asarray(x, jdt), cfg)
    got = L.moe_mlp({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
                    torch.from_numpy(x).to(tdt), cfg)
    assert got.shape == x.shape and got.dtype == tdt
    assert _rel(want, got) < TOL[dtype]


def test_moe_mlp_drops_past_capacity():
    """A capacity of one pair an expert: the pairs past it add nothing,
    so zeroing the shared expert leaves only the kept pairs' outputs; and
    the result is the same on a second call (no order of atomic adds)."""
    cfg, p, x = _moe_case(3, "float32", 1e-9, 16)
    cfg = dataclasses.replace(cfg, n_shared_experts=0)
    p = {k: v for k, v in p.items() if not k.startswith("s_")}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    y = L.moe_mlp(tp, xt, cfg)
    want = jax_layers.moe_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg)
    assert _rel(want, y) < TOL["float32"]
    # E experts, one pair each: at most E tokens have any output
    rows = (y.reshape(16, -1).abs().sum(-1) > 0).sum()
    assert 0 < int(rows) <= cfg.n_experts
    assert torch.equal(y, L.moe_mlp(tp, xt, cfg))


def test_moe_mlp_takes_its_routing_from_moe_route(monkeypatch):
    """``moe_mlp`` looks ``layers.moe_route`` up at every call, so a check
    can record or impose the routing there: its own routing passed
    through gives the same output bit for bit, another expert for one
    token another output."""
    cfg, p, x = _moe_case(5, "float32", 1.25, 8)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    want = L.moe_mlp(tp, xt, cfg)
    route, seen = L.moe_route, []

    def recorded(router, x2, k):
        w, i = route(router, x2, k)
        seen.append(i)
        return w, i

    def moved(router, x2, k):
        w, i = route(router, x2, k)
        i = i.clone()
        i[0] = (i[0] + 1) % cfg.n_experts
        return w, i

    monkeypatch.setattr(L, "moe_route", recorded)
    assert torch.equal(L.moe_mlp(tp, xt, cfg), want)
    assert len(seen) == 1 and seen[0].shape == (8, cfg.top_k)
    monkeypatch.setattr(L, "moe_route", moved)
    assert not torch.equal(L.moe_mlp(tp, xt, cfg), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax(dtype):
    """qwen2_vl_7b's sections (16, 24, 24) at head_dim 128, distinct t, h
    and w streams."""
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(7)
    B, S, H, dh = 2, 9, 3, 128
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    pos = np.stack([np.arange(S)[None].repeat(B, 0),
                    rng.integers(0, 40, (B, S)),
                    rng.integers(0, 40, (B, S))]).astype(np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    sections = get_config("qwen2_vl_7b").mrope_sections
    want = jax_layers.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos),
                                  sections, 1e6)
    got = L.apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                        sections, 1e6)
    assert got.dtype == tdt
    assert _rel(want, got) < TOL[dtype]


def test_apply_mrope_is_rope_when_the_streams_agree():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 32)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 1000, (2, 6)).astype(np.int32))
    got = L.apply_mrope(x, pos[None].expand(3, 2, 6), (4, 6, 6), 1e6)
    assert torch.equal(got, L.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(x, pos[None].expand(3, 2, 6), (4, 6, 5), 1e6)


# ---------------------------------------------------------------------------
# the four families, prefill and greedy decode against JAX
# ---------------------------------------------------------------------------
CASES = [("gemma3_27b", "float32"), ("gemma3_27b", "bfloat16"),
         ("qwen2_moe_a2_7b", "float32"),
         ("llama4_scout_17b_a16e", "float32"),
         ("qwen2_vl_7b", "float32"), ("qwen2_vl_7b", "bfloat16")]
# gemma3: one group of 5 local + 1 global and its 2-layer tail
LAYERS = {"gemma3_27b": 8}


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    jcfg = dataclasses.replace(jax_scale_down(jax_config(arch)), dtype=dtype)
    tcfg = dataclasses.replace(scale_down(get_config(arch)), dtype=dtype)
    if arch in LAYERS:
        jcfg = dataclasses.replace(jcfg, n_layers=LAYERS[arch])
        tcfg = dataclasses.replace(tcfg, n_layers=LAYERS[arch])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax_init(jcfg, jax.random.PRNGKey(len(arch)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(cfg, B, S, seed):
    """tokens (B, S) and, for M-RoPE, random embeds (B, S, d) and (3, B, S)
    positions: t increasing along the prompt, h and w distinct from it."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.mrope:
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        t = np.arange(S)[None].repeat(B, 0)
        batch["positions"] = np.stack([t, rng.integers(0, 30, (B, S)),
                                       rng.integers(0, 30, (B, S))]).astype(
            np.int32)
    return batch


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_then_greedy_decode_matches_jax(arch, dtype):
    """A 7-token prompt (qwen2_vl: its embeds and 3D positions) into a
    cache of 20, then 10 greedy steps from its last token; logits of the
    prefill and of every step within the tolerance, tokens equal in
    float32 (in bf16 both go on with JAX's, and JAX's float32 model on the
    widened weights is the witness)."""
    jcfg, jparams, tcfg, tparams = _pair(arch, dtype)
    tol = BF16_TOL.get(arch, TOL[dtype]) if dtype == "bfloat16" else TOL[
        dtype]
    B, S, Sc = 2, 7, 20
    batch = _prompt(tcfg, B, S, len(arch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    runs = [(jcfg, jparams)]
    if dtype == "bfloat16":
        runs.append((dataclasses.replace(jcfg, dtype="float32"), jax.tree.map(
            lambda a: a.astype(jnp.float32), jparams)))
    jlogs = []
    for cfg, params in runs:
        log, cache = jax.jit(functools.partial(jax_prefill, cfg=cfg))(
            params, batch=jbatch, cache=jax_init_cache(cfg, B, Sc))
        jlogs.append([log, cache, jax.jit(functools.partial(jax_decode,
                                                            cfg=cfg))])
    tlog, tcache = prefill(tparams, tcfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           init_cache(tcfg, B, Sc, device="cpu"))
    assert tlog.shape == (B, tcfg.padded_vocab)
    seen = [(jlogs[0][0], tlog, [r[0] for r in jlogs[1:]])]
    for pos in range(S, S + 10):
        jtok = jnp.argmax(jlogs[0][0], -1).astype(jnp.int32)
        ttok = tlog.argmax(-1).to(torch.int32)
        if dtype == "float32":
            assert np.array_equal(np.asarray(jtok), ttok.numpy()), pos
        else:
            ttok = torch.from_numpy(np.array(jtok))
        for (cfg, params), run in zip(runs, jlogs):
            run[0], run[1] = run[2](params, tokens=jtok, cache=run[1],
                                    pos=jnp.int32(pos))
        tlog, tcache = decode_step(tparams, tcfg, ttok, tcache,
                                   torch.tensor(pos, dtype=torch.int32))
        seen.append((jlogs[0][0], tlog, [r[0] for r in jlogs[1:]]))
    for i, (jl, tl, _) in enumerate(seen):
        assert _rel(jl, tl) < tol, i
    if dtype == "bfloat16":
        port = max(_rel(f[0], tl) for _, tl, f in seen)
        ref = max(_rel(f[0], jl) for jl, _, f in seen)
        assert port <= WITNESS_RATIO * ref, (port, ref)


def test_params_from_numpy_carries_the_moe_trees():
    """``router``, the expert stacks ``e_*`` and the shared experts ``s_*``
    cross as they are; a misshapen expert stack raises."""
    jcfg, jparams, tcfg, tparams = _pair("qwen2_moe_a2_7b", "float32")
    tree = jax.tree.map(np.asarray, jparams)
    moe = tparams["groups"]["pos0"]["moe"]
    assert set(moe) == {"router", "e_gate", "e_up", "e_down", "s_gate",
                        "s_up", "s_down"}
    for k, v in tree["groups"]["pos0"]["moe"].items():
        assert np.array_equal(moe[k].numpy(), v), k
    assert moe["e_gate"].shape == (tcfg.n_groups, tcfg.n_experts,
                                   tcfg.d_model, tcfg.expert_d_ff)
    tree["groups"]["pos0"]["moe"]["e_up"] = tree["groups"]["pos0"]["moe"][
        "e_up"][:, :-1]
    with pytest.raises(ValueError, match="moe/e_up"):
        params_from_numpy(tree, tcfg, "cpu")
