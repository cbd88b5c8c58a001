"""The compiled decode step's contract, on the CPU: ``decode_step`` with
``pos`` a 0-dim tensor, the serving engine's lanes and the launch counts
kept apart for a captured graph.

On a card the engine captures each lane's step in a CUDA graph
(``tests/test_torch_graph_gpu.py`` holds the replays to the eager step
there); here the same lane code runs eagerly, so what these tests hold is
the lane logic around the graph.  Every comparison is exact
(``torch.equal``): the same operations run on the same inputs.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import LayerSpec, decode_step, init, init_cache
from repro_torch.models import scale_down
from repro_torch.serving import Endpoint, ServingEngine
from repro_torch.serving.kvcache import Lane, zero_cache


def _small(arch, window=None):
    """``arch`` scaled down, the windows of its windowed layers set to
    ``window`` (so a cache longer than it is a ring), and gemma3_27b with
    its 2-layer tail."""
    cfg = scale_down(get_config(arch))
    if window is not None:
        cfg = dataclasses.replace(cfg, period=tuple(
            LayerSpec(s.kind, window if s.window > 0 else s.window, s.moe)
            for s in cfg.period))
    if arch == "gemma3_27b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    return cfg


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# every family the port serves; the windowed ones also with a ring of 8
# that the 14 steps wrap
CASES = [(arch, None) for arch in ARCHS] + [("gemma3_27b", 8),
                                            ("recurrentgemma_9b", 8)]


@pytest.mark.parametrize("arch,window", CASES)
def test_tensor_pos_step_equals_int_pos_step(arch, window):
    cfg = _small(arch, window)
    params = init(cfg, 0, "cpu")
    caches = [init_cache(cfg, 2, 20, device="cpu") for _ in range(2)]
    if window is not None:
        sizes = {c["k"].shape[2] for c in caches[0]["groups"].values()
                 if "k" in c}
        assert window in sizes           # a ring of ``window`` slots
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for pos in range(14):
        a, caches[0] = decode_step(params, cfg, tok, caches[0], pos)
        b, caches[1] = decode_step(params, cfg, tok, caches[1],
                                   torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(a, b), pos
        tok = a.argmax(-1).to(torch.int32)
    for x, y in zip(_leaves(caches[0]), _leaves(caches[1])):
        assert torch.equal(x, y)


def test_pos_must_be_a_scalar():
    cfg = _small("qwen3_1_7b")
    params = init(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="scalar"):
        decode_step(params, cfg, torch.zeros(1, dtype=torch.int32),
                    init_cache(cfg, 1, 8, device="cpu"),
                    torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "gemma3_27b",
                                  "qwen2_moe_a2_7b", "qwen2_vl_7b",
                                  "recurrentgemma_9b", "rwkv6_3b"])
def test_reused_zeroed_lane_equals_a_fresh_cache(arch):
    """A lane that served a call, zeroed for the next one, gives the
    logits of a lane fresh from ``init_cache``, step for step."""
    ep = Endpoint("f", _small(arch), prompt_len=3, gen_len=6,
                  device=torch.device("cpu"))
    ep.warm_up(0, lanes=2)
    assert len(ep.lanes) == 2 and ep.lanes[0].graph is None
    lane = ep.lanes[0]
    for _ in range(9):
        ep.step(lane)
    assert int(lane.pos) == 9
    lane.reset()
    fresh = Lane.new(ep.cfg, ep.cache_len, ep.device)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(lane.cache),
                                                 _leaves(fresh.cache)))
    for i in range(9):
        ep.step(lane)
        ep.step(fresh)
        assert torch.equal(lane.logits, fresh.logits), i
        assert torch.equal(lane.token, fresh.token)
    assert int(lane.pos) == int(fresh.pos) == 9


def test_lane_step_is_the_eager_step():
    """The lane's step is ``decode_step`` at the lane's pos, then its
    greedy token; pos advances by one."""
    cfg = _small("qwen3_1_7b")
    ep = Endpoint("f", cfg, device=torch.device("cpu"))
    ep.warm_up(1)
    lane = ep.lanes[0]
    cache = init_cache(cfg, 1, ep.cache_len, device="cpu")
    tok = torch.zeros((1,), dtype=torch.int32)
    for pos in range(5):
        ep.step(lane)
        want, cache = decode_step(ep.params, cfg, tok, cache, pos)
        assert torch.equal(lane.logits, want)
        tok = want.argmax(-1).to(torch.int32)
        assert torch.equal(lane.token, tok) and int(lane.pos) == pos + 1


def test_zero_cache_zeroes_every_leaf():
    cfg = _small("recurrentgemma_9b")
    cache = init_cache(cfg, 1, 8, device="cpu")
    for leaf in _leaves(cache):
        leaf.fill_(1.5)
    assert zero_cache(cache) is cache
    assert not any(leaf.any() for leaf in _leaves(cache))


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "gemma3_27b",
                                  "qwen2_moe_a2_7b",
                                  "llama4_scout_17b_a16e", "qwen2_vl_7b"])
def test_cpu_engine_completes_the_burst(arch):
    """The launcher's burst (12 calls, 3 of them to the batch endpoint)
    completes with n = 12 and 3 x 28 + 9 x 6 = 138 decode steps, each one
    step of a lane; no replays on the CPU, and each lane is free again.
    The two endpoints share one copy of the weights."""
    short, long_ = serve.make_endpoints(arch, device="cpu")
    assert short.params is long_.params
    eng = ServingEngine([short, long_], slots=2, policy="fc", device="cpu")
    ops.reset_launches()
    s = serve.run_burst(eng, short.name, long_.name, 12, 0.3)
    assert s["n"] == 12 and s["decode_steps"] == 138
    assert eng.replays == {} and eng.kernel_launches() == {}
    assert all(len(ep.lanes) == 2 and not any(lane.busy for lane in ep.lanes)
               for ep in (short, long_))
    assert short.params is long_.params
    n_attn = sum(spec.kind == "attn" for spec in short.cfg.layer_specs())
    # the estimator warm-up's 6 calls step too
    assert (ops.launches()["decode_attention"]["plain"]
            >= s["decode_steps"] * n_attn)


def test_counted_apart_keeps_the_block_out_of_the_counts():
    cfg = _small("recurrentgemma_9b")
    params = init(cfg, 0, "cpu")
    cache = init_cache(cfg, 1, 8, device="cpu")
    ops.reset_launches()
    decode_step(params, cfg, torch.zeros(1, dtype=torch.int32), cache, 0)
    before = ops.launches()
    with ops.counted_apart() as counts:
        decode_step(params, cfg, torch.zeros(1, dtype=torch.int32), cache, 1)
    assert ops.launches() == before
    assert counts["rglru_scan"] == {"kernel": 0, "plain": 2}
    assert counts["decode_attention"] == {"kernel": 0, "plain": 1}
    assert counts["rwkv6_scan"] == {"kernel": 0, "plain": 0}
    assert set(counts) == set(before)


def test_kernel_launches_are_replays_times_captured():
    """The engine's accounting of replayed steps: each endpoint's replays
    times its graph's captured launches, summed by kernel."""
    cfg = _small("qwen3_1_7b")
    a = Endpoint("a", cfg, device=torch.device("cpu"))
    b = Endpoint("b", cfg, device=torch.device("cpu"))
    eng = ServingEngine([a, b], slots=1, device="cpu")
    a.captured = {"decode_attention": 2}
    b.captured = {"decode_attention": 2, "rglru_scan": 3}
    eng.replays = {"a": 5, "b": 7}
    assert eng.kernel_launches() == {"decode_attention": 24,
                                     "rglru_scan": 21}
