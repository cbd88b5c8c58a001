"""The serving engine's captured decode step against the eager one, on the
card.  CUDA graphs exist only there, so these tests carry the ``gpu``
marker and skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_graph_gpu.py

This file imports no JAX, so it runs where only the port is installed.

For each family the port serves, at a small size whose widths the kernels
take (``d_model`` 256 and 4 heads: head_dim 64): an endpoint captures its
step in two lanes (``Endpoint.warm_up``), and the logits of every replay
must equal those of ``decode_step`` called eagerly with a tensor ``pos``
on a fresh cache fed the same tokens, exactly (``torch.equal``: the same
kernels and matrix products run in the same order on the same inputs),
over 12 steps (past the ring of 8 in the windowed cases), after the lane is
zeroed for another call, and in the second lane.  Replays add nothing to
the launch counts; the graph's captured launches are one per layer of each
kernel's kind, and no plain version.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import LayerSpec, decode_step, init_cache
from repro_torch.models import scale_down
from repro_torch.serving import Endpoint, ServingEngine

KIND_KERNEL = {"attn": "decode_attention", "rglru": "rglru_scan",
               "rwkv": "rwkv6_scan"}
STEPS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels are "
                    "CUDA only")
    return torch.device("cuda")


def _small(arch, window=None, dtype="bfloat16"):
    """``arch`` at d_model 256, 4 heads of 64 (the kernels' widths), its
    windowed layers' window set to ``window``, gemma3_27b with its tail."""
    cfg = scale_down(get_config(arch), d_model=256, n_heads=4, d_ff=512)
    if window is not None:
        cfg = dataclasses.replace(cfg, period=tuple(
            LayerSpec(s.kind, window if s.window > 0 else s.window, s.moe)
            for s in cfg.period))
    if arch == "gemma3_27b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    return dataclasses.replace(cfg, dtype=dtype)


def _eager(ep, tokens):
    """Logits of ``decode_step`` run eagerly from a fresh cache, step i fed
    ``tokens[i]``, pos a tensor on the card."""
    cache = init_cache(ep.cfg, 1, ep.cache_len, device=ep.device)
    out = []
    for i, tok in enumerate(tokens):
        logits, cache = decode_step(
            ep.params, ep.cfg, tok, cache,
            torch.tensor(i, dtype=torch.int32, device=ep.device))
        out.append(logits)
    return out


def _replay(ep, lane):
    """STEPS replays of ``lane`` from a zeroed lane: (logits, the tokens
    each step was fed)."""
    lane.reset()
    logits, fed = [], []
    for _ in range(STEPS):
        fed.append(lane.token.clone())
        ep.step(lane)
        logits.append(lane.logits.clone())
    return logits, fed


CASES = ([(arch, None, "bfloat16") for arch in ARCHS]
         + [("gemma3_27b", 8, "bfloat16"), ("recurrentgemma_9b", 8,
                                           "bfloat16"),
            ("qwen3_1_7b", None, "float32"), ("rwkv6_3b", None, "float32")])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,window,dtype", CASES)
def test_replayed_step_equals_the_eager_step(cuda, arch, window, dtype):
    cfg = _small(arch, window, dtype)
    ep = Endpoint("f", cfg, prompt_len=6, gen_len=6, device=cuda)
    ops.reset_launches()
    ep.warm_up(0, lanes=2)
    assert all(lane.graph is not None for lane in ep.lanes)
    per_layer = {}
    for spec in cfg.layer_specs():
        k = KIND_KERNEL[spec.kind]
        per_layer[k] = per_layer.get(k, 0) + 1
    assert ep.captured == per_layer
    counts = ops.launches()
    runs = [_replay(ep, ep.lanes[0]), _replay(ep, ep.lanes[0]),
            _replay(ep, ep.lanes[1])]
    torch.cuda.synchronize()
    assert ops.launches() == counts         # replays add nothing
    logits, fed = runs[0]
    want = _eager(ep, fed)
    for got, tokens in runs:
        assert all(torch.equal(a, b) for a, b in zip(tokens, fed))
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a.float()).all()
            assert torch.equal(a, b), (i, float((a.float() - b.float())
                                                .abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_9b", "rwkv6_3b"])
def test_burst_launches_are_replays_times_captured(cuda, arch):
    """The launcher's burst on the card: every decode step one replay,
    the kernel launches replays times the captured ones, no plain version
    and no eager kernel launch during the burst."""
    cfg = _small(arch)
    short = Endpoint(f"{arch}-chat", cfg, prompt_len=2, gen_len=4)
    long_ = Endpoint(f"{arch}-batch", cfg, prompt_len=4, gen_len=24)
    eng = ServingEngine([short, long_], slots=2, policy="fc", device=cuda)
    for _ in range(3):
        eng.submit(short.name)
        eng.submit(long_.name)
    eng.run(max_wall_s=120)
    eng.completed.clear()
    replays0, steps0 = dict(eng.replays), eng.decode_steps
    ops.reset_launches()
    for i in range(12):
        eng.submit(long_.name if i < 3 else short.name)
    eng.run(max_wall_s=120)
    assert eng.summary()["n"] == 12
    replays = {k: v - replays0.get(k, 0) for k, v in eng.replays.items()}
    assert sum(replays.values()) == eng.decode_steps - steps0 == 138
    assert all(v == {"kernel": 0, "plain": 0}
               for v in ops.launches().values())
    launched = {}
    for name, n in replays.items():
        for k, v in eng.endpoints[name].captured.items():
            launched[k] = launched.get(k, 0) + n * v
    per_step = sum(short.captured.values())
    assert sum(launched.values()) == 138 * per_step
    assert serve.make_endpoints(arch)[0].cfg.name == cfg.name
