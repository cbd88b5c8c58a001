"""The port's serving path against the JAX package, on the CPU.

Scheduler pieces (policies, runtime estimator, priority queue) are own
copies and must give JAX's priorities and pop order exactly on one scripted
sequence of arrivals and completions.  The engine, slot pool, samplers and
launcher run on ``device="cpu"`` at scaled-down widths, as
``tests/test_substrate.py::TestServingEngine`` runs the JAX engine.
"""

import numpy as np
import pytest
import torch

from repro.core import estimator as jax_est
from repro.core import policies as jax_pol
from repro.core import queues as jax_q
from repro.core import request as jax_req
from repro_torch.configs import get_config
from repro_torch.core import estimator as t_est
from repro_torch.core import policies as t_pol
from repro_torch.core import queues as t_q
from repro_torch.core import request as t_req
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import scale_down
from repro_torch.serving import Endpoint, ServingEngine, SlotPool
from repro_torch.serving import sampler

# (time, event, fn, value): arrivals push a call, completions feed the
# estimator, pops take the best queued call; ties and an FC horizon cutoff
# (60 s) included
SCRIPT = [
    (0.0, "arrive", "a", None), (0.5, "arrive", "b", None),
    (1.0, "done", "a", 2.0), (1.0, "arrive", "a", None),
    (1.5, "arrive", "c", None), (2.0, "done", "b", 0.5),
    (2.0, "arrive", "b", None), (2.0, "pop", None, None),
    (3.0, "done", "a", 4.0), (3.0, "arrive", "a", None),
    (3.0, "arrive", "c", None), (4.0, "pop", None, None),
    (5.0, "done", "c", 0.5), (5.0, "arrive", "b", None),
    (61.0, "arrive", "a", None), (61.5, "arrive", "c", None),
    (62.0, "pop", None, None), (62.0, "pop", None, None),
    (62.0, "done", "b", 1.0), (63.0, "arrive", "b", None),
    (63.0, "arrive", "b", None), (64.0, "pop", None, None),
]


def _replay(policy_name, est_mod, pol_mod, q_mod, req_mod):
    est = est_mod.RuntimeEstimator()
    pol = pol_mod.make_policy(policy_name)
    q = q_mod.PriorityQueue()
    prios, order, seen = [], [], []
    for i, (t, ev, fn, val) in enumerate(SCRIPT):
        if ev == "arrive":
            req = req_mod.Request(fn=fn, r=t)
            req.r_prime = t
            est.observe_arrival(fn, t)
            q.push(req, pol.priority(req, est, t))
            prios.append(req.priority)
            seen.append(i)
        elif ev == "done":
            est.observe_completion(fn, val)
        else:
            req = q.pop()
            order.append((req.fn, req.r))
        est.recent_count("a", t)
    while q:
        req = q.pop()
        order.append((req.fn, req.r))
    estimates = [(f, est.estimate(f), est.sample_count(f),
                  est.prev_arrival(f), est.recent_count(f, 64.0))
                 for f in "abc"]
    return prios, order, estimates


@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_scheduler_matches_jax(policy):
    want = _replay(policy, jax_est, jax_pol, jax_q, jax_req)
    got = _replay(policy, t_est, t_pol, t_q, t_req)
    assert got == want


def test_queue_is_stable_and_removes():
    q = t_q.PriorityQueue()
    reqs = [t_req.Request(fn=f, r=i) for i, f in enumerate("abcd")]
    for r, p in zip(reqs, (1.0, 0.5, 1.0, 0.5)):
        q.push(r, p)
    assert q.remove(reqs[3]) and not q.remove(reqs[3])
    assert [q.pop().fn for _ in range(len(q))] == ["b", "a", "c"]
    with pytest.raises(IndexError):
        q.pop()


def test_slot_pool_accounting():
    cfg = scale_down(get_config("qwen3_1_7b"))
    pool = SlotPool(cfg, n_slots=3, max_len=32, device="cpu")
    assert pool.cache["groups"]["pos0"]["k"].shape == (2, 3, 32, 4, 16)
    s1 = pool.assign(101)
    s2 = pool.assign(102)
    assert pool.free_slots == 1
    pool.advance(s1, 5)
    pool.advance(s2, 40)
    lengths = pool.lengths_array()
    assert lengths.dtype == torch.int32
    assert int(lengths[s1]) == 5 and int(lengths[s2]) == 32
    assert pool.utilization() == pytest.approx(2 / 3)
    pool.release(s1)
    assert pool.free_slots == 2
    with pytest.raises(AssertionError):
        pool.release(s1)


def test_engine_completes_burst():
    cfg = scale_down(get_config("qwen3_1_7b"))
    eng = ServingEngine([Endpoint("f", cfg, prompt_len=2, gen_len=3)],
                        slots=2, policy="fc", device="cpu")
    ops.reset_launches()
    for _ in range(5):
        eng.submit("f")
    eng.run(max_wall_s=60)
    s = eng.summary()
    assert s["n"] == 5 and s["cold_starts"] == 0
    assert 0 < s["R_p50"] <= s["R_p95"] and np.isfinite(s["R_avg"])
    assert eng.decode_steps == 5 * (2 + 3)
    n = ops.launches()["decode_attention"]
    assert n == {"kernel": 0, "plain": eng.decode_steps * cfg.n_layers}
    for r in eng.completed:
        assert r.start >= r.r_prime and r.finish > r.start


def test_sept_admits_cheap_first():
    cheap = scale_down(get_config("qwen3_1_7b"))
    heavy = scale_down(get_config("deepseek_7b"), layers=4, d_model=128,
                       d_ff=256)
    eng = ServingEngine(
        [Endpoint("cheap", cheap, prompt_len=2, gen_len=2),
         Endpoint("heavy", heavy, prompt_len=2, gen_len=24)],
        slots=1, policy="sept", device="cpu")
    # seed history so SEPT can discriminate
    for _ in range(3):
        eng.estimator.observe_completion("cheap", 0.01)
        eng.estimator.observe_completion("heavy", 1.0)
    eng.submit("heavy")
    eng.submit("cheap")
    eng.submit("cheap")
    eng.run(max_wall_s=60)
    done = [r.fn for r in eng.completed]
    assert done == ["cheap", "cheap", "heavy"]


def test_cold_start_is_measured():
    cfg = scale_down(get_config("qwen3_1_7b"))
    ep = Endpoint("f", cfg, prompt_len=1, gen_len=1)
    eng = ServingEngine([ep], slots=1, policy="fifo", prewarm=False,
                        device="cpu")
    assert not ep.is_warm
    eng.submit("f")
    eng.submit("f")
    eng.run(max_wall_s=60)
    assert eng.cold_starts == 1 and ep.is_warm
    assert [r.cold_start for r in eng.completed] == [True, False]


def test_engine_seed_fixes_the_weights():
    cfg = scale_down(get_config("qwen3_1_7b"))

    def embed(seed):
        ep = Endpoint("f", cfg)
        ServingEngine([ep], seed=seed, device="cpu")
        return ep.params["embed"]

    assert torch.equal(embed(0), embed(0))
    assert not torch.equal(embed(0), embed(1))


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = scale_down(get_config("qwen3_1_7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine([Endpoint("f", cfg)])


def test_launcher_on_cpu(capsys):
    serve.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--requests",
                "4", "--policy", "sept"])
    out = capsys.readouterr().out
    assert "n=4 " in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["rwkv6_3b", "recurrentgemma_9b"])
def test_launcher_serves_the_recurrent_families(arch, capsys):
    """``--arch`` takes both recurrent families: 12 calls complete on the
    CPU, every decode step through the plain recurrences (and, for
    recurrentgemma, the plain decode attention of its window layers)."""
    ops.reset_launches()
    serve.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "n=12 " in out and "device=cpu" in out
    steps = int(out.split("decode_steps=")[1].split()[0])
    cfg = scale_down(get_config(arch))
    per_step = {k: sum(s.kind == k for s in cfg.layer_specs())
                for k in ("attn", "rglru", "rwkv")}
    n = ops.launches()
    assert n["rglru_scan"]["kernel"] == n["rwkv6_scan"]["kernel"] == 0
    # the warm-up calls step too: at least the burst's steps per layer
    assert n["rglru_scan"]["plain"] >= steps * per_step["rglru"]
    assert n["rwkv6_scan"]["plain"] >= steps * per_step["rwkv"]
    assert n["decode_attention"]["plain"] >= steps * per_step["attn"]
    assert (n["rglru_scan"]["plain"] > 0) == (arch == "recurrentgemma_9b")
    assert (n["rwkv6_scan"]["plain"] > 0) == (arch == "rwkv6_3b")


def test_samplers():
    logits = torch.tensor([[0.1, 3.0, -1.0, 2.9], [5.0, 0.0, 0.0, 0.0]])
    assert sampler.greedy(logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    picks = torch.stack([sampler.top_k(logits, g, k=2) for _ in range(50)])
    assert set(picks[:, 0].tolist()) <= {1, 3}
    assert picks.dtype == torch.int32
    a = sampler.temperature(logits, torch.Generator().manual_seed(5), t=0.5)
    b = sampler.temperature(logits, torch.Generator().manual_seed(5), t=0.5)
    assert torch.equal(a, b) and a.shape == (2,)
    cold = sampler.temperature(logits, g, t=1e-6)
    assert cold.tolist() == [1, 0]
