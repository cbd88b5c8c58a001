"""The CUDA ``event_step`` kernel against its plain PyTorch version, on the
card.  A CUDA kernel has no CPU mode, so these tests carry the ``gpu``
marker and skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py

This file imports no JAX, so it runs where only the port is installed.
Tolerance: 0 -- rows ``[:n]`` of start / finish / prio / node are
bit-identical (row ``n`` is the no-op sentinel).  Inputs: buckets filled
from real bursts for all five policies with FC counts on and off, padded to
a power of two (so one cell is an idle padded cell), and the same buckets
with every time rounded to 1/8 s, where events and priorities tie exactly.
The real-burst buckets carry the pull coefficients, all in {0, 1}; the
hand-built buckets of ``_smoke_inputs`` add an FC-ish coefficient of 0.3
and a warm-seeded estimator ring, so inexact products and sums show any
change in the order of operations.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.workload import generate_burst
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event_step kernel is CUDA only")
    return torch.device("cuda")


def _bucket(policy, use_fc, quantum=None):
    cells = []
    for s in range(3):
        reqs = generate_burst(cores=8, intensity=12, seed=s)
        cells.append(tfp._ScanCell(requests=reqs,
                                   feats=tfp._arrival_features(reqs),
                                   cores=4, nodes=2 + s, policy=policy))
    shapes = {c.bucket()[1:] for c in cells}
    key = (2 if use_fc else 0,) + tuple(max(col) for col in zip(*shapes))
    host = tfp._fill_bucket(key, cells)
    if quantum is not None:
        for k in ("t", "p", "cost"):
            host[k] = (np.round(host[k] / quantum) * quantum).astype(
                np.float32)
    return host, tfp._scan_static(key), key[1]


@pytest.mark.gpu
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_kernel_matches_plain_on_card(cuda, policy, use_fc, quantum):
    host, static, n = _bucket(policy, use_fc, quantum)
    assert host["cores"][-1] == 0                  # the padded cell
    inp = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    k0 = ops.KERNEL_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), \
            f"{name} diverged ({policy}, use_fc={use_fc}, q={quantum})"


def _smoke_inputs(use_fc, B=3, n=8, F=2, NN=2, NS=4, W=4, KQ=8, seed=0,
                  quantum=None):
    """Small hand-built bucket (a copy of the JAX package's test input, so
    this file imports no JAX): sorted arrivals, a warm-seeded estimator
    ring, and FIFO / SEPT / FC-ish coefficient rows.  With ``quantum`` every
    time is a multiple of it, so events and priorities tie exactly."""
    rng = np.random.default_rng(seed)
    n1 = n + 1
    inp = {
        "t": np.full((B, n1), np.inf, dtype=np.float32),
        "fnid": np.zeros((B, n1), dtype=np.int32),
        "p": np.zeros((B, n1), dtype=np.float32),
        "cost": np.zeros((B, n1), dtype=np.float32),
        "coef": np.zeros((B, 5), dtype=np.float32),
        "cores": np.zeros(B, dtype=np.int32),
        "nodes": np.ones(B, dtype=np.int32),
        "ring0": np.zeros((B, 1, F, W), dtype=np.float32),
        "rsum0": np.zeros((B, 1, F), dtype=np.float32),
        "rlen0": np.zeros((B, 1, F), dtype=np.int32),
        "rpos0": np.zeros((B, 1, F), dtype=np.int32),
        "cumf": np.zeros((B, n1 if use_fc else 1, F), dtype=np.float32),
        "fn_ev": np.full((B, F, KQ), n, dtype=np.int32),
    }
    coefs = [[1.0, 0.0, 0.0, 0.0, 0.0],      # FIFO
             [0.0, 0.0, 1.0, 0.0, 0.0],      # SEPT
             [0.0, 0.0, 1.0, 0.3, 0.0]]      # FC-ish
    for b in range(B):
        t = np.sort(rng.uniform(0, 2.0, n)).astype(np.float32)
        fn = rng.integers(0, F, n).astype(np.int32)
        p = rng.lognormal(-1, 0.5, n).astype(np.float32)
        cost = 0.001
        if quantum is not None:
            t = np.round(t / quantum) * quantum
            p = np.maximum(np.round(p / quantum), 1) * quantum
            cost = quantum
        inp["t"][b, :n] = t
        inp["fnid"][b, :n] = fn
        inp["p"][b, :n] = p
        inp["cost"][b, :n] = cost
        inp["coef"][b] = coefs[b % len(coefs)]
        inp["cores"][b] = 1 + (b % 2)
        inp["nodes"][b] = 1 + b % NN
        inp["ring0"][b, 0, :, 0] = 0.5
        inp["rsum0"][b, 0, :] = 0.5
        inp["rlen0"][b, 0, :] = 1
        if use_fc:
            for f in range(F):
                inp["cumf"][b, 1:, f] = np.cumsum(fn == f)
        for f in range(F):
            ev = np.nonzero(fn == f)[0]
            inp["fn_ev"][b, f, :len(ev)] = ev
    static = dict(freeze=False, fc_push=False, dyn=False, het=False,
                  hedge=False, cold=False, dup=False, n_nodes=NN,
                  n_slots=NS, window=W, use_fc=use_fc, horizon=1.0,
                  n_steps=2 * n + 2)
    return inp, static, n


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantum", [None, 0.125])
@pytest.mark.parametrize("use_fc", [False, True])
def test_kernel_matches_plain_on_smoke_bucket(cuda, use_fc, quantum, seed):
    kw = {} if quantum is None else dict(B=6, n=24, F=3, NN=3, KQ=32)
    host, static, n = _smoke_inputs(use_fc, seed=seed, quantum=quantum,
                                    **kw)
    assert (host["coef"][:, 3] == np.float32(0.3)).any()
    inp, _, _ = bucket_from_numpy(host, device=cuda)
    clk, ctr = make_planes(inp, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    k0 = ops.KERNEL_LAUNCHES
    ref = ops.event_step(clk, ctr, inp, force="ref", **static)
    got = ops.event_step(clk, ctr, inp, **static)
    torch.cuda.synchronize()
    assert ops.KERNEL_LAUNCHES == k0 + 1
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, name
        assert torch.equal(a[:, :n], b[:, :n]), \
            f"{name} diverged (use_fc={use_fc}, q={quantum}, seed={seed})"
