"""The port's ``event_step`` against the JAX oracle.

``repro_torch.kernels.ops.event_step`` on CPU tensors runs the plain PyTorch
version; it must agree with ``repro.kernels.ops.event_step(force="ref")``
(the jnp oracle the JAX package's own tests and CPU runs use) on the same
inputs, made with numpy from a seed and carried across with
``repro_torch.convert.bucket_from_numpy``.

Tolerance: 0.  Rows ``[:n]`` of start / finish / prio / node are
bit-identical; row ``n`` is the no-op sentinel both sides scribble into and
is never compared.

Inputs: hand-built buckets of the shape of the JAX package's
``tests/test_event_step.py::_smoke_inputs``, buckets filled from real
bursts for all five policies with FC counts on and off (padded to a power
of two, so they include padded cells with ``cores=0``), and buckets whose
times are multiples of 1/8 s, where arrivals tie completions and priorities
tie exactly.  The CUDA kernel is held against the plain version in
``tests/test_torch_kernel_gpu.py``, on the card.
"""

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro.kernels import ops as jops
from repro.kernels.event_step import event_step_supported as jax_supported
from repro_torch.convert import bucket_from_numpy
from repro_torch.core import fastpath as tfp
from repro_torch.core.planes import make_planes
from repro_torch.core.workload import generate_burst
from repro_torch.kernels import ops as tops
from repro_torch.kernels.event_step import event_step_supported

BASE_FLAGS = dict(freeze=False, use_fc=False, fc_push=False, dyn=False,
                  het=False, hedge=False, cold=False, dup=False)
FEATURES = ("freeze", "fc_push", "dyn", "het", "hedge", "cold", "dup")


def _smoke_inputs(use_fc, B=3, n=8, F=2, NN=2, NS=4, W=4, KQ=8, seed=0,
                  quantum=None):
    """Small hand-built bucket (a copy of the JAX package's test input):
    sorted arrivals, a warm-seeded estimator ring, and FIFO / SEPT /
    FC-ish coefficient rows.  With ``quantum`` every time is a multiple of
    it, so events and priorities tie exactly."""
    rng = np.random.default_rng(seed)
    n1 = n + 1
    inp = {
        "t": np.full((B, n1), np.inf, dtype=np.float32),
        "fnid": np.zeros((B, n1), dtype=np.int32),
        "p": np.zeros((B, n1), dtype=np.float32),
        "cost": np.zeros((B, n1), dtype=np.float32),
        "cnt": np.zeros((B, n1), dtype=np.float32),
        "home0": np.zeros((B, n1), dtype=np.int32),
        "coef": np.zeros((B, 5), dtype=np.float32),
        "cores": np.zeros(B, dtype=np.int32),
        "nodes": np.ones(B, dtype=np.int32),
        "route": np.zeros(B, dtype=np.int32),
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
    plane_flags = dict(n_nodes=NN, n_slots=NS, window=W)
    static = dict(BASE_FLAGS, **plane_flags, use_fc=use_fc, n_copies=1,
                  n_ep=1, fc_ring=1, horizon=1.0, n_steps=2 * n + 2)
    return inp, static, n


def _jax_step(inp, static):
    """The JAX oracle on a numpy bucket: returns (clk, ctr) and the four
    output rows as numpy arrays."""
    full = dict(inp)
    n1 = inp["t"].shape[1]
    B = inp["t"].shape[0]
    # the oracle reads the push-only inputs too; pull buckets leave them 0
    full.setdefault("cnt", np.zeros((B, n1), dtype=np.float32))
    full.setdefault("home0", np.zeros((B, n1), dtype=np.int32))
    full.setdefault("route", np.zeros(B, dtype=np.int32))
    arrs = {k: jnp.asarray(v) for k, v in full.items()}
    plane_kw = {k: static[k] for k in ("n_nodes", "n_slots", "window",
                                       "n_copies", "fc_ring")}
    plane_kw.update({k: v for k, v in BASE_FLAGS.items() if k != "use_fc"})
    clk, ctr = jax.vmap(partial(jfp._make_planes, **plane_kw))(arrs)
    out = jops.event_step(clk, ctr, arrs, force="ref", **static)
    return np.asarray(clk), np.asarray(ctr), [np.asarray(o) for o in out[:4]]


def _torch_step(inp, clk, ctr, static):
    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    out = tops.event_step(clk_t, ctr_t, tens, **static)
    assert out[4] == {}
    return [o.numpy() for o in out[:4]]


def _assert_rows_equal(ref, got, n, what):
    for name, a, b in zip(("start", "finish", "prio", "node"), ref, got):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a[:, :n], b[:, :n],
                                      err_msg=f"{name} diverged ({what})")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_fc", [False, True])
def test_smoke_bucket_bit_identical(use_fc, seed):
    inp, static, n = _smoke_inputs(use_fc, seed=seed)
    clk, ctr, ref = _jax_step(inp, static)
    _assert_rows_equal(ref, _torch_step(inp, clk, ctr, static), n,
                       f"use_fc={use_fc}, seed={seed}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_fc", [False, True])
def test_exact_ties_bit_identical(use_fc, seed):
    inp, static, n = _smoke_inputs(use_fc, B=6, n=24, F=3, NN=3, KQ=32,
                                   seed=seed, quantum=0.125)
    # ties must really occur: repeated arrival times within a cell
    assert any(len(np.unique(r[:n])) < n for r in inp["t"])
    clk, ctr, ref = _jax_step(inp, static)
    _assert_rows_equal(ref, _torch_step(inp, clk, ctr, static), n,
                       f"quantized, use_fc={use_fc}, seed={seed}")


def _burst_bucket(policy, use_fc, nodes, seeds=(0, 1, 2)):
    """A filled bucket of three real-burst cells (padded to four: the
    fourth is an idle cell with cores=0), with FC counts forced on or
    off."""
    cells = []
    for s in seeds:
        reqs = generate_burst(cores=4, intensity=8, seed=s)
        cells.append(tfp._ScanCell(requests=reqs,
                                   feats=tfp._arrival_features(reqs),
                                   cores=4, nodes=nodes, policy=policy))
    (shape,) = {c.bucket()[1:] for c in cells}
    key = (2 if use_fc else 0,) + shape
    inp = tfp._fill_bucket(key, cells)
    _, n_b, nodes_b, slots_b, _, _, window = key[:7]
    static = dict(BASE_FLAGS, n_nodes=nodes_b, n_slots=slots_b,
                  window=window, use_fc=use_fc, n_copies=1, n_ep=1,
                  fc_ring=1, horizon=60.0, n_steps=2 * n_b)
    return inp, static, n_b


@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_burst_bucket_bit_identical(policy, use_fc):
    inp, static, n = _burst_bucket(policy, use_fc, nodes=2)
    assert inp["cores"][-1] == 0            # the padded cell
    clk, ctr, ref = _jax_step(inp, static)
    got = _torch_step(inp, clk, ctr, static)
    _assert_rows_equal(ref, got, n, f"{policy}, use_fc={use_fc}")
    # every real request was dispatched once, onto a real node
    for b in range(3):
        m = np.isfinite(inp["t"][b, :n])
        assert (got[1][b, :n][m] > got[0][b, :n][m]).all()
        assert (got[3][b, :n][m] < 2).all()


def test_supported_matrix_equals_jax():
    for bits in itertools.product([False, True], repeat=len(FEATURES) + 2):
        flags = dict(zip(FEATURES + ("use_fc", "stream"), bits))
        assert event_step_supported(**flags) == jax_supported(**flags), flags


@pytest.mark.parametrize("feat", FEATURES + ("stream", "res"))
def test_unsupported_flags_raise(feat):
    inp, static, _ = _smoke_inputs(False)
    clk, ctr, _ = _jax_step(inp, static)
    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    with pytest.raises(NotImplementedError):
        tops.event_step(clk_t, ctr_t, tens, **{**static, feat: True})


def test_dispatch_counts_and_force():
    inp, static, _ = _smoke_inputs(True)
    clk, ctr, _ = _jax_step(inp, static)
    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    k0, r0 = tops.KERNEL_LAUNCHES, tops.REF_LAUNCHES
    tops.event_step(clk_t, ctr_t, tens, **static)
    tops.event_step(clk_t, ctr_t, tens, force="ref", **static)
    assert (tops.KERNEL_LAUNCHES, tops.REF_LAUNCHES) == (k0, r0 + 2)
    with pytest.raises(ValueError):
        tops.event_step(clk_t, ctr_t, tens, force="pallas", **static)
    assert tops.KERNEL_LAUNCHES == k0


def test_planes_left_unchanged():
    inp, static, _ = _smoke_inputs(True)
    tens, _, _ = bucket_from_numpy(inp, device="cpu")
    clk, ctr = make_planes(tens, n_nodes=static["n_nodes"],
                           n_slots=static["n_slots"],
                           window=static["window"])
    clk0, ctr0 = clk.clone(), ctr.clone()
    tops.event_step(clk, ctr, tens, **static)
    assert torch.equal(clk, clk0) and torch.equal(ctr, ctr0)
