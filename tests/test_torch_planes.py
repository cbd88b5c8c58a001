"""The port's carry planes against the JAX package's.

For the base pull carry, ``repro_torch.core.planes`` must give the same
layout (keys, offsets, ``f_len``/``i_len``) as
``repro.core.fastpath._carry_layout`` and byte-equal ``(clk, ctr)`` planes
to ``repro.core.fastpath._make_planes``, with FC pull counts on and off.
Tolerance: none -- offsets are equal and planes byte-equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro_torch.convert import bucket_from_numpy
from repro_torch.core import planes
from torch_threads import one_torch_thread  # noqa: E402,F401

STATE_FLAGS = dict(freeze=False, fc_push=False, dyn=False, het=False,
                   hedge=False, cold=False, dup=False, n_copies=1,
                   fc_ring=1)

# (cells, requests, nodes, slots, functions, window): the hand-built test
# shape and the mega grid's widest bucket (4 nodes x 8 cores, 16 fns)
SHAPES = [(3, 8, 2, 4, 2, 4), (2, 64, 4, 8, 16, 10)]


def _inputs(B, n, NN, NS, F, W, use_fc, seed=0):
    """Bucket inputs with a seeded estimator ring, so the ring segment of
    the planes carries data."""
    rng = np.random.default_rng(seed)
    n1 = n + 1
    t = np.full((B, n1), np.inf, dtype=np.float32)
    t[:, :n] = np.sort(rng.uniform(0, 5, (B, n)), axis=1)
    rlen = rng.integers(0, W + 1, (B, 1, F)).astype(np.int32)
    return {
        "t": t,
        "fnid": rng.integers(0, F, (B, n1)).astype(np.int32),
        "p": rng.uniform(0, 1, (B, n1)).astype(np.float32),
        "cost": np.full((B, n1), 0.06, dtype=np.float32),
        "cnt": np.zeros((B, n1), dtype=np.float32),
        "home0": np.zeros((B, n1), dtype=np.int32),
        "route": np.zeros(B, dtype=np.int32),
        "coef": np.zeros((B, 5), dtype=np.float32),
        "cores": np.full(B, NS, dtype=np.int32),
        "nodes": np.full(B, NN, dtype=np.int32),
        "ring0": rng.uniform(0, 2, (B, 1, F, W)).astype(np.float32),
        "rsum0": rng.uniform(0, 9, (B, 1, F)).astype(np.float32),
        "rlen0": rlen,
        "rpos0": (rlen % W).astype(np.int32),
        "cumf": np.zeros((B, n1 if use_fc else 1, F), dtype=np.float32),
        "fn_ev": np.full((B, F, 8), n, dtype=np.int32),
    }


@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_layout_matches_jax(shape, use_fc):
    B, n, NN, NS, F, W = shape
    inp = _inputs(B, n, NN, NS, F, W, use_fc)
    spec = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
            for k, v in inp.items()}
    ref = jfp._carry_layout(spec, n_nodes=NN, n_slots=NS, window=W,
                            **STATE_FLAGS)
    got = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F)
    assert got.fparts == ref.fparts
    assert got.iparts == ref.iparts
    assert (got.f_len, got.i_len) == (ref.f_len, ref.i_len)


@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_planes_byte_equal(shape, use_fc):
    B, n, NN, NS, F, W = shape
    inp = _inputs(B, n, NN, NS, F, W, use_fc)
    arrs = {k: jnp.asarray(v) for k, v in inp.items()}
    clk_j, ctr_j = jax.vmap(partial(jfp._make_planes, n_nodes=NN,
                                    n_slots=NS, window=W,
                                    **STATE_FLAGS))(arrs)
    tens, _, _ = bucket_from_numpy(inp, device="cpu")
    clk_t, ctr_t = planes.make_planes(tens, n_nodes=NN, n_slots=NS,
                                      window=W)
    assert clk_t.dtype == torch.float32 and ctr_t.dtype == torch.int32
    assert clk_t.numpy().tobytes() == np.asarray(clk_j).tobytes()
    assert ctr_t.numpy().tobytes() == np.asarray(ctr_j).tobytes()


def test_unpack_inverts_pack():
    B, n, NN, NS, F, W = SHAPES[1]
    tens, _, _ = bucket_from_numpy(_inputs(B, n, NN, NS, F, W, True),
                                   device="cpu")
    st0 = planes.make_state0(tens, n_nodes=NN, n_slots=NS, window=W)
    layout = planes.carry_layout(n_nodes=NN, n_slots=NS, window=W, n_fns=F)
    back = layout.unpack(*layout.pack(st0))
    assert set(back) == set(st0)
    for k, v in st0.items():
        assert torch.equal(back[k].reshape(v.shape), v), k
