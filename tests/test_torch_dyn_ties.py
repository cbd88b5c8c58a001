"""Priority ties on the float64 pull kernel's wide path, held to the JAX
oracle on the CPU: the winners the card tests expect are the reference's.

The JAX package scans ``dyn`` buckets in float64 under
``jax.experimental.enable_x64``, which JAX 0.9.0 lacks; ``jax.enable_x64``
is the same context manager, so an autouse fixture aliases it for the tests
of this file alone (nothing under ``src/repro/`` changes).

Contracts (tolerance 0):

* on the EECT burst of ``tests/wide_dispatch_cases.py`` (300 functions on
  2 single-core nodes, a kill after the drain), two bases 2^-52 apart
  merge once ``now`` is added, and the larger base, holding the smaller
  head row, is dispatched first: the port's plain ``event_step`` equals
  the JAX oracle (``_scan_cell_kernel``'s float64 branch) on rows ``[:n]``
  of start, finish, prio and node, in one bucket whose cells put the two
  functions in one group of 32 and in two;
* the same on FIFO under ``dyn``, where every head's priority is ``now``
  and the least head row wins, on 300 functions with a kill that
  re-queues calls;
* the wide plan sizes the group summaries in shared memory (16 bytes a
  group of 32 functions), and in the scratch past one block's.

``tests/test_torch_dyn_gpu.py`` holds the kernel to the plain version on
these buckets, on the card.
"""

import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fastpath as jfp
from repro.core.cluster import ClusterDynamics as JDyn
from repro.core.request import Request as JReq
from repro.kernels import ops as jops
from repro_torch.core import fastpath as tfp
from repro_torch.core.cluster import ClusterDynamics as TDyn
from repro_torch.core.request import Request as TReq
from repro_torch.kernels import ops as tops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from wide_dispatch_cases import (  # noqa: E402
    TIE_CORES,
    TIE_NODES,
    many_fn_requests,
    merged_bases_requests,
)


@pytest.fixture(autouse=True)
def x64_alias(monkeypatch):
    """The JAX package's float64 buckets enter ``jax.experimental.
    enable_x64``; JAX 0.9.0 has it as ``jax.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def _bucket(burst, policy, nodes, cores, dyn):
    """The port's bucket of one cell a burst (``burst(req)`` makes a list of
    requests), its static arguments and key, the key checked against the
    JAX package's."""
    cells = []
    for fp, req, dyn_cls in ((tfp, TReq, TDyn), (jfp, JReq, JDyn)):
        side = []
        for make in burst:
            reqs = make(req)
            side.append(fp._ScanCell(
                requests=reqs, feats=fp._arrival_features(reqs),
                cores=cores, nodes=nodes, policy=policy,
                assignment="pull", dynamics=dyn_cls(**dyn)))
        cells.append(side)
    for t, j in zip(*cells):
        assert t.bucket() == j.bucket()
    key = tuple(max(col) for col in zip(*{c.bucket() for c in cells[0]}))
    return tfp._fill_bucket(key, cells[0]), tfp._scan_static(key), key


def _jax_rows(host, static, key):
    """The JAX oracle on the port's numpy bucket: rows (start, finish,
    prio, node) resolved last dispatch first, as its bucket runner does."""
    inp = dict(host)
    B, n1 = host["t"].shape
    inp.update(cnt=np.zeros((B, n1)), home0=np.zeros((B, n1), np.int32),
               route=np.zeros(B, np.int32))
    st = {k: static[k] for k in ("n_nodes", "n_slots", "window",
                                 "freeze", "fc_push", "dyn", "het",
                                 "hedge", "cold", "dup", "fc_ring")}
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in inp.items()}
        clk, ctr = jax.vmap(partial(jfp._make_planes, n_copies=1,
                                    **st))(arrs)
        out = jops.event_step(clk, ctr, arrs, force="ref", n_copies=1,
                              n_ep=key[8], use_fc=static["use_fc"],
                              horizon=static["horizon"],
                              n_steps=static["n_steps"], **st)
        out = jax.tree_util.tree_map(np.asarray, out)
    (j_s, es_s, fs_s, pj_s, kd_s), _ = out
    rows = [np.zeros((B, n1)), np.zeros((B, n1)), np.zeros((B, n1)),
            np.zeros((B, n1), dtype=np.int32)]
    for b in range(B):
        for r, v in zip(rows, (es_s, fs_s, pj_s, kd_s)):
            r[b, j_s[b]] = v[b]
    return np.asarray(clk), np.asarray(ctr), rows


def _plain_equals_oracle(host, static, key):
    clk, ctr, want = _jax_rows(host, static, key)
    tens = {k: torch.from_numpy(v) for k, v in host.items()}
    got = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)), tens, **static)
    n = key[1]
    for what, a, b in zip(("start", "finish", "prio", "node"), want, got):
        np.testing.assert_array_equal(a[:, :n], b.numpy()[:, :n],
                                      err_msg=what)
    return [g.numpy() for g in got[:4]]


def test_eect_merged_bases_equal_the_oracle():
    host, static, key = _bucket(
        [partial(merged_bases_requests, same_group=s) for s in (True, False)],
        "eect", TIE_NODES, TIE_CORES, dict(fail=((0, 1e6),)))
    assert static["dyn"] and key[4] == 512
    start, finish, prio, _ = _plain_equals_oracle(host, static, key)
    # rows 4 and 5: B's and A's second calls.  B's (base 1 + 2^-52) went
    # first, when row 2's long call ended, at the priority A's (base 1)
    # had at that clock
    assert host["p"][0, 0] == 1.0 + 2.0 ** -52 and host["p"][0, 1] == 1.0
    now = finish[:2, 2]
    assert (start[:2, 4] < start[:2, 5]).all()
    assert (prio[:2, 4] == (1.0 + 2.0 ** -52) + now).all()
    assert (prio[:2, 4] == 1.0 + now).all()


def test_fifo_equal_bases_with_a_kill_equal_the_oracle():
    host, static, key = _bucket(
        [partial(many_fn_requests, n=420, n_fns=300, seed=s, span=12.0)
         for s in range(2)],
        "fifo", 3, 2, dict(fail=((1, 4.0),), failure_detect_s=0.5))
    assert static["dyn"] and key[4] == 512
    _plain_equals_oracle(host, static, key)


def test_wide_plan_sizes_the_group_summaries():
    kw = dict(n1=4097, n_nodes=128, n_slots=1, window=10, f64=True,
              dyn=True)
    planet = tops.event_step_plan(n_fns=16_384, stream=True, **kw)
    assert planet["wide"] and planet["cell_bytes"] == 16 * 512
    narrow = tops.event_step_plan(n_fns=16, n1=4097, n_nodes=4, n_slots=8,
                                  window=10, f64=True, dyn=True)
    assert not narrow["wide"]
    # past one block's shared memory the summaries move to the scratch
    huge_f = 32 * (tops.SMEM_BLOCK_BYTES // 16 + 1)
    huge = tops.event_step_plan(n_fns=huge_f, **kw)
    fits = tops.event_step_plan(n_fns=huge_f - 32, **kw)
    assert huge["cell_bytes"] == 0 and fits["cell_bytes"] > 0
    # 32 more functions: their rings (2 words an entry), one more entry
    # of each of the 16 lane arrays a function, their bases (2 words),
    # and the summaries of every group
    assert huge["scratch_words"] - fits["scratch_words"] == (
        2 * 32 * 10 + 32 * 16 + 2 * 32 + 4 * (huge_f // 32))
