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
from repro_torch.kernels.event_step import (event_step_supported,
                                            fc_prefix_counts)
from torch_threads import one_torch_thread  # noqa: E402,F401

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
    """The port's scope is the JAX package's Pallas scope (base pull) plus
    the frozen-priority regime -- ``freeze``, with or without ``fc_push``,
    capacity dynamics (``dyn``), node speeds (``het``) and cold starts
    (``cold``), without the pull FC counts (``tests/test_torch_freeze_
    scan.py`` and ``tests/test_torch_freeze64_scan.py`` hold that regime
    to the JAX oracle), there with or without hedging (``hedge``; its
    racing copies ``dup`` without ``dyn``; ``tests/test_torch_hedge_
    scan.py``) -- and the pull regime with ``dyn``, ``het`` and ``cold``,
    with or without FC counts (``tests/test_torch_dyn_scan.py``,
    ``tests/test_torch_cold_scan.py``), each with or without the chunked
    stream (``tests/test_torch_stream_scan.py``,
    ``tests/test_torch_freeze_stream_scan.py``).  Hedging under pull and
    the stream beside duplicate hedging stay out."""
    others = ("hedge", "dup")
    for bits in itertools.product([False, True], repeat=len(FEATURES) + 2):
        flags = dict(zip(FEATURES + ("use_fc", "stream"), bits))
        frozen = (flags["freeze"] and not flags["use_fc"]
                  and not (flags["stream"] and flags["dup"])
                  and (not flags["dup"]
                       or (flags["hedge"] and not flags["dyn"])))
        pull = (not flags["freeze"] and not flags["fc_push"]
                and not any(flags[k] for k in others))
        pull64 = pull and (flags["dyn"] or flags["het"] or flags["cold"])
        pull_stream = pull and flags["stream"]
        assert event_step_supported(**flags) == (
            jax_supported(**flags) or frozen or pull64 or pull_stream), flags


def _freeze64_equals_jax(feat):
    """A push bucket of two real-burst cells with ``feat`` (capacity
    dynamics, node speeds or cold starts) through the port's
    ``event_step`` on the CPU and the JAX oracle in float64: rows ``[:n]``
    and the summary bit-identical."""
    from repro_torch.core import sweep as tsweep

    kw = {"dyn": dict(fail_spec=((0, 5.0),), autoscale=True,
                      provision_delay=2.0, scale_up=1.0, max_nodes=3),
          "het": dict(degrade=((0, 1.0, 300.0, 5.0),)),
          "cold": dict(warm=False)}[feat]
    cells = []
    for s in range(2):
        c = tsweep.SweepCell(policy="sept", nodes=2, cores=2, intensity=10,
                             seed=s, assignment="push", **kw)
        reqs = tsweep.make_workload(c)
        cells.append(tfp._ScanCell(
            requests=reqs, feats=tfp._arrival_features(reqs), cores=2,
            nodes=2, policy="sept", assignment="push", warm=c.warm,
            dynamics=tsweep._cell_dynamics(c),
            profile=tsweep._cell_profile(c)))
    key = tuple(max(col) for col in zip(*{c.bucket() for c in cells}))
    host, static = tfp._fill_bucket(key, cells), tfp._scan_static(key)
    assert static["freeze"] and static[feat]
    seg = {k: static[k] for k in ("n_nodes", "n_slots", "window", "freeze",
                                  "fc_push", "dyn", "het", "hedge", "cold",
                                  "dup", "fc_ring")}
    with jax.enable_x64():
        arrs = {k: jnp.asarray(v) for k, v in host.items()}
        clk, ctr = jax.vmap(partial(jfp._make_planes, n_copies=1,
                                    **seg))(arrs)
        want = jax.tree_util.tree_map(np.asarray, jops.event_step(
            clk, ctr, arrs, force="ref", n_copies=1, n_ep=key[8],
            use_fc=False, horizon=static["horizon"],
            n_steps=static["n_steps"], **seg))
    got = tops.event_step(torch.from_numpy(np.array(clk)),
                          torch.from_numpy(np.array(ctr)),
                          {k: torch.from_numpy(v) for k, v in host.items()},
                          **static)
    n = key[1]
    if feat == "dyn":
        (j_s, es_s, fs_s, _, _), summ = want
        rows = [np.zeros_like(es_s[:, :n + 1]) for _ in range(2)]
        for b in range(len(j_s)):
            for r, v in zip(rows, (es_s, fs_s)):
                r[b, j_s[b]] = v[b]
        rows += [summ["prio"], summ["node"]]
    else:
        rows, summ = list(want[:4]), want[4]
    for a, b in zip(rows, got[:4]):
        np.testing.assert_array_equal(np.asarray(a)[:, :n], b.numpy()[:, :n])
    assert bool(got[4]) == (feat != "het")    # het adds no summary
    for k, v in got[4].items():
        np.testing.assert_array_equal(np.asarray(summ[k]), v.numpy())


@pytest.mark.parametrize("feat", FEATURES + ("stream", "res"))
def test_unsupported_flags_raise(feat):
    inp, static, _ = _smoke_inputs(False)
    clk, ctr, _ = _jax_step(inp, static)
    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    flags = {feat: True}
    if feat == "freeze":
        # the frozen-priority regime alone is in scope; with the pull FC
        # counts, which no frozen bucket carries, it is not
        flags["use_fc"] = True
    if feat in ("dyn", "het", "cold"):
        # capacity dynamics, node speeds and cold starts are in scope under
        # pull and, since the float64 frozen-priority scan, under freeze:
        # that call runs and equals the JAX oracle; with the resilience
        # segment, still not ported, it raises
        _freeze64_equals_jax(feat)
        flags.update(freeze=True, res=True)
    if feat == "stream":
        # the chunked stream is in scope under pull and the frozen-priority
        # regime; beside duplicate hedging, as in the JAX package, it is
        # not
        flags.update(freeze=True, hedge=True, dup=True)
    with pytest.raises(NotImplementedError):
        tops.event_step(clk_t, ctr_t, tens, **{**static, **flags})


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


# -- a test-side mirror of the CUDA kernel's rules ---------------------------
#
# csrc/event_step.cu does not run the plain version's arithmetic in the
# plain version's way: it reduces over order-preserving 32-bit keys of the
# floats (-0.0 taken as +0.0) with first-index or least-event-index ties,
# and it keeps the FC window as a running pointer k0 with integer counts
# per function instead of reading cumf.  ``_mirror_scan`` is the plain
# version with exactly those rules swapped in, run on the CPU; it must
# equal the plain version and the JAX oracle bit for bit (tolerance 0), so
# the rules are held here where the kernel cannot run.

NO_KEY = 0xFFFFFFFF                 # an empty queue: above every float's key
SIGN = 0x80000000


def _order_key(x):
    """float32 -> int64 key in [0, 2^32) with the floats' order; -0.0 and
    +0.0 get one key, as the comparisons treat them."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & NO_KEY
    u = torch.where(u == SIGN, 0, u)
    return torch.where(u >= SIGN, NO_KEY - u, u | SIGN)


def _key_float(k):
    """Inverse of ``_order_key`` (a zero comes back as +0.0)."""
    u = torch.where(k >= SIGN, k & (SIGN - 1), NO_KEY - k)
    u = torch.where(u >= SIGN, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def _first(mask):
    """Index of the first True of each row (a ballot and ffs); 0 if none."""
    idx = torch.arange(mask.shape[1], dtype=torch.int64)[None]
    first = torch.where(mask, idx, mask.shape[1]).min(1).values
    return torch.where(first == mask.shape[1], 0, first)


def _mirror_scan(inp, clk, ctr, static):
    """The kernel's rules on numpy inputs: returns the four output rows
    (the sentinel row n never written) and counts of the cases met."""
    from repro_torch.core.planes import carry_layout

    tens, clk_t, ctr_t = bucket_from_numpy(inp, clk, ctr, device="cpu")
    t, fnid, p, cost = (tens["t"], tens["fnid"].long(), tens["p"],
                        tens["cost"])
    coef, fn_ev = tens["coef"], tens["fn_ev"].long()
    cores, nodes = tens["cores"].long(), tens["nodes"].long()
    NN, NS, W = static["n_nodes"], static["n_slots"], static["window"]
    use_fc, horizon = static["use_fc"], static["horizon"]
    B, n1 = t.shape
    n = n1 - 1
    F, kq = fn_ev.shape[1], fn_ev.shape[2]
    st = {k: v.clone() for k, v in carry_layout(
        n_nodes=NN, n_slots=NS, window=W, n_fns=F).unpack(
            clk_t, ctr_t).items()}
    ai, head = st["ai"].long(), st["head"].long()
    fin_s, idx_s = st["fin_s"].reshape(B, -1), st["idx_s"].reshape(
        B, -1).long()
    busy, chan = st["busy"].long(), st["chan"]
    ring, rsum = st["ring"][:, 0], st["rsum"][:, 0]
    rlen, rpos = st["rlen"][:, 0].long(), st["rpos"][:, 0].long()
    last_t, prev_t = st["last_t"][:, 0], st["prev_t"][:, 0]
    narr = st["narr"][:, 0].long()
    rows = torch.arange(B)
    fn_ids = torch.arange(F)[None]
    node_ids = torch.arange(NN)[None]
    slot_ids = torch.arange(NN * NS)[None]
    inf = torch.tensor(float("inf"))
    c0, c1, c2, c3 = (coef[:, i:i + 1] for i in range(4))
    real = torch.isfinite(t)
    # FC: k0 = #{t <= now - horizon}, moved in place; cnt = C(ai) - C(k0)
    # with C(k) the calls of f among the real rows before k
    k0 = torch.zeros(B, dtype=torch.int64)
    cnt = torch.zeros(B, F, dtype=torch.int64)
    for b in range(B):
        for i in range(int(ai[b])):
            cnt[b, fnid[b, i]] += int(real[b, i])
    n_real = real.sum(1)
    outs = [torch.zeros(B, n1) for _ in range(3)] + [
        torch.zeros(B, n1, dtype=torch.int32)]
    seen = dict(signed_zero_ties=0, negative_best=0, k0_at_tail=0,
                k0_past_ai=0, k0_back=0, slot_ties=0, node_ties=0,
                head_ties=0, window_idle=0)

    def move(mask, step):
        """k0 passes one row where ``mask`` (step +1) or steps back over
        one (step -1); the row's call leaves or re-enters the window."""
        nonlocal k0
        at = k0 if step > 0 else k0 - 1
        at = at.clamp(0, n)
        m = mask & real[rows, at]
        cnt[rows[m], fnid[rows, at][m]] -= step
        k0 = k0 + step * mask.long()

    for _ in range(static["n_steps"]):
        # -- event selection by keys: the first slot of the least key
        fk = _order_key(fin_s)
        cmin = fk.min(1).values
        seen["slot_ties"] += int(((fk == cmin[:, None]).sum(1) > 1).sum())
        kflat = _first(fk == cmin[:, None])
        t_c = _key_float(cmin)
        t_a = t[rows, ai.clamp(max=n)]
        do_arr = t_a <= t_c
        now = torch.where(do_arr, t_a, t_c)
        live = now != inf
        if not bool(live.any()):
            break
        arr, comp = do_arr & live, ~do_arr & live

        # -- completion (the plain version's arithmetic)
        j_done = idx_s[rows, kflat]
        f_done = fnid[rows, j_done]
        m_cf = (fn_ids == f_done[:, None]) & comp[:, None]
        pos = rpos[rows, f_done]
        v = p[rows, j_done]
        full = rlen[rows, f_done] == W
        old = torch.where(full, ring[rows, f_done, pos], 0.0)
        rsum = torch.where(m_cf, rsum + v[:, None] - old[:, None], rsum)
        ring = torch.where(m_cf[:, :, None]
                           & (torch.arange(W)[None, None]
                              == pos[:, None, None]), v[:, None, None], ring)
        rlen = torch.where(m_cf & ~full[:, None], rlen + 1, rlen)
        rpos = torch.where(m_cf, (rpos + 1) % W, rpos)
        busy = busy - ((node_ids == (kflat // NS)[:, None])
                       & comp[:, None]).long()
        fin_s = torch.where((slot_ids == kflat[:, None]) & comp[:, None],
                            inf, fin_s)

        # -- arrival: the count of its function grows as ai passes its row
        f_i = fnid[rows, ai.clamp(max=n)]
        m_af = (fn_ids == f_i[:, None]) & arr[:, None]
        prev_t = torch.where(m_af, torch.where(
            narr[rows, f_i] == 0, now, last_t[rows, f_i])[:, None], prev_t)
        last_t = torch.where(m_af, now[:, None], last_t)
        narr = narr + m_af.long()
        cnt = cnt + m_af.long()
        ai = ai + arr.long()

        # -- dispatch: first node of the greatest free count ...
        fs = torch.where(node_ids < nodes[:, None], cores[:, None] - busy,
                         -1)
        fmax = fs.max(1).values
        seen["node_ties"] += int(((fs == fmax[:, None]).sum(1) > 1).sum())
        k_d = _first(fs == fmax[:, None])
        valid = head < narr
        # -- the FC window's running pointer, moved only where a call can be
        # dispatched (the counts are read nowhere else; lim never falls
        # unless costs are negative, and the pointer moves both ways)
        if use_fc:
            lim = now - horizon
            open_ = live & valid.any(1) & (busy[rows, k_d] < cores)
            seen["window_idle"] += int((live & ~open_).sum())
            while True:
                fwd = open_ & (k0 < n) & (t[rows, k0.clamp(max=n)] <= lim)
                if not bool(fwd.any()):
                    break
                move(fwd, 1)
            while True:
                back = open_ & (k0 > 0) & (
                    t[rows, (k0 - 1).clamp(min=0)] > lim)
                if not bool(back.any()):
                    break
                seen["k0_back"] += int(back.sum())
                move(back, -1)
            seen["k0_at_tail"] += int((open_ & (k0 == n_real)).sum())
            seen["k0_past_ai"] += int((open_ & (k0 > ai)).sum())
            w_est = c2 + c3 * cnt.to(torch.float32)
        else:
            w_est = c2

        # ... pulls the head of least key, then of least event index
        est = torch.where(rlen > 0, rsum / rlen.clamp(min=1).float(), 0.0)
        idx_f = fn_ev.gather(2, head.clamp(max=kq - 1)[:, :, None])[:, :, 0]
        prio_f = c0 * t.gather(1, idx_f) + (c1 * prev_t + w_est * est)
        pk = torch.where(valid, _order_key(prio_f), NO_KEY)
        pmin = pk.min(1).values
        at_min = pk == pmin[:, None]
        zero = at_min & (prio_f == 0)
        seen["signed_zero_ties"] += int(
            (live & (zero & torch.signbit(prio_f)).any(1)
             & (zero & ~torch.signbit(prio_f)).any(1)).sum())
        seen["head_ties"] += int((live & (at_min.sum(1) > 1)
                                  & (pmin != NO_KEY)).sum())
        j = torch.where(at_min, idx_f, n1).min(1).values
        j = torch.where(pmin == NO_KEY, n, j)
        win = _first(at_min & (idx_f == j[:, None]))
        pv = prio_f[rows, win]
        can = live & (busy[rows, k_d] < cores) & (j < n)
        seen["negative_best"] += int((can & (pv < 0)).sum())
        jj = j.clamp(max=n)
        exec_start = torch.maximum(now, chan[rows, k_d]) + cost[rows, jj]
        fin_j = exec_start + p[rows, jj]
        node_slots = fin_s.reshape(B, NN, NS)[rows, k_d]
        free = torch.isinf(node_slots) & (torch.arange(NS)[None]
                                          < cores[:, None])
        se = k_d * NS + _first(free)
        m_se = (slot_ids == se[:, None]) & can[:, None]
        fin_s = torch.where(m_se, fin_j[:, None], fin_s)
        idx_s = torch.where(m_se, jj[:, None], idx_s)
        m_kd = (node_ids == k_d[:, None]) & can[:, None]
        chan = torch.where(m_kd, exec_start[:, None], chan)
        busy = busy + m_kd.long()
        head = head + ((fn_ids == fnid[rows, jj][:, None])
                       & can[:, None]).long()
        for o, val in zip(outs, (exec_start, fin_j, pv, k_d)):
            o[rows[can], jj[can]] = val[can].to(o.dtype)
    return [o.numpy() for o in outs], seen


def _check_mirror(inp, static, n, what):
    """Mirror == plain version == JAX oracle on rows [:n]; returns the
    mirror's counts of cases met."""
    if static["use_fc"]:    # the counts the kernel and mirror keep
        assert torch.equal(torch.from_numpy(inp["cumf"]), fc_prefix_counts(
            torch.from_numpy(inp["t"]), torch.from_numpy(inp["fnid"]),
            inp["cumf"].shape[2])), what
    clk, ctr, ref = _jax_step(inp, static)
    plain = _torch_step(inp, clk, ctr, static)
    mirror, seen = _mirror_scan(inp, clk, ctr, static)
    _assert_rows_equal(ref, plain, n, f"plain vs JAX, {what}")
    _assert_rows_equal(ref, mirror, n, f"mirror vs JAX, {what}")
    _assert_rows_equal(plain, mirror, n, f"mirror vs plain, {what}")
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_fc", [False, True])
def test_mirror_smoke_bucket(use_fc, seed):
    inp, static, n = _smoke_inputs(use_fc, seed=seed)
    seen = _check_mirror(inp, static, n, f"use_fc={use_fc}, seed={seed}")
    if use_fc:      # horizon 1 s over arrivals in [0, 2): k0 reaches the tail
        assert seen["k0_at_tail"] > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_fc", [False, True])
def test_mirror_exact_ties(use_fc, seed):
    inp, static, n = _smoke_inputs(use_fc, B=6, n=24, F=3, NN=3, KQ=32,
                                   seed=seed, quantum=0.125)
    seen = _check_mirror(inp, static, n, f"quantized, use_fc={use_fc}")
    assert seen["slot_ties"] > 0 and seen["head_ties"] > 0


@pytest.mark.parametrize("use_fc", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_mirror_burst_bucket(policy, use_fc):
    inp, static, n = _burst_bucket(policy, use_fc, nodes=2)
    assert inp["cores"][-1] == 0            # the padded cell
    _check_mirror(inp, static, n, f"{policy}, use_fc={use_fc}")


def _signed_inputs(use_fc, seed):
    """Quantized buckets with negative coefficients, an empty estimator
    ring and four arrivals at t = 0 (functions 0, 1, 2, 2) on one slot:
    priorities come out negative, and when the first call completes the
    queued heads of functions 1 and 2 tie at zero with opposite signs --
    c0 t = -0.0 and c1 prev_t = -0.0, then w est = +0.0 for function 1 (one
    call in the window, w = 0.5 - 0.3 > 0) and -0.0 for function 2 (two
    calls, w < 0).  The plain version takes them as equal and pulls the
    lesser event index (function 1); a key that kept the sign would pull
    function 2."""
    inp, static, n = _smoke_inputs(use_fc, B=6, n=24, F=3, NN=3, KQ=32,
                                   seed=seed, quantum=0.125)
    for b in range(inp["t"].shape[0]):
        inp["t"][b, :4] = 0.0
        inp["t"][b, 4:n] += 2.0         # after the first completion
        inp["p"][b, 0] = 0.25
        inp["fnid"][b, :4] = [0, 1, 2, 2]
        inp["coef"][b, :4] = [-1.0, -0.5, 0.5, -0.3]
        fn = inp["fnid"][b, :n]
        for f in range(inp["fn_ev"].shape[1]):
            ev = np.nonzero(fn == f)[0]
            inp["fn_ev"][b, f] = n
            inp["fn_ev"][b, f, :len(ev)] = ev
            if use_fc:
                inp["cumf"][b, 1:, f] = np.cumsum(fn == f)
    inp["cores"][::2] = 1
    inp["nodes"][::2] = 1
    inp["ring0"][:] = 0.0
    inp["rsum0"][:] = 0.0
    inp["rlen0"][:] = 0
    return inp, static, n


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_fc", [False, True])
def test_mirror_signed_zero_and_negative_priorities(use_fc, seed):
    inp, static, n = _signed_inputs(use_fc, seed)
    seen = _check_mirror(inp, static, n, f"signed, use_fc={use_fc}")
    assert seen["negative_best"] > 0
    if use_fc:
        assert seen["signed_zero_ties"] > 0


@pytest.mark.parametrize("horizon", [0.0, 0.25])
def test_mirror_window_at_the_tail_and_past_ai(horizon):
    """A short horizon: k0 runs to the +inf tail, and with horizon 0 it
    passes arrivals that tie with now but are not yet taken (cnt < 0)."""
    inp, static, n = _smoke_inputs(True, B=6, n=24, F=3, NN=3, KQ=32,
                                   seed=3, quantum=0.125)
    static = dict(static, horizon=horizon)
    seen = _check_mirror(inp, static, n, f"horizon={horizon}")
    assert seen["k0_at_tail"] > 0
    if horizon == 0.0:
        assert seen["k0_past_ai"] > 0


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_mirror_window_steps_back_with_negative_costs(seed):
    """Negative channel costs let a completion land before an earlier
    event, so now - horizon falls and k0 steps back; the count stays
    exact (on these seeds a pointer that only moved forward would pull
    other calls)."""
    inp, static, n = _smoke_inputs(True, B=6, n=24, F=3, NN=3, KQ=32,
                                   seed=seed, quantum=0.125)
    inp["cost"][:, :n] = -0.25
    static = dict(static, horizon=0.25)
    seen = _check_mirror(inp, static, n, "negative costs")
    assert seen["k0_back"] > 0


@pytest.mark.parametrize("policy", ["fifo", "sept", "eect", "rect", "fc"])
def test_fc_prefix_counts_define_the_bucket_runners_cumf(policy):
    """cumf as the bucket runner fills it (padded cell and +inf tails
    included) is the prefix count the kernel keeps from t and fnid; one
    call moved to another function breaks it."""
    inp, _, _ = _burst_bucket(policy, True, nodes=2)
    t, fnid = torch.from_numpy(inp["t"]), torch.from_numpy(inp["fnid"])
    cumf = torch.from_numpy(inp["cumf"])
    assert torch.equal(fc_prefix_counts(t, fnid, cumf.shape[2]), cumf)
    fnid[0, 3] = (fnid[0, 3] + 1) % cumf.shape[2]
    assert not torch.equal(fc_prefix_counts(t, fnid, cumf.shape[2]), cumf)


def test_plan_by_shape():
    """The kernel's path and shared memory come from the shape alone: the
    mega grid's buckets stage their rows; rows too long read device
    memory; wider than 256 slots, nodes or functions, or a runtime ring too
    large for shared memory, takes the wide path (state in device memory),
    so every width is taken."""
    mega = dict(n_nodes=4, n_slots=8, n_fns=16, window=10)
    for n_b in (256, 512, 1024):
        plan = tops.event_step_plan(n1=n_b + 1, **mega)
        assert plan["staged"] and plan["per_lane"] == 1
        assert not plan["wide"] and plan["scratch_words"] == 0
    assert tops.event_step_cell_bytes(True, 1025, 16, 10) == (
        640 + 12 * 1028 + 1040)
    long_rows = tops.event_step_plan(n1=32769, **mega)
    assert not long_rows["staged"] and long_rows["cell_bytes"] == 640
    assert not long_rows["wide"]
    assert tops.event_step_plan(n1=1025, n_nodes=8, n_slots=8, n_fns=16,
                                window=10)["per_lane"] == 2
    assert tops.event_step_plan(n1=65, n_nodes=16, n_slots=16, n_fns=3,
                                window=4)["per_lane"] == 8
    wide_arrays = tops.EVENT_STEP_WIDE_ARRAYS * 32
    # simulate_cluster_scan's default 18 cores on 16 nodes: 16 x 32 slots
    wide = tops.event_step_plan(n1=65, n_nodes=16, n_slots=32, n_fns=3,
                                window=4)
    assert wide == {"per_lane": 16, "wide": True, "staged": False,
                    "cell_bytes": 0, "scratch_words": wide_arrays * 16 + 12}
    # 257 functions (a warm cell of 1 core on 40 GB of 128 MB containers)
    many = tops.event_step_plan(n1=1025, n_nodes=1, n_slots=1, n_fns=512,
                                window=10)
    assert many["wide"] and many["per_lane"] == 16
    huge = tops.event_step_plan(n1=65, n_nodes=2, n_slots=4, n_fns=8192,
                                window=10)
    assert huge["per_lane"] == 256 and huge["scratch_words"] == (
        wide_arrays * 256 + 81920)
    # a ring of 16 x 4,000 (256 KB) does not fit in shared memory
    ring = tops.event_step_plan(n1=65, n_nodes=2, n_slots=4, n_fns=16,
                                window=4000)
    assert ring["wide"] and ring["per_lane"] == 1
