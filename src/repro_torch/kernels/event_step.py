"""Batched cluster event scan: the plain PyTorch version.

Counterpart of ``repro.kernels.event_step`` and of the base-pull step of the
JAX oracle ``repro.core.fastpath._scan_cell_kernel``.  One cell is a cluster
of ``nodes`` invokers with ``cores`` slots each, fed by one controller queue
(pull assignment).  Every step takes one event -- the next arrival or the
earliest completion, an arrival winning an exact tie -- and then lets the
most-free invoker pull the best queued call, ranked at pull time by

    prio = c0 * t + c1 * prev_t + (c2 + c3 * FC-count) * E[p]

from the controller's last-``window`` runtime ring.  Each function's queue is
the contiguous tail of its arrival sequence ``fn_ev[f]``, so the global best
is found over the F queue heads, ties going to the smallest event index.

Single-node and push cells run the frozen-priority regime
(``freeze``; with capacity dynamics, node speeds, cold starts, hedging or
the request lifecycle in float64, see :func:`freeze_scan_ref`): each
arrival is routed at once -- to the least-loaded node
(least ``busy + queued``, first on ties) or, under the home balancer, to
the first node with a free slot on a walk from its home invoker -- and its
priority

    prio = c0 * now + c1 * prev + (c2 + c3 * count) * E[p]

is fixed then, from the estimator of the node it was routed to; FC's
count is the static window count on one node and, on more than one, the
calls logged in the node's ring of arrival times for the function
(``fc_push``).  A step then dispatches only on the node its event touched:
the least frozen priority queued there, ties going to the smallest event
index.

This version is batched over cells (every tensor has a leading cell axis)
and runs on any device; ``repro_torch.kernels.ops.event_step`` sends CPU
tensors here and CUDA tensors to the CUDA kernel in ``csrc/event_step.cu``.
Rows ``[:n]`` of its outputs are bit-identical to the JAX oracle's: every
floating-point operation is written separately in the oracle's order (no
fused multiply-add), and every argmin/argmax takes the first index.
"""

from __future__ import annotations

import torch

from ..core.planes import carry_layout
from ..core.simulator import OURS_PREWARM_EXTRA


def event_step_supported(*, freeze, use_fc, fc_push, dyn, het, hedge, cold,
                         dup, stream=False, res=False, **_static) -> bool:
    """True when the static feature set is one the port scans: the pull
    regime or the frozen-priority regime (``freeze``, with or without the
    push FC rings ``fc_push``; it counts FC without the pull counts
    ``use_fc``), each with or without capacity dynamics (``dyn``), node
    speeds (``het``) and the cold-start containers (``cold``), and under
    ``freeze`` with or without straggler hedging (``hedge``; its duplicate
    mode ``dup`` without ``dyn``), and under ``freeze`` alone the request
    lifecycle (``res``: timeouts, retries, shedding; none of ``dyn``,
    ``het``, ``cold``, ``hedge`` or ``dup`` beside it, as the JAX oracle
    asserts), and the chunked stream (``stream``) of either regime, but
    not beside ``dup`` -- the base pull configuration is the scope of the
    JAX package's Pallas ``event_step``, the rest its oracle's."""
    if stream and dup:
        return False
    if res:
        return (freeze and not use_fc
                and not (dyn or het or cold or hedge or dup))
    if hedge or dup:
        return (freeze and hedge and not use_fc
                and not (dup and dyn))
    if freeze:
        return not use_fc
    return not fc_push


def fc_prefix_counts(t: torch.Tensor, fnid: torch.Tensor,
                     n_fns: int) -> torch.Tensor:
    """The FC counts ``cumf`` that ``t`` and ``fnid`` (B, n+1) define:
    ``(B, n+1, n_fns)`` in ``t``'s float type, entry ``[b, k, f]`` the calls
    of ``f`` among rows ``[:k]`` whose ``t`` is finite.  The plain version
    reads ``cumf``; the CUDA kernels count their window from ``t`` and
    ``fnid`` by this definition instead, so the two agree only on a bucket
    whose ``cumf`` equals it (``core.fastpath._fill_bucket`` fills it
    so)."""
    real = torch.isfinite(t[:, :-1])
    hot = torch.nn.functional.one_hot(fnid[:, :-1].long(), n_fns)
    out = torch.zeros(t.shape + (n_fns,), dtype=t.dtype, device=t.device)
    out[:, 1:] = (hot * real[..., None]).cumsum(1).to(t.dtype)
    return out


def _slowdown(inp, k_d, now):
    """Each cell's slowdown of node ``k_d`` at ``now``: the product, in
    episode order, of the factors of its episodes on that node whose window
    ``[t0, t1)`` holds ``now`` (padding episodes have node -1)."""
    hit = ((inp["epn"] == k_d[:, None]) & (inp["ept0"] <= now[:, None])
           & (now[:, None] < inp["ept1"]))
    fac = torch.where(hit, inp["epf"], 1.0)
    slow = fac[:, 0]
    for e in range(1, fac.shape[1]):
        slow = slow * fac[:, e]
    return slow


def _ring_push(ring, rsum, rlen, rpos, e, v, do, window: int, zero):
    """Log ``v`` into the runtime ring at entry ``e`` (an index tuple, one
    entry a cell) where ``do``, in place: the ring's sum drops the value it
    evicts once the ring holds ``window``."""
    pos = rpos[e]
    old = ring[e + (pos,)]
    full = rlen[e] == window
    s0 = rsum[e]
    rsum[e] = torch.where(do, s0 + v - torch.where(full, old, zero), s0)
    ring[e + (pos,)] = torch.where(do, v, old)
    rlen[e] += (do & ~full).long()
    rpos[e] = torch.where(do, (pos + 1) % window, pos)


def event_step_ref(clk, ctr, inp, *, n_nodes: int, n_slots: int,
                   window: int, use_fc: bool, horizon: float,
                   n_steps: int, freeze: bool = False, fc_push: bool = False,
                   fc_ring: int = 1, dyn: bool = False, het: bool = False,
                   cold: bool = False, hedge: bool = False, dup: bool = False,
                   n_copies: int = 1, res: bool = False,
                   stream: bool = False):
    """Plain PyTorch event scan of a bucket of cells.  ``freeze`` runs the
    frozen-priority regime (:func:`freeze_scan_ref`, with or without
    ``dyn`` / ``het`` / ``cold`` / ``hedge`` / ``dup``, or with ``res``);
    the rest of this docstring is the pull regime's.

    ``clk``/``ctr`` are the ``(B, f_len)`` / ``(B, i_len)`` initial carry
    planes (``repro_torch.core.planes.make_planes``), left unchanged;
    ``inp`` holds ``t``/``p``/``cost`` ``(B, n+1)`` (``t`` sorted, ``+inf``
    padded), ``fnid`` ``(B, n+1)``, ``coef`` ``(B, >=4)``,
    ``cores``/``nodes`` ``(B,)``, ``cumf`` ``(B, n+1 | 1, F)`` and ``fn_ev``
    ``(B, F, kq)``, all floats in the bucket's type (float32, or float64
    with ``dyn`` / ``het``).

    ``dyn`` adds capacity dynamics, as the JAX oracle's ``dyn`` branch: six
    candidate events a step -- the earliest kill, the next arrival, the
    earliest completion, the earliest re-arrival, the earliest pending
    activation and the autoscaler tick, the first on equal times.  A kill
    frees its node's slots, marks it dead and sends each call it was
    running back at ``now + failure_detect`` (the queue stays); a
    re-arrival joins the queue outside the functions' head windows (``xq``)
    and ranks by the time it was last pulled (``rq_rt``), after the calls
    already waiting at equal priority; a tick provisions one node
    ``provision_delay`` ahead while more than the threshold of calls a live
    slot are queued, and schedules the next tick until every call is done;
    an activation dispatches until the new node is full or the queue empty.
    Only active nodes (``act_t <= now``, not dead) pull.  ``inp`` adds
    ``act0`` / ``killt`` (B, nodes), ``dynp`` (B, 5: interval, threshold,
    delay, detection, autoscale flag), ``maxn`` and ``nreq`` (B,), and
    ``coef`` a fifth column on the enqueue clock.  ``het`` divides a
    dispatch's management cost and runtime by its node's speed at
    dispatch (``spd`` over the product of its episodes' slowdowns,
    ``epn`` / ``ept0`` / ``ept1`` / ``epf``).

    ``cold`` runs the ``warm=False`` regime with ample memory, as the JAX
    oracle's ``cold`` branch: a completion returns its container to its
    node's free pool of its function (``freec``) unless that pool already
    holds ``cores``, when it is evicted (``nevt``); a dispatch takes a free
    container of its node and function (a warm hit) or else a prewarmed one,
    which adds ``OURS_PREWARM_EXTRA`` to its management cost before the
    node's speed divides it (a cold start, ``ncold``), and writes the
    call's flag (``coldq``; a call dispatched twice keeps its last).

    ``stream`` scans one chunk of the chunked stream replay
    (``repro_torch.core.streamscan``), as the JAX oracle's ``stream``
    branch: every event at ``now >= t_stop`` (``inp["t_stop"]``, (B,))
    defers to the next chunk, so the scan stops there with the carry as
    it was; the queues are CSR lists, ``fnev`` (B, n+1: the rows grouped
    by function) from ``fnst`` (B, F: each function's first entry) in place
    of ``fn_ev``, a head's entry ``fnev[clip(fnst + head, 0, n)]``, valid
    while ``head < qcnt`` (the carry's chunk-rebased count of each
    function's queued calls, which an arrival adds to; ``narr`` stays
    cumulative for RECT's first arrival).  ``aux`` then adds the final
    carry planes ``clk`` / ``ctr``, every entry at its place in the
    layout.

    Returns ``(start, finish, prio, node, aux)``, the first four ``(B,
    n+1)`` (row ``n`` is the sentinel that no-op events write; a call
    dispatched twice keeps its last dispatch) and ``aux`` empty, or with
    ``dyn`` each cell's calls lost (``nfail``), calls done (``ndone``),
    nodes provisioned (``prov``), activation times (``act_t``) and dead
    flags (``dead``) at the end, and with ``cold`` its cold starts
    (``ncold``), evictions (``nevt``) and each row's cold-start flag
    (``coldq``, (B, n+1) bool)."""
    if freeze:
        return freeze_scan_ref(clk, ctr, inp, n_nodes=n_nodes,
                               n_slots=n_slots, window=window,
                               fc_push=fc_push, fc_ring=fc_ring,
                               horizon=horizon, n_steps=n_steps, dyn=dyn,
                               het=het, cold=cold, hedge=hedge, dup=dup,
                               n_copies=n_copies, res=res, stream=stream)
    if res:
        raise ValueError("res needs freeze")
    t, fnid, p, cost = inp["t"], inp["fnid"].long(), inp["p"], inp["cost"]
    coef, cumf, fn_ev = inp["coef"], inp["cumf"], inp["fn_ev"].long()
    cores, nodes = inp["cores"].long(), inp["nodes"].long()
    B, n1 = t.shape
    n = n1 - 1
    n_fns, kq = inp["ring0"].shape[2], fn_ev.shape[2]
    dev, ft = t.device, t.dtype
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, n1=n1, dyn=dyn, cold=cold,
                          stream=stream)
    st = {k: v.clone() for k, v in layout.unpack(clk, ctr).items()}
    if stream:
        fnev, fnst = inp["fnev"].long(), inp["fnst"].long()
        t_stop, qcnt = inp["t_stop"], st["qcnt"].long()
    ai = st["ai"].long()
    head = st["head"].long()
    fin_s, idx_s = st["fin_s"], st["idx_s"].long()
    busy, qn, chan = st["busy"].long(), st["qn"].long(), st["chan"]
    # one controller estimator: drop the estimator axis of length 1
    ring, rsum = st["ring"][:, 0], st["rsum"][:, 0]
    rlen, rpos = st["rlen"][:, 0].long(), st["rpos"][:, 0].long()
    last_t, prev_t, narr = (st["last_t"][:, 0], st["prev_t"][:, 0],
                            st["narr"][:, 0].long())

    rows = torch.arange(B, device=dev)
    node_ids = torch.arange(n_nodes, device=dev)[None]
    slot_ids = torch.arange(n_slots, device=dev)[None, None]
    fn_ids = torch.arange(n_fns, device=dev)[None]
    inf = torch.tensor(float("inf"), dtype=ft, device=dev)
    zero = torch.tensor(0.0, dtype=ft, device=dev)
    c0, c1, c2, c3 = (coef[:, i:i + 1] for i in range(4))
    if dyn:
        act_t, dead, killq = st["act_t"], st["dead"], st["killq"]
        act_pend, rearr = st["act_pend"], st["rearr"]
        next_tick, prov = st["next_tick"], st["prov"].long()
        nfail, ndone = st["nfail"].long(), st["ndone"].long()
        xq, rq_rt, enq_t = st["xq"], st["rq_rt"], st["enq_t"]
        interval, thr, delay, detect = (inp["dynp"][:, k] for k in range(4))
        maxn, nreq = inp["maxn"].long(), inp["nreq"].long()
        c4 = coef[:, 4:5]
        req_ids = torch.arange(n1, device=dev)[None]
    else:
        active = node_ids < nodes[:, None]
    if cold:
        freec, coldq = st["freec"].long(), st["coldq"]
        ncold, nevt = st["ncold"].long(), st["nevt"].long()
        extra = torch.tensor(OURS_PREWARM_EXTRA, dtype=ft, device=dev)
        req_ids = torch.arange(n1, device=dev)[None]

        def node_fn(k, f):
            """(B, nodes, F) mask of entry (k, f) of each cell."""
            return ((node_ids[:, :, None] == k[:, None, None])
                    & (fn_ids[:, None] == f[:, None, None]))
    start = torch.zeros(B, n1, dtype=ft, device=dev)
    finish = torch.zeros(B, n1, dtype=ft, device=dev)
    prio = torch.zeros(B, n1, dtype=ft, device=dev)
    node = torch.zeros(B, n1, dtype=torch.int32, device=dev)

    for _ in range(n_steps):
        # -- event selection: kill < arrival <= completion < re-arrival <
        # activation < tick at equal times (the first minimum wins) --------
        t_a = t[rows, ai]
        flat = fin_s.reshape(B, -1)
        kflat = flat.argmin(1)
        t_c = flat[rows, kflat]
        if dyn:
            cand = torch.stack(
                [killq.min(1).values, t_a, t_c, rearr.min(1).values,
                 torch.where(act_pend, act_t, inf).min(1).values,
                 next_tick], 1)
            e = cand.argmin(1)
            now = cand[rows, e]
        else:
            e = (t_a > t_c).long()
            now = torch.where(t_a <= t_c, t_a, t_c)
        none_left = torch.isinf(now)
        if stream:
            # the chunk's horizon: an event at or past it is the next
            # chunk's
            none_left = none_left | (now >= t_stop)
        if bool(none_left.all()):
            break                # no event left anywhere: the carry is fixed
        off = 1 if dyn else 0
        do_arr = (e == off) & ~none_left
        do_comp = (e == off + 1) & ~none_left
        if dyn:
            do_kill = (e == 0) & ~none_left
            do_re = (e == 3) & ~none_left
            do_act = (e == 4) & ~none_left
            do_tick = (e == 5) & ~none_left
            active = (act_t <= now[:, None]) & ~dead
            # which of the rarer events any cell takes this step (one read
            # back; a block no cell needs changes nothing and is skipped)
            any_kill, any_re, any_act, any_tick, any_x = torch.stack(
                [do_kill.any(), do_re.any(), do_act.any(), do_tick.any(),
                 xq.any()]).tolist()

        # -- completion: free the slot, feed the controller ring (one
        # function's entries a cell, updated in place) ---------------------
        kn = kflat // n_slots
        ks = kflat % n_slots
        j_done = idx_s.reshape(B, -1)[rows, kflat]
        f_done = fnid[rows, j_done]
        _ring_push(ring, rsum, rlen, rpos, (rows, f_done), p[rows, j_done],
                   do_comp, window, zero)
        m_kn = (node_ids == kn[:, None]) & do_comp[:, None]
        busy = busy - m_kn.long()
        fin_s = torch.where(m_kn[:, :, None] & (slot_ids == ks[:, None, None]),
                            inf, fin_s)
        if cold:
            # -- release: the container returns to its free pool, or is
            # evicted when the pool already holds `cores`
            cap = freec[rows, kn, f_done] >= cores
            freec = torch.where(node_fn(kn, f_done)
                                & (do_comp & ~cap)[:, None, None],
                                freec + 1, freec)
            nevt = nevt + (do_comp & cap).long()

        if dyn:
            ndone = ndone + do_comp.long()
        if dyn and any_kill:
            # -- kill: wipe the node, its running calls re-arrive later ----
            kk = killq.argmin(1)
            m_kk = (node_ids == kk[:, None]) & do_kill[:, None]
            lost = torch.isfinite(fin_s[rows, kk]) & do_kill[:, None]
            hit = torch.where(lost, idx_s[rows, kk], n)
            m_lost = torch.zeros(B, n1, dtype=torch.bool, device=dev)
            m_lost.scatter_(1, hit, True)
            m_lost[:, n] = False
            rearr = torch.where(m_lost, (now + detect)[:, None], rearr)
            nfail = nfail + m_lost.sum(1)
            fin_s = torch.where(m_kk[:, :, None], inf, fin_s)
            busy = torch.where(m_kk, 0, busy)
            dead = dead | m_kk
            killq = torch.where(m_kk, inf, killq)

        if dyn and any_tick:
            # -- autoscaler tick: the queue-per-slot rule ------------------
            alldone = ndone >= nreq
            n_alive = active.sum(1)
            queued = qn.sum(1).to(torch.float32).to(ft)
            fire = (do_tick & ~alldone & (prov < maxn)
                    & (queued > thr * (n_alive * cores).clamp(min=1).to(
                        torch.float32).to(ft)))
            m_new = (node_ids == prov[:, None]) & fire[:, None]
            act_t = torch.where(m_new, (now + delay)[:, None], act_t)
            act_pend = act_pend | m_new
            prov = prov + fire.long()
            next_tick = torch.where(do_tick,
                                    torch.where(alldone, inf,
                                                now + interval),
                                    next_tick)

        enq_0 = enq_t if dyn else None
        if dyn and any_re:
            # -- re-arrival: a lost call joins the queue again (the tie
            # rule below reads the enqueue times as the step found them) ---
            ir = rearr.argmin(1)
            m_ir = (req_ids == ir[:, None]) & do_re[:, None]
            rearr = torch.where(m_ir, inf, rearr)
            xq = xq | m_ir
            enq_t = torch.where(m_ir, now[:, None], enq_t)

        # -- arrival: enqueue, observe on the controller estimator (a
        # re-arrival is enqueued without a second observation) -------------
        i_ins = ai.clamp(max=n)
        do_ins = do_arr
        if dyn and any_re:
            do_ins = do_arr | do_re
            i_ins = torch.where(do_arr, i_ins, ir)
        f_i = fnid[rows, i_ins]
        first = narr[rows, f_i] == 0
        last_f = last_t[rows, f_i]
        prev_used = torch.where(first, now, last_f)
        prev_t[rows, f_i] = torch.where(do_arr, prev_used, prev_t[rows, f_i])
        last_t[rows, f_i] = torch.where(do_arr, now, last_f)
        narr[rows, f_i] += do_arr.long()
        if stream:
            qcnt[rows, f_i] += do_arr.long()
        qn = qn + ((node_ids == 0) & do_ins[:, None]).long()
        ai = ai + do_arr.long()

        # -- dispatch: the most-free invoker pulls the global best head ----
        fs = torch.where(active, cores[:, None] - busy, -1)
        k_d = fs.argmax(1)
        est_f = torch.where(rlen > 0, rsum / rlen.clamp(min=1).to(ft), zero)
        if stream:
            # a head past its function's entries clips onto the sentinel
            idx_f = fnev.gather(1, (fnst + head).clamp(0, n))
            valid = head < qcnt
        else:
            idx_f = fn_ev.gather(2, head.clamp(max=kq - 1)[:, :, None])[:, :,
                                                                        0]
            valid = head < narr
        if use_fc:
            # FC window count from the static stream: calls of f among the
            # arrivals in (now - horizon, now]
            k0 = torch.searchsorted(t, (now - horizon)[:, None],
                                    right=True)[:, 0]
            k0 = k0.clamp(max=cumf.shape[1] - 1)
            cnt_f = cumf[rows, ai] - cumf[rows, k0]
            w_est = c2 + c3 * cnt_f
        else:
            w_est = c2
        base_f = c1 * prev_t + w_est * est_f
        prio_f = c0 * t.gather(1, idx_f) + base_f
        if dyn:                  # the enqueue clock's term
            prio_f = prio_f + c4 * now[:, None]
        prio_f = torch.where(valid, prio_f, inf)
        best = prio_f.min(1).values
        j = torch.where(valid & (prio_f == best[:, None]), idx_f,
                        n).min(1).values
        prio_j = best
        pick_x = torch.zeros(B, dtype=torch.bool, device=dev)
        if dyn and (any_x or any_re):
            # a re-queued call ranks by the clock it was last pulled at and
            # wins an equal priority only if it re-arrived before the head
            prio_x = torch.where(xq, c0 * t + base_f.gather(1, fnid)
                                 + c4 * rq_rt, inf)
            j_x = prio_x.argmin(1)
            best_x = prio_x[rows, j_x]
            pick_x = (best_x < prio_j) | ((best_x == prio_j)
                                          & (enq_0[rows, j_x] < t[rows, j]))
            j = torch.where(pick_x, j_x, j)
            prio_j = torch.minimum(best_x, prio_j)
        if dyn:
            can = ((do_ins | do_comp | do_act) & active[rows, k_d]
                   & (busy[rows, k_d] < cores) & (prio_j < inf))
        else:
            can = ~none_left & (busy[rows, k_d] < cores) & (j < n)
        cost_j, p_j = cost[rows, j], p[rows, j]
        if cold:
            # -- acquire: a free container of the node and function is a
            # warm hit, else a prewarmed one starts cold
            f_j = fnid[rows, j]
            warm_hit = freec[rows, k_d, f_j] > 0
            cost_j = cost_j + torch.where(warm_hit, zero, extra)
            freec = torch.where(node_fn(k_d, f_j)
                                & (can & warm_hit)[:, None, None],
                                freec - 1, freec)
            ncold = ncold + (can & ~warm_hit).long()
            coldq = torch.where((req_ids == j[:, None]) & can[:, None],
                                ~warm_hit[:, None], coldq)
        if het:
            # the node's speed at dispatch, eff = spd / slowdown, divides
            # cost and runtime; the oracle's x / (spd / slowdown) compiles
            # to (x * slowdown) / spd (XLA's algebraic simplifier), which
            # is what it computes, so the port computes that
            spd_k, slow = inp["spd"][rows, k_d], _slowdown(inp, k_d, now)
            cost_j, p_j = cost_j * slow / spd_k, p_j * slow / spd_k
        exec_start = torch.maximum(now, chan[rows, k_d]) + cost_j
        m_kd = (node_ids == k_d[:, None]) & can[:, None]
        chan = torch.where(m_kd, exec_start[:, None], chan)
        fin_j = exec_start + p_j
        slot_free = (torch.isinf(fin_s[rows, k_d])
                     & (slot_ids[:, 0] < cores[:, None]))
        s = slot_free.to(torch.int32).argmax(1)
        m_ds = m_kd[:, :, None] & (slot_ids == s[:, None, None])
        fin_s = torch.where(m_ds, fin_j[:, None, None], fin_s)
        idx_s = torch.where(m_ds, j[:, None, None], idx_s)
        busy = busy + m_kd.long()
        qn = qn - m_kd.long()
        adv = can
        if dyn:
            m_j = (req_ids == j[:, None]) & can[:, None]
            xq = xq & ~(m_j & pick_x[:, None])
            adv = can & ~pick_x
            rq_rt = torch.where(m_j, now[:, None], rq_rt)
        head[rows, fnid[rows, j]] += adv.long()
        if dyn and any_act:
            # the activation event stays pending while the new node can
            # take more of the queue
            ka = torch.where(act_pend, act_t, inf).argmin(1)
            still = (do_act & can & (qn.sum(1) > 0)
                     & (busy[rows, ka] < cores))
            act_pend = torch.where((node_ids == ka[:, None])
                                   & do_act[:, None], still[:, None],
                                   act_pend)

        # -- per-dispatch record; no-op events land on sentinel row n ------
        jn = torch.where(can, j, n)
        start[rows, jn] = exec_start
        finish[rows, jn] = fin_j
        prio[rows, jn] = prio_j
        node[rows, jn] = k_d.to(torch.int32)
    aux = {}
    i32 = torch.int32
    if dyn:
        aux = {"nfail": nfail.to(i32), "ndone": ndone.to(i32),
               "prov": prov.to(i32), "act_t": act_t, "dead": dead}
    if cold:
        aux.update(ncold=ncold.to(i32), nevt=nevt.to(i32), coldq=coldq)
    if stream:
        # the final carry, every entry (the estimator axis of length 1
        # restored)
        fin = {"ai": ai, "head": head, "fin_s": fin_s, "idx_s": idx_s,
               "busy": busy, "qn": qn, "chan": chan, "ring": ring[:, None],
               "rsum": rsum[:, None], "rlen": rlen[:, None],
               "rpos": rpos[:, None], "last_t": last_t[:, None],
               "prev_t": prev_t[:, None], "narr": narr[:, None],
               "qcnt": qcnt}
        if dyn:
            fin.update(act_t=act_t, dead=dead, killq=killq,
                       act_pend=act_pend, rearr=rearr, next_tick=next_tick,
                       prov=prov, nfail=nfail, ndone=ndone, xq=xq,
                       rq_rt=rq_rt, enq_t=enq_t)
        if cold:
            fin.update(freec=freec, ncold=ncold, nevt=nevt, coldq=coldq)
        aux["clk"], aux["ctr"] = layout.pack(fin)
    return start, finish, prio, node, aux


# the re-route rank of a call lost while queued (the JAX package's
# ``_RORD_Q``): above every launch sequence, so ex-running calls re-arrive
# first
RORD_Q = 2 ** 30


def freeze_scan_ref(clk, ctr, inp, *, n_nodes: int, n_slots: int,
                    window: int, fc_push: bool, fc_ring: int,
                    horizon: float, n_steps: int, dyn: bool = False,
                    het: bool = False, cold: bool = False,
                    hedge: bool = False, dup: bool = False,
                    n_copies: int = 1, res: bool = False,
                    stream: bool = False):
    """Plain PyTorch event scan of a bucket of frozen-priority cells
    (single node, or push with the least-loaded or home balancer).

    ``clk``/``ctr`` are the initial carry planes with the ``freeze`` (and
    ``fc_push``, ``cold``, ``hedge``, ``dup``, ``het``, ``dyn``) segments,
    left unchanged; ``inp`` holds, besides the pull inputs'
    ``t``/``fnid``/``p``/``cost``/``coef``/``cores``/``nodes``, ``cnt``
    ``(B, n+1)`` (single-node FC's static window counts), ``home0`` ``(B,
    n+1)`` (each call's home invoker) and ``route`` ``(B,)`` (0
    least-loaded, 1 home), the ``dyn`` / ``het`` inputs of
    :func:`event_step_ref`, and with ``hedge`` ``hmult`` / ``hfloor``
    (the deadline's multiple and floor) and ``hmax`` (the backup cap),
    ``(B,)``.

    ``dyn``, ``het``, ``cold``, ``hedge`` and ``dup`` are the JAX
    oracle's float64 branches of this regime.  ``cold`` keeps each (node,
    function)'s free containers as under pull; a push call's pool is its
    routed node's.  ``het`` divides a dispatch's cost and runtime by its
    node's speed at dispatch, stamps that speed on the slot (``sspd``), and
    the node's estimator logs the measured service ``p / sspd`` at
    completion.  ``dyn`` routes least-loaded over the active nodes; a kill
    frees its node's slots *and queue*: the calls it was running and those
    queued on it re-arrive at ``now + failure_detect``, and same-instant
    re-arrivals replay the reference's order -- ex-running calls by launch
    sequence (``dseq``, stamped from the launch count ``dcnt`` at each
    dispatch), then ex-queued calls by their frozen priority (``rord``,
    then the push sequence ``qseq`` under ``hedge``); a re-arrival is
    routed, observed and ranked as an arrival; an activation dispatches on
    its node while that node can take more.

    ``hedge`` arms each call's watch at its (re-)arrival from the
    controller's estimator ring (which logs every completion's raw ``p``):
    ``now + hmult * max(E[p], hfloor)``.  The earliest deadline is an
    event, after completions (with ``dyn``: after every other event); it
    acts when its call is still queued and under ``hmax`` attempts (with
    ``dyn``, and not lost while running), else it is a no-op that still
    takes a step.  A steal cancels the call on its node and inserts it, as
    an arrival, on the least-loaded live peer (its own node when none):
    observed there, re-logged in the FC ring, its priority recomputed and
    its watch re-armed; ``att`` and the backups count one more.  Equal
    priorities on a node dispatch by push sequence (``qseq``, the step
    count at insertion).  A dispatched call's watch is cleared.  With
    ``dyn`` a kill adds an attempt to every call it loses and clears its
    stolen flag; a call lost queued keeps its deadlines after ``now +
    failure_detect`` (two slots, ``hedge_t`` <= ``hedge_t2``), a call lost
    running never hedges again.  ``dup`` races a copy instead: queue entry
    ``c * (n+1) + j`` is copy ``c`` of row ``j`` (``n_copies`` of them),
    issued on the least-loaded live peer (none: a no-op); the first
    completion of any copy is the call's (its start, finish and node),
    clears the watch, and counts a steal when a copy won.

    ``res`` (alone: none of the flags above) is the request lifecycle, the
    JAX oracle's ``res`` branch; ``inp`` adds ``rto_p`` (B, 4: timeout on,
    multiple, floor, absolute), ``rrt_p`` (B, 6: max attempts, backoff
    base, cap, jitter, retry on timeout, on shed) and ``adm_p`` (B, 2:
    shedding on, threshold), ``ResilienceSpec.arrays()``.  Four candidate
    events a step, the first on equal times: the next arrival, the earliest
    completion, the earliest timeout deadline and the earliest retry
    re-arrival.  A completion clears its call's deadline and logs its raw
    ``p`` in the controller's ring.  A deadline fire on a queued call takes
    it off its node's queue and its E[p] off the shed gauge; on a running
    one it frees the slot, adds the seconds run to the wasted work and
    dispatches on that node; then the call re-arrives after the backoff
    (``RetryPolicy.delay`` of its row and submissions) while it has
    attempts left and retries timeouts, else it fails (cause 1).  An
    arrival or re-arrival counts a submission, then is shed when the gauge
    over the free slots of the fleet exceeds the threshold (a retry, or
    cause 2), else adds the controller's E[p] to the gauge, arms its
    deadline and is routed and ranked as an arrival.  A dispatch takes its
    E[p] off the gauge and stamps its slot's start; equal priorities on a
    node dispatch by push sequence (``qsq``, the step count at insertion).

    ``stream`` (not beside ``dup``) scans one chunk of the chunked stream
    replay (``repro_torch.core.streamscan``), as the JAX oracle's
    ``stream`` branch on this regime: every event at ``now >= t_stop``
    (``inp["t_stop"]``, (B,)) defers to the next chunk, so the scan stops
    there with the carry as it was; under ``res`` the retry jitter hashes
    each row's global arrival rank ``inp["gseq"]`` (B, n+1) in place of its
    row.  ``aux`` then adds the final carry planes ``clk`` / ``ctr``, every
    entry at its place in the layout; the step counts ``stepc`` / ``stp``
    there are the JAX scan's, one for each of the ``n_steps`` steps.  Each
    estimator, ring and free-container entry is updated in place (one entry
    an event), never by a mask over the whole (node, function) plane.

    Returns ``(start, finish, prio, node, aux)``, the first four ``(B,
    n+1)``: ``prio`` and ``node`` are the carry's ``fprio`` and
    ``node_of`` at the end, each call's values fixed at its (last)
    arrival; a call dispatched twice keeps its last dispatch's start and
    finish; under ``dup`` start, finish and node are the winning copy's
    and ``prio`` the original's.  ``aux`` as :func:`event_step_ref`'s,
    and with ``hedge`` each cell's backups (``nbk``), calls stolen or won
    by a copy (``nstl``), calls done (``ndone``, first completions), steps
    taken (``stepc``: the carry's count and one for each step with an
    event, a no-op fire included) and each row's attempts (``att``); with
    ``res`` the timeouts (``nto``), sheds (``nsh``), retries (``nrt``),
    wasted seconds (``wst``), calls resolved (``ndn``: completions and
    terminal failures), steps taken (``stepc``, as under ``hedge``), and
    each row's failure flag (``nfl``), cause (``fcz``) and submissions
    (``ratt``)."""
    t, fnid, p, cost = inp["t"], inp["fnid"].long(), inp["p"], inp["cost"]
    cnt, home0, coef = inp["cnt"], inp["home0"].long(), inp["coef"]
    cores, nodes = inp["cores"].long(), inp["nodes"].long()
    route = inp["route"].long()
    B, n1 = t.shape
    n = n1 - 1
    n_fns = inp["ring0"].shape[2]
    dev, ft = t.device, t.dtype
    if dup and not hedge:
        raise ValueError("dup needs hedge")
    if stream and dup:
        raise ValueError("stream takes no dup")
    if res and (dyn or het or cold or hedge):
        raise ValueError("res takes no dyn, het, cold or hedge")
    nq = n_copies * n1 if dup else n1
    if dup:
        # a queue entry's row features are its original row's
        fnid, p, cost = (x.repeat(1, n_copies) for x in (fnid, p, cost))
        cnt, home0 = cnt.repeat(1, n_copies), home0.repeat(1, n_copies)
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, freeze=True, fc_push=fc_push, n1=n1,
                          fc_ring=fc_ring, dyn=dyn, het=het, cold=cold,
                          hedge=hedge, dup=dup, n_copies=n_copies, res=res,
                          stream=stream)
    st = {k: v.clone() for k, v in layout.unpack(clk, ctr).items()}
    ai = st["ai"].long()
    fin_s, idx_s = st["fin_s"], st["idx_s"].long()
    busy, qn, chan = st["busy"].long(), st["qn"].long(), st["chan"]
    # one estimator a node: (B, nodes, F[, window])
    ring, rsum = st["ring"], st["rsum"]
    rlen, rpos = st["rlen"].long(), st["rpos"].long()
    last_t, prev_t, narr = st["last_t"], st["prev_t"], st["narr"].long()
    pend, fprio, node_of = st["pend"], st["fprio"], st["node_of"]
    if fc_push:
        fcr, fcp = st["fcr"], st["fcp"].long()

    if stream:
        t_stop = inp["t_stop"]
    rows = torch.arange(B, device=dev)
    node_ids = torch.arange(n_nodes, device=dev)[None]
    slot_ids = torch.arange(n_slots, device=dev)[None, None]
    req_ids = torch.arange(nq, device=dev)[None]
    oreq_ids = torch.arange(n1, device=dev)[None]
    inf = torch.tensor(float("inf"), dtype=ft, device=dev)
    zero = torch.tensor(0.0, dtype=ft, device=dev)
    c0, c1, c2, c3 = (coef[:, i] for i in range(4))
    if dyn:
        act_t, dead, killq = st["act_t"], st["dead"], st["killq"]
        act_pend, rearr = st["act_pend"], st["rearr"]
        next_tick, prov = st["next_tick"], st["prov"].long()
        nfail, ndone = st["nfail"].long(), st["ndone"].long()
        dseq, dcnt, rord = st["dseq"].long(), st["dcnt"].long(), \
            st["rord"].long()
        interval, thr, delay, detect = (inp["dynp"][:, k] for k in range(4))
        maxn, nreq = inp["maxn"].long(), inp["nreq"].long()
    else:
        active = node_ids < nodes[:, None]
    if het:
        sspd = st["sspd"]
    if cold:
        freec, coldq = st["freec"].long(), st["coldq"]
        ncold, nevt = st["ncold"].long(), st["nevt"].long()
        extra = torch.tensor(OURS_PREWARM_EXTRA, dtype=ft, device=dev)
    if hedge:
        hedge_t, att, nbk = st["hedge_t"], st["att"].long(), st["nbk"].long()
        stolen, qseq = st["stolen"], st["qseq"].long()
        cring, crsum = st["cring"], st["crsum"]
        crlen, crpos = st["crlen"].long(), st["crpos"].long()
        stepc, ndone = st["stepc"].long(), st["ndone"].long()
        stepc0 = stepc.clone()
        hmult, hfloor, hmax = inp["hmult"], inp["hfloor"], inp["hmax"].long()
        if dyn:
            unhedge, hedge_t2 = st["unhedge"], st["hedge_t2"]
    if dup:
        done0, start_q = st["done0"], st["start_q"]
        win_start, win_fin = st["win_start"], st["win_fin"]
        win_node = st["win_node"]
    if res:
        to_t, rto, eps, qep = st["to_t"], st["rto"], st["eps"], st["qep"]
        ratt, nfl, fcz = st["ratt"].long(), st["nfl"], st["fcz"].long()
        sst, wst = st["sst"], st["wst"]
        nto, nsh, nrt = st["nto"].long(), st["nsh"].long(), st["nrt"].long()
        ndn, qsq, stp = st["ndn"].long(), st["qsq"].long(), st["stp"].long()
        zring, zrsum = st["zring"], st["zrsum"]
        zrlen, zrpos = st["zrlen"].long(), st["zrpos"].long()
        stp0 = stp.clone()
        rto_p, rrt_p, adm_p = inp["rto_p"], inp["rrt_p"], inp["adm_p"]
        maxa = rrt_p[:, 0].long()
        on_to, on_sh = rrt_p[:, 4] > 0, rrt_p[:, 5] > 0

        def res_delay(i, a):
            """RetryPolicy.delay in float64, term for term: the 16-bit
            jitter hash of (arrival rank, attempt) and the power of two as
            a shift; the rank is row ``i``, or under ``stream`` its global
            rank."""
            seq = inp["gseq"][rows, i].long() if stream else i
            base, cap, jit = rrt_p[:, 1], rrt_p[:, 2], rrt_p[:, 3]
            u = ((seq * 7919 + a * 104729 + 12345) % 65536).to(ft) / 65536.0
            shift = torch.bitwise_left_shift(torch.ones_like(a),
                                             (a - 1).clamp(min=0)).to(ft)
            raw = torch.minimum(cap, base * shift)
            return raw * ((1.0 - jit) + jit * u)
    start = torch.zeros(B, n1, dtype=ft, device=dev)
    finish = torch.zeros(B, n1, dtype=ft, device=dev)
    nstep = torch.zeros(B, dtype=torch.long, device=dev)

    for _ in range(n_steps):
        # -- event selection: (kill <) arrival <= completion (< re-arrival
        # < activation < tick) (< hedge deadline) at equal times, the first
        # minimum wins
        t_a = t[rows, ai]
        flat = fin_s.reshape(B, -1)
        kflat = flat.argmin(1)
        t_c = flat[rows, kflat]
        if dyn:
            cand = [killq.min(1).values, t_a, t_c, rearr.min(1).values,
                    torch.where(act_pend, act_t, inf).min(1).values,
                    next_tick]
            if hedge:
                cand.append(hedge_t.min(1).values)
            cand = torch.stack(cand, 1)
            e = cand.argmin(1)
            now = cand[rows, e]
        elif hedge:
            cand = torch.stack([t_a, t_c, hedge_t.min(1).values], 1)
            e = cand.argmin(1)
            now = cand[rows, e]
        elif res:
            # timeout fires rank after completions, retry re-arrivals after
            # both
            cand = torch.stack([t_a, t_c, to_t.min(1).values,
                                rto.min(1).values], 1)
            e = cand.argmin(1)
            now = cand[rows, e]
        else:
            e = (t_a > t_c).long()
            now = torch.where(t_a <= t_c, t_a, t_c)
        none_left = torch.isinf(now)
        if stream:
            # the chunk's horizon: an event at or past it is the next
            # chunk's
            none_left = none_left | (now >= t_stop)
        if bool(none_left.all()):
            break                # no event left anywhere: the carry is fixed
        off = 1 if dyn else 0
        do_arr = (e == off) & ~none_left
        do_comp = (e == off + 1) & ~none_left
        if hedge:
            do_hedge = (e == (6 if dyn else 2)) & ~none_left
        if res:
            do_to = (e == 2) & ~none_left
            do_rto = (e == 3) & ~none_left
            # whether any cell fires a deadline or admits a call this step
            # (one read back; a block no cell needs changes nothing and is
            # skipped)
            any_to, any_ins = torch.stack(
                [do_to.any(), (do_arr | do_rto).any()]).tolist()
        if dyn:
            do_kill = (e == 0) & ~none_left
            do_re = (e == 3) & ~none_left
            do_act = (e == 4) & ~none_left
            do_tick = (e == 5) & ~none_left
            active = (act_t <= now[:, None]) & ~dead
            any_kill, any_re, any_act, any_tick = torch.stack(
                [do_kill.any(), do_re.any(), do_act.any(),
                 do_tick.any()]).tolist()

        # -- completion: free the slot, feed the node's ring (with speeds,
        # the measured service p / sspd) ----------------------------------
        kn = kflat // n_slots
        ks = kflat % n_slots
        j_done = idx_s.reshape(B, -1)[rows, kflat]
        f_done = fnid[rows, j_done]
        v = p[rows, j_done]
        if het:
            v = v / sspd.reshape(B, -1)[rows, kflat]
        _ring_push(ring, rsum, rlen, rpos, (rows, kn, f_done), v, do_comp,
                   window, zero)
        if hedge:
            # the controller's ring logs every completion's raw p
            _ring_push(cring, crsum, crlen, crpos, (rows, f_done),
                       p[rows, j_done], do_comp, window, zero)
        if res:
            # the completion clears its call's deadline and the controller's
            # ring (admission's and the deadlines' estimate) logs its raw p
            to_t = torch.where((req_ids == j_done[:, None])
                               & do_comp[:, None], inf, to_t)
            ndn = ndn + do_comp.long()
            _ring_push(zring, zrsum, zrlen, zrpos, (rows, f_done),
                       p[rows, j_done], do_comp, window, zero)
        m_kn = (node_ids == kn[:, None]) & do_comp[:, None]
        busy = busy - m_kn.long()
        fin_s = torch.where(m_kn[:, :, None] & (slot_ids == ks[:, None, None]),
                            inf, fin_s)
        if cold:
            # -- release: the container returns to its free pool, or is
            # evicted when the pool already holds `cores`
            cap = freec[rows, kn, f_done] >= cores
            freec[rows, kn, f_done] += (do_comp & ~cap).long()
            nevt = nevt + (do_comp & cap).long()
        if dup:
            # -- the first completion among a call's copies wins
            orig_done = j_done % n1
            take = do_comp & ~done0[rows, orig_done]
            m_win = (oreq_ids == orig_done[:, None]) & take[:, None]
            done0 = done0 | m_win
            win_start = torch.where(m_win, start_q[rows, j_done][:, None],
                                    win_start)
            win_fin = torch.where(m_win, now[:, None], win_fin)
            win_node = torch.where(m_win, kn[:, None].to(win_node.dtype),
                                   win_node)
        if hedge:
            # -- the earliest deadline fires: it acts on a call still
            # queued and under its backup cap, else it is a no-op
            if dup:
                hedge_t = torch.where(m_win, inf, hedge_t)
                stolen = stolen | (m_win & (j_done >= n1)[:, None])
            jh = hedge_t.argmin(1)
            act_able = do_hedge & pend[rows, jh] & (att[rows, jh] < hmax)
            if dyn:
                act_able = act_able & ~unhedge[rows, jh]
                m_jh = (oreq_ids == jh[:, None]) & do_hedge[:, None]
                hedge_t = torch.where(m_jh, hedge_t2, hedge_t)
                hedge_t2 = torch.where(m_jh, inf, hedge_t2)
            else:
                hedge_t = torch.where((oreq_ids == jh[:, None])
                                      & do_hedge[:, None], inf, hedge_t)
            old_node = node_of[rows, jh].long()
            peer_ok = active & (node_ids != old_node[:, None])
            steal_ok = act_able & peer_ok.any(1) if dup else act_able

        if dyn:
            ndone = ndone + do_comp.long()
        if dyn and any_kill:
            # -- kill: the node's running calls keep their launch sequence
            # as their re-route rank, its queued calls leave the queue and
            # rank after them; all re-arrive after the detection delay ----
            kk = killq.argmin(1)
            m_kk = (node_ids == kk[:, None]) & do_kill[:, None]
            lost = torch.isfinite(fin_s[rows, kk]) & do_kill[:, None]
            hit = torch.where(lost, idx_s[rows, kk], n)
            m_lost = torch.zeros(B, n1, dtype=torch.bool, device=dev)
            m_lost.scatter_(1, hit, True)
            m_lost[:, n] = False
            rval = torch.zeros(B, n1, dtype=torch.long, device=dev)
            rval.scatter_(1, hit, dseq[rows, kk])
            m_lostq = pend & (node_of == kk[:, None]) & do_kill[:, None]
            pend = pend & ~m_lostq
            lost_any = m_lost | m_lostq
            rord = torch.where(m_lost, rval,
                               torch.where(m_lostq, RORD_Q, rord))
            rearr = torch.where(lost_any, (now + detect)[:, None], rearr)
            nfail = nfail + lost_any.sum(1)
            if hedge:
                # a loss is an attempt and voids a steal; a call lost
                # queued keeps its deadlines after the outage, one lost
                # running never hedges again
                att = torch.where(lost_any, att + 1, att)
                stolen = stolen & ~lost_any
                back = (now + detect)[:, None]
                h1k = torch.where(hedge_t > back, hedge_t, inf)
                h2k = torch.where(hedge_t2 > back, hedge_t2, inf)
                hedge_t = torch.where(m_lostq, torch.minimum(h1k, h2k),
                                      hedge_t)
                hedge_t2 = torch.where(m_lostq, torch.maximum(h1k, h2k),
                                       hedge_t2)
                hedge_t = torch.where(m_lost, inf, hedge_t)
                hedge_t2 = torch.where(m_lost, inf, hedge_t2)
                unhedge = unhedge | m_lost
            fin_s = torch.where(m_kk[:, :, None], inf, fin_s)
            busy = torch.where(m_kk, 0, busy)
            qn = torch.where(m_kk, 0, qn)
            dead = dead | m_kk
            killq = torch.where(m_kk, inf, killq)

        if dyn and any_tick:
            # -- autoscaler tick: the queue-per-slot rule ------------------
            alldone = ndone >= nreq
            n_alive = active.sum(1)
            queued = qn.sum(1).to(torch.float32).to(ft)
            fire = (do_tick & ~alldone & (prov < maxn)
                    & (queued > thr * (n_alive * cores).clamp(min=1).to(
                        torch.float32).to(ft)))
            m_new = (node_ids == prov[:, None]) & fire[:, None]
            act_t = torch.where(m_new, (now + delay)[:, None], act_t)
            act_pend = act_pend | m_new
            prov = prov + fire.long()
            next_tick = torch.where(do_tick,
                                    torch.where(alldone, inf,
                                                now + interval),
                                    next_tick)

        if res and any_to:
            # -- the earliest deadline fires on its call, queued or running
            jt = to_t.argmin(1)
            m_jt = req_ids == jt[:, None]
            is_q = pend[rows, jt] & do_to
            slot_match = (idx_s == jt[:, None, None]) & torch.isfinite(fin_s)
            flat_m = slot_match.reshape(B, -1)
            is_run = do_to & ~is_q & flat_m.any(1)
            # queued: off its node's queue, its E[p] off the gauge
            pend = pend & ~(m_jt & is_q[:, None])
            qn = qn - ((node_ids == node_of[rows, jt].long()[:, None])
                       & is_q[:, None]).long()
            qep = qep - torch.where(is_q, eps[rows, jt], zero)
            # running: the slot is freed, the seconds run are wasted
            m_rc = slot_match & is_run[:, None, None]
            rn = flat_m.to(torch.int32).argmax(1) // n_slots
            sst_v = torch.where(m_rc, sst, zero).reshape(B, -1).sum(1)
            wst = wst + torch.where(is_run, torch.maximum(now - sst_v, zero),
                                    zero)
            fin_s = torch.where(m_rc, inf, fin_s)
            busy = busy - ((node_ids == rn[:, None]) & is_run[:, None]).long()
            nto = nto + do_to.long()
            to_t = torch.where(m_jt & do_to[:, None], inf, to_t)
            # retry or fail: the submissions counted are the failed
            # attempt's number
            a_jt = ratt[rows, jt]
            can_rt = do_to & on_to & (a_jt < maxa)
            rto = torch.where(m_jt & can_rt[:, None],
                              (now + res_delay(jt, a_jt))[:, None], rto)
            nrt = nrt + can_rt.long()
            died = do_to & ~can_rt
            nfl = nfl | (m_jt & died[:, None])
            fcz = torch.where(m_jt & died[:, None], 1, fcz)
            ndn = ndn + died.long()

        # -- arrival, re-arrival or steal: route, observe on the routed
        # node -----------------------------------------------------------
        i_ins = ai.clamp(max=n)
        do_ins = do_arr
        if res:
            # a retry re-arrives through the arrival's path
            jr = rto.argmin(1)
            rto = torch.where((req_ids == jr[:, None]) & do_rto[:, None],
                              inf, rto)
            do_ins = do_arr | do_rto
            i_ins = torch.where(do_arr, i_ins, jr)
        if hedge:
            # a steal re-inserts the call; a copy enters at its entry
            alt = (((att[rows, jh] + 1) * n1 + jh).clamp(max=nq - 1)
                   if dup else jh)
            do_ins = do_arr | steal_ok
            i_ins = torch.where(do_arr, i_ins, alt)
        if dyn and any_re:
            # same-instant re-arrivals: ex-running calls by launch
            # sequence, then ex-queued ones by frozen priority (then push
            # sequence), first index on ties
            tie = rearr <= rearr.min(1).values[:, None]
            run_k = torch.where(tie & (rord < RORD_Q), rord, 2 ** 31 - 1)
            ir_run = run_k.argmin(1)
            any_run = run_k[rows, ir_run] < 2 ** 31 - 1
            qp = torch.where(tie & (rord >= RORD_Q), fprio, inf)
            if hedge:
                qk = torch.where(qp <= qp.min(1).values[:, None], qseq,
                                 2 ** 31 - 1)
                ir_q = qk.argmin(1)
            else:
                ir_q = qp.argmin(1)
            ir = torch.where(any_run, ir_run, ir_q)
            rearr = torch.where((req_ids == ir[:, None]) & do_re[:, None],
                                inf, rearr)
            do_ins = do_ins | do_re
            i_ins = torch.where(do_re, ir, i_ins)
        f_i = fnid[rows, i_ins]
        if res and any_ins:
            # -- admission: count the submission, shed it when the gauge
            # over the fleet's free slots exceeds the threshold (no node
            # sees it), else add the controller's E[p] to the gauge and arm
            # the deadline
            do_ins0 = do_ins
            m_i = req_ids == i_ins[:, None]
            ratt = ratt + (m_i & do_ins0[:, None]).long()
            a_i = ratt[rows, i_ins]
            n_z = zrlen[rows, f_i]
            est_z = torch.where(n_z > 0, zrsum[rows, f_i]
                                / n_z.clamp(min=1).to(ft), zero)
            free_tot = torch.where(active, cores[:, None] - busy, 0).sum(1)
            shed_now = (do_ins0 & (adm_p[:, 0] > 0)
                        & (qep / free_tot.clamp(min=1).to(ft) > adm_p[:, 1]))
            nsh = nsh + shed_now.long()
            sh_rt = shed_now & on_sh & (a_i < maxa)
            rto = torch.where(m_i & sh_rt[:, None],
                              (now + res_delay(i_ins, a_i))[:, None], rto)
            nrt = nrt + sh_rt.long()
            sh_die = shed_now & ~sh_rt
            nfl = nfl | (m_i & sh_die[:, None])
            fcz = torch.where(m_i & sh_die[:, None], 2, fcz)
            ndn = ndn + sh_die.long()
            do_ins = do_ins0 & ~shed_now
            eps = torch.where(m_i & do_ins[:, None], est_z[:, None], eps)
            qep = qep + torch.where(do_ins, est_z, zero)
            dl = torch.where(rto_p[:, 3] > 0, now + rto_p[:, 3],
                             now + rto_p[:, 1] * torch.maximum(est_z,
                                                               rto_p[:, 2]))
            to_t = torch.where(m_i & (do_ins & (rto_p[:, 0] > 0))[:, None],
                               dl[:, None], to_t)
        # least-loaded: least busy + queued, first on ties; inactive nodes
        # never win
        load = torch.where(active, busy + qn, 2 ** 30)
        k_ll = load.argmin(1)
        if dyn:
            k_arr = k_ll             # the home walk is static-capacity
        else:
            # home: walk from the home invoker to the first node with a
            # free slot, else stay home
            free_n = (busy < cores[:, None]) & active
            h0 = home0[rows, i_ins]
            walk = (h0[:, None] + node_ids) % nodes.clamp(min=1)[:, None]
            wfree = free_n.gather(1, walk) & active
            k_home = torch.where(wfree.any(1),
                                 walk[rows, wfree.to(torch.int32).argmax(1)],
                                 h0)
            k_arr = torch.where(route == 1, k_home, k_ll)
        if hedge:
            # the steal's or copy's target: the least-loaded live peer,
            # else (a steal) the call's own node
            load_x = torch.where(peer_ok, busy + qn, 2 ** 30)
            k_tgt = torch.where(peer_ok.any(1), load_x.argmin(1), old_node)
            k_arr = torch.where(steal_ok, k_tgt, k_arr)
        e_i = (rows, k_arr, f_i)
        first = narr[e_i] == 0
        last_i = last_t[e_i]
        prev_used = torch.where(first, now, last_i)
        prev_t[e_i] = torch.where(do_ins, prev_used, prev_t[e_i])
        last_t[e_i] = torch.where(do_ins, now, last_i)
        narr[e_i] += do_ins.long()
        if hedge and not dup:
            # the stolen call leaves its old node's queue
            qn = qn - ((node_ids == old_node[:, None])
                       & steal_ok[:, None]).long()
        qn = qn + ((node_ids == k_arr[:, None]) & do_ins[:, None]).long()
        ai = ai + do_arr.long()
        if fc_push:
            # log the arrival in the node's ring, then count the window
            # (the logged time itself is inside it)
            pos_fc = fcp[e_i]
            fcr[rows, k_arr, f_i, pos_fc] = torch.where(
                do_ins, now, fcr[rows, k_arr, f_i, pos_fc])
            fcp[e_i] = torch.where(do_ins, (pos_fc + 1) % fc_ring, pos_fc)
            cnt_i = (fcr[e_i] > (now - horizon)[:, None]).sum(1).to(ft)
        else:
            cnt_i = cnt[rows, i_ins]
        n_k = rlen[rows, k_arr, f_i]
        est_i = torch.where(n_k > 0, rsum[rows, k_arr, f_i]
                            / n_k.clamp(min=1).to(ft), zero)
        prio_i = c0 * now + c1 * prev_used + (c2 + c3 * cnt_i) * est_i
        m_ins = (req_ids == i_ins[:, None]) & do_ins[:, None]
        pend = pend | m_ins
        fprio = torch.where(m_ins, prio_i[:, None], fprio)
        node_of = torch.where(m_ins, k_arr[:, None].to(node_of.dtype),
                              node_of)
        if hedge:
            # (re-)arm the original's watch from the controller estimate
            n_c = crlen[rows, f_i]
            est_h = torch.where(n_c > 0, crsum[rows, f_i]
                                / n_c.clamp(min=1).to(ft), zero)
            arm = now + hmult * torch.maximum(est_h, hfloor)
            m_w = (oreq_ids == (i_ins % n1)[:, None]) & do_ins[:, None]
            if dyn:
                # merged into the sorted pair: a re-arrival may find its
                # pre-kill deadline still pending
                lo1 = torch.minimum(hedge_t, hedge_t2)
                hi1 = torch.maximum(hedge_t, hedge_t2)
                hedge_t = torch.where(m_w, torch.minimum(lo1, arm[:, None]),
                                      hedge_t)
                hedge_t2 = torch.where(
                    m_w, torch.minimum(hi1, torch.maximum(lo1,
                                                          arm[:, None])),
                    hedge_t2)
            else:
                hedge_t = torch.where(m_w, arm[:, None], hedge_t)
            att = att + ((oreq_ids == jh[:, None]) & steal_ok[:, None]).long()
            nbk = nbk + steal_ok.long()
            if dup:
                ndone = ndone + take.long()
            else:
                stolen = stolen | ((oreq_ids == jh[:, None])
                                   & steal_ok[:, None])
                if not dyn:
                    ndone = ndone + do_comp.long()
            qseq = torch.where(m_ins, stepc[:, None], qseq)
        if res:
            qsq = torch.where(m_ins, stp[:, None], qsq)

        # -- dispatch on the node the event touched (an activation's: the
        # new node; a running call's deadline: its node): its least frozen
        # priority, first index (under hedge and res: least push sequence)
        # on ties
        k_d = torch.where(do_ins, k_arr, kn)
        if dyn:
            ka = torch.where(act_pend, act_t, inf).argmin(1)
            k_d = torch.where(do_act, ka, k_d)
        if res and any_to:
            k_d = torch.where(do_to & is_run, rn, k_d)
        prio_vec = torch.where(pend & (node_of == k_d[:, None]), fprio, inf)
        if hedge or res:
            prio_j = prio_vec.min(1).values
            j = torch.where(prio_vec == prio_j[:, None],
                            qseq if hedge else qsq, 2 ** 30).argmin(1)
        else:
            j = prio_vec.argmin(1)
            prio_j = prio_vec[rows, j]
        if dyn:
            can = ((do_ins | do_comp | do_act) & active[rows, k_d]
                   & (busy[rows, k_d] < cores) & (prio_j < inf))
        elif hedge:
            can = ((do_ins | do_comp) & (busy[rows, k_d] < cores)
                   & (prio_j < inf))
        elif res:
            # a queued call's deadline and a shed free no slot
            freed = do_ins | do_comp
            if any_to:
                freed = freed | (do_to & is_run)
            can = freed & (busy[rows, k_d] < cores) & (prio_j < inf)
        else:
            can = ~none_left & (busy[rows, k_d] < cores) & (prio_j < inf)
        cost_j, p_j = cost[rows, j], p[rows, j]
        if cold:
            # -- acquire: a free container of the node and function is a
            # warm hit, else a prewarmed one starts cold; the flag is the
            # original's own dispatch's
            f_j = fnid[rows, j]
            warm_hit = freec[rows, k_d, f_j] > 0
            cost_j = cost_j + torch.where(warm_hit, zero, extra)
            freec[rows, k_d, f_j] -= (can & warm_hit).long()
            ncold = ncold + (can & ~warm_hit).long()
            coldq = torch.where((oreq_ids == j[:, None]) & can[:, None],
                                ~warm_hit[:, None], coldq)
        if het:
            # the node's speed at dispatch, eff = spd / slowdown, divides
            # cost and runtime, as (x * slowdown) / spd (XLA's compilation
            # of the oracle's x / eff); the slot keeps eff itself
            spd_k, slow = inp["spd"][rows, k_d], _slowdown(inp, k_d, now)
            eff = spd_k / slow
            cost_j, p_j = cost_j * slow / spd_k, p_j * slow / spd_k
        exec_start = torch.maximum(now, chan[rows, k_d]) + cost_j
        m_kd = (node_ids == k_d[:, None]) & can[:, None]
        chan = torch.where(m_kd, exec_start[:, None], chan)
        fin_j = exec_start + p_j
        slot_free = (torch.isinf(fin_s[rows, k_d])
                     & (slot_ids[:, 0] < cores[:, None]))
        s = slot_free.to(torch.int32).argmax(1)
        m_ds = m_kd[:, :, None] & (slot_ids == s[:, None, None])
        fin_s = torch.where(m_ds, fin_j[:, None, None], fin_s)
        idx_s = torch.where(m_ds, j[:, None, None], idx_s)
        if dyn:
            dseq = torch.where(m_ds, dcnt[:, None, None], dseq)
            dcnt = dcnt + can.long()
        if het:
            sspd = torch.where(m_ds, eff[:, None, None], sspd)
        if res:
            # the slot's start (wasted work), the call's E[p] off the gauge
            sst = torch.where(m_ds, exec_start[:, None, None], sst)
            qep = qep - torch.where(can, eps[rows, j], zero)
        busy = busy + m_kd.long()
        qn = qn - m_kd.long()
        m_j = (req_ids == j[:, None]) & can[:, None]
        pend = pend & ~m_j
        if hedge:
            # a dispatched original's watch can never act again; a copy's
            # dispatch leaves it live
            m_oj = (oreq_ids == j[:, None]) & can[:, None]
            hedge_t = torch.where(m_oj, inf, hedge_t)
            if dyn:
                hedge_t2 = torch.where(m_oj, inf, hedge_t2)
            # every step counts, the no-op fires too; the steps past a
            # cell's last event change nothing
            stepc = stepc + 1
            nstep = nstep + (~none_left).long()
        if res:
            stp = stp + 1
            nstep = nstep + (~none_left).long()
        if dup:
            start_q = torch.where(m_j, exec_start[:, None], start_q)
        if dyn and any_act:
            # the activation stays pending while its node can take more
            still = (do_act & can & (qn.sum(1) > 0)
                     & (busy[rows, ka] < cores))
            act_pend = torch.where((node_ids == ka[:, None])
                                   & do_act[:, None], still[:, None],
                                   act_pend)

        # -- per-dispatch record; no-op events land on sentinel row n ------
        if not dup:
            jn = torch.where(can, j, n)
            start[rows, jn] = exec_start
            finish[rows, jn] = fin_j
    aux = {}
    i32 = torch.int32
    if dyn:
        aux = {"nfail": nfail.to(i32), "ndone": ndone.to(i32),
               "prov": prov.to(i32), "act_t": act_t, "dead": dead}
    if cold:
        aux.update(ncold=ncold.to(i32), nevt=nevt.to(i32), coldq=coldq)
    if hedge:
        aux.update(nbk=nbk.to(i32), nstl=stolen.sum(1).to(i32),
                   att=att.to(i32), ndone=ndone.to(i32),
                   stepc=(stepc0 + nstep).to(i32))
    if res:
        aux.update(nto=nto.to(i32), nsh=nsh.to(i32), nrt=nrt.to(i32),
                   wst=wst, nfl=nfl, fcz=fcz.to(i32), ratt=ratt.to(i32),
                   ndn=ndn.to(i32), stepc=(stp0 + nstep).to(i32))
    if stream:
        # the final carry, every entry; the step counts are the JAX scan's,
        # which counts all n_steps steps
        fin = {"ai": ai, "head": st["head"], "fin_s": fin_s, "idx_s": idx_s,
               "busy": busy, "qn": qn, "chan": chan, "ring": ring,
               "rsum": rsum, "rlen": rlen, "rpos": rpos, "last_t": last_t,
               "prev_t": prev_t, "narr": narr, "pend": pend, "fprio": fprio,
               "node_of": node_of}
        if fc_push:
            fin.update(fcr=fcr, fcp=fcp)
        if cold:
            fin.update(freec=freec, ncold=ncold, nevt=nevt, coldq=coldq)
        if hedge:
            fin.update(hedge_t=hedge_t, att=att, nbk=nbk, stolen=stolen,
                       cring=cring, crsum=crsum, crlen=crlen, crpos=crpos,
                       qseq=qseq, stepc=stepc0 + n_steps, ndone=ndone)
            if dyn:
                fin.update(unhedge=unhedge, hedge_t2=hedge_t2)
        if het:
            fin["sspd"] = sspd
        if dyn:
            fin.update(act_t=act_t, dead=dead, killq=killq,
                       act_pend=act_pend, rearr=rearr, next_tick=next_tick,
                       prov=prov, nfail=nfail, ndone=ndone, dseq=dseq,
                       dcnt=dcnt, rord=rord)
        if res:
            fin.update(to_t=to_t, rto=rto, eps=eps, qep=qep, ratt=ratt,
                       nfl=nfl, fcz=fcz, sst=sst, nto=nto, nsh=nsh, nrt=nrt,
                       wst=wst, ndn=ndn, qsq=qsq, stp=stp0 + n_steps,
                       zring=zring, zrsum=zrsum, zrlen=zrlen, zrpos=zrpos)
        aux["clk"], aux["ctr"] = layout.pack(fin)
    if dup:
        return win_start, win_fin, fprio[:, :n1], win_node, aux
    return start, finish, fprio, node_of, aux
