"""The scan carry as two packed planes (own port of
``repro.core.fastpath._PlaneLayout`` / ``_make_state0`` / ``_make_planes``
for the base pull carry, the frozen-priority segments ``freeze`` and
``fc_push``, the container segment ``cold``, the straggler-hedging
segments ``hedge`` and ``dup``, the per-slot speeds ``het`` of the
frozen-priority regime, the capacity-dynamics segment ``dyn``, the
request-lifecycle segment ``res`` and the chunked-stream segment
``stream``, which only the pull regime's carry grows: a frozen-priority
stream carries what its whole-burst scan does, as in the JAX package).

Every float entry of a cell's carry flattens into one **clocks plane**
(``clk``, in the bucket's float type: float32, or float64 for dynamic,
heterogeneous, cold, hedged and resilience buckets) and every int/bool
entry into one
**counters plane** (``ctr``, int32), in sorted-key order.  The layout is a pure
function of the carry's shapes, so the packer here and the kernels'
unpackers (the CUDA ``event_step`` kernels take the offsets as launch
arguments) agree by construction, and the offsets equal the JAX package's
for the same bucket.
"""

from __future__ import annotations

import torch

# per-key kind: "f" float (clk plane), "i" int32 / "b" bool (ctr plane)
_FLOAT, _INT, _BOOL = "f", "i", "b"


def carry_spec(*, n_nodes: int, n_slots: int, window: int, n_fns: int,
               freeze: bool = False, fc_push: bool = False, n1: int = 0,
               fc_ring: int = 1, dyn: bool = False, het: bool = False,
               cold: bool = False, hedge: bool = False, dup: bool = False,
               n_copies: int = 1, res: bool = False,
               stream: bool = False) -> dict[str, tuple[tuple[int, ...], str]]:
    """Shapes and kinds of one cell's carry: slots, queue heads, channel
    clocks and the estimator rings -- the controller's (an estimator axis
    of length 1) in the pull regime, one per node with ``freeze`` -- then,
    in the JAX package's ``_CARRY_SEGMENTS`` order, the frozen queue
    entries (``freeze``: pending flag, priority and node of each of the
    ``n1`` rows), the per-(node, function) arrival-time rings of
    ``fc_ring`` entries (``fc_push``), the containers (``cold``: each
    (node, function)'s free containers, the cold starts and evictions,
    each row's cold-start flag), the hedge watches (``hedge``: each row's
    deadline, attempts and stolen flag, the backups issued, the
    controller's estimator ring, each queue entry's push sequence, the
    step count and the calls done; with ``dyn`` each row's no-more-hedging
    flag and, with ``freeze``, its second deadline), the racing copies
    (``dup``: each row's first-completion flag, the winner's start, finish
    and node, each queue entry's start; the queue entries -- ``pend``,
    ``fprio``, ``node_of``, ``qseq``, ``start_q`` -- are then ``n_copies *
    n1`` long, entry ``c * n1 + j`` copy ``c`` of row ``j``), each slot's
    effective speed at dispatch
    (``het`` with ``freeze``; pull ``het`` adds no carry) and the capacity
    dynamics (``dyn``: each node's activation time, dead flag, kill time
    and pending activation; each row's re-arrival time; the next
    autoscaler tick, the nodes provisioned, the calls lost and the calls
    done; then under pull each row's re-queued flag, re-queue clock and
    enqueue time, with ``freeze`` each slot's launch sequence, the launch
    count and each row's re-route rank), then the request lifecycle
    (``res``: each row's timeout deadline, retry re-arrival time and the
    E[p] its admission added to the shed gauge, the gauge itself, each
    row's submissions, terminal-failure flag and cause (1 timeout, 2 shed),
    each slot's execution start, the timeouts, sheds and retries counted,
    the wasted seconds, the calls resolved, each row's push sequence and
    the step count, and the controller's estimator ring), and last the
    chunked stream of the pull regime (``stream`` without ``freeze``: each
    function's chunk-rebased count of the calls its queue window holds,
    ``qcnt``, which the head-window validity test reads in place of the
    cumulative ``narr``)."""
    n_est = n_nodes if freeze else 1
    nq = n_copies * n1 if dup else n1
    spec = {
        "ai": ((), _INT),
        "head": ((n_fns,), _INT),
        "fin_s": ((n_nodes, n_slots), _FLOAT),
        "idx_s": ((n_nodes, n_slots), _INT),
        "busy": ((n_nodes,), _INT),
        "qn": ((n_nodes,), _INT),
        "chan": ((n_nodes,), _FLOAT),
        "ring": ((n_est, n_fns, window), _FLOAT),
        "rsum": ((n_est, n_fns), _FLOAT),
        "rlen": ((n_est, n_fns), _INT),
        "rpos": ((n_est, n_fns), _INT),
        "last_t": ((n_est, n_fns), _FLOAT),
        "prev_t": ((n_est, n_fns), _FLOAT),
        "narr": ((n_est, n_fns), _INT),
    }
    if freeze:
        spec.update(pend=((nq,), _BOOL), fprio=((nq,), _FLOAT),
                    node_of=((nq,), _INT))
    if fc_push:
        spec.update(fcr=((n_nodes, n_fns, fc_ring), _FLOAT),
                    fcp=((n_nodes, n_fns), _INT))
    if cold:
        spec.update(freec=((n_nodes, n_fns), _INT), ncold=((), _INT),
                    nevt=((), _INT), coldq=((n1,), _BOOL))
    if hedge:
        spec.update(hedge_t=((n1,), _FLOAT), att=((n1,), _INT),
                    nbk=((), _INT), stolen=((n1,), _BOOL),
                    cring=((n_fns, window), _FLOAT), crsum=((n_fns,), _FLOAT),
                    crlen=((n_fns,), _INT), crpos=((n_fns,), _INT),
                    qseq=((nq,), _INT), stepc=((), _INT), ndone=((), _INT))
        if dyn:
            spec["unhedge"] = ((n1,), _BOOL)
            if freeze:
                spec["hedge_t2"] = ((n1,), _FLOAT)
    if dup:
        spec.update(done0=((n1,), _BOOL), win_start=((n1,), _FLOAT),
                    win_fin=((n1,), _FLOAT), win_node=((n1,), _INT),
                    start_q=((nq,), _FLOAT))
    if het and freeze:
        spec.update(sspd=((n_nodes, n_slots), _FLOAT))
    if dyn:
        spec.update(act_t=((n_nodes,), _FLOAT), dead=((n_nodes,), _BOOL),
                    killq=((n_nodes,), _FLOAT),
                    act_pend=((n_nodes,), _BOOL), rearr=((n1,), _FLOAT),
                    next_tick=((), _FLOAT), prov=((), _INT),
                    nfail=((), _INT), ndone=((), _INT))
        if freeze:
            spec.update(dseq=((n_nodes, n_slots), _INT), dcnt=((), _INT),
                        rord=((n1,), _INT))
        else:
            spec.update(xq=((n1,), _BOOL), rq_rt=((n1,), _FLOAT),
                        enq_t=((n1,), _FLOAT))
    if res:
        spec.update(to_t=((n1,), _FLOAT), rto=((n1,), _FLOAT),
                    eps=((n1,), _FLOAT), qep=((), _FLOAT),
                    ratt=((n1,), _INT), nfl=((n1,), _BOOL),
                    fcz=((n1,), _INT), sst=((n_nodes, n_slots), _FLOAT),
                    nto=((), _INT), nsh=((), _INT), nrt=((), _INT),
                    wst=((), _FLOAT), ndn=((), _INT), qsq=((n1,), _INT),
                    stp=((), _INT), zring=((n_fns, window), _FLOAT),
                    zrsum=((n_fns,), _FLOAT), zrlen=((n_fns,), _INT),
                    zrpos=((n_fns,), _INT))
    if stream and not freeze:
        spec["qcnt"] = ((n_fns,), _INT)
    return spec


class PlaneLayout:
    """Offsets of each carry entry in the ``(clk, ctr)`` plane pair.

    ``fparts`` holds ``(key, lo, hi, shape)`` and ``iparts``
    ``(key, lo, hi, shape, isbool)``, in the JAX package's tuple form."""

    __slots__ = ("fparts", "iparts", "f_len", "i_len")

    def __init__(self, spec: dict[str, tuple[tuple[int, ...], str]]):
        self.fparts: list[tuple[str, int, int, tuple]] = []
        self.iparts: list[tuple[str, int, int, tuple, bool]] = []
        fo = io = 0
        for k in sorted(spec):
            shape, kind = spec[k]
            size = 1
            for d in shape:
                size *= int(d)
            if kind == _FLOAT:
                self.fparts.append((k, fo, fo + size, tuple(shape)))
                fo += size
            else:
                self.iparts.append((k, io, io + size, tuple(shape),
                                    kind == _BOOL))
                io += size
        self.f_len, self.i_len = fo, io

    def offsets(self) -> dict[str, int]:
        """Start offset of every entry within its plane."""
        return {k: lo for k, lo, *_ in self.fparts + self.iparts}

    def pack(self, st: dict[str, torch.Tensor]):
        """Batched carry dict (leading cell axis) -> ``(clk, ctr)``."""
        clk = torch.cat([st[k].reshape(st[k].shape[0], -1)
                         for k, *_ in self.fparts], dim=1)
        ctr = torch.cat([st[k].reshape(st[k].shape[0], -1).to(torch.int32)
                         for k, *_ in self.iparts], dim=1)
        return clk, ctr

    def unpack(self, clk: torch.Tensor, ctr: torch.Tensor) -> dict:
        """``(clk, ctr)`` -> batched carry dict of views into the planes
        (bool entries come back as new tensors)."""
        B = clk.shape[0]
        st = {}
        for k, lo, hi, shape in self.fparts:
            st[k] = clk[:, lo:hi].reshape(B, *shape)
        for k, lo, hi, shape, isbool in self.iparts:
            v = ctr[:, lo:hi].reshape(B, *shape)
            st[k] = v.to(torch.bool) if isbool else v
        return st


def carry_layout(*, n_nodes: int, n_slots: int, window: int, n_fns: int,
                 freeze: bool = False, fc_push: bool = False, n1: int = 0,
                 fc_ring: int = 1, dyn: bool = False, het: bool = False,
                 cold: bool = False, hedge: bool = False, dup: bool = False,
                 n_copies: int = 1, res: bool = False,
                 stream: bool = False) -> PlaneLayout:
    return PlaneLayout(carry_spec(n_nodes=n_nodes, n_slots=n_slots,
                                  window=window, n_fns=n_fns, freeze=freeze,
                                  fc_push=fc_push, n1=n1, fc_ring=fc_ring,
                                  dyn=dyn, het=het, cold=cold, hedge=hedge,
                                  dup=dup, n_copies=n_copies, res=res,
                                  stream=stream))


def make_state0(inp: dict[str, torch.Tensor], *, n_nodes: int, n_slots: int,
                window: int, freeze: bool = False, fc_push: bool = False,
                fc_ring: int = 1, dyn: bool = False, het: bool = False,
                cold: bool = False, hedge: bool = False, dup: bool = False,
                n_copies: int = 1, res: bool = False, stream: bool = False
                ) -> dict[str, torch.Tensor]:
    """Initial batched carry of a bucket: empty slots and queues, idle
    channels, the estimator rings from the bucket's inputs, with ``freeze``
    / ``fc_push`` no queued entry and empty arrival rings, with ``cold``
    every container pool empty (no warm-up) and no cold start, with
    ``hedge`` no watch armed, no attempt or backup and the controller's
    ring empty (it has no warm-up), with ``dup`` no winner yet, with
    ``het`` and ``freeze`` every slot's speed 1, and with ``dyn``
    the activation and kill times of the inputs ``act0`` / ``killt``, no
    node dead or pending, no re-arrival, the first tick at the autoscale
    interval (+inf without the autoscaler), the cell's nodes provisioned,
    and under pull every row enqueued at its receive time, with ``freeze``
    no launch counted and every rank 0, and with ``res`` no deadline or
    retry pending, nothing counted, the gauge at 0 and the controller's
    ring empty (nodes get the warm-up's seed, the controller none), and
    with ``stream`` under pull no call counted in any queue window."""
    t = inp["t"]
    B, ft, dev = t.shape[0], t.dtype, t.device
    n_est, n_fns = inp["ring0"].shape[1], inp["ring0"].shape[2]
    i32 = dict(dtype=torch.int32, device=dev)
    st = {
        "ai": torch.zeros(B, **i32),
        "head": torch.zeros(B, n_fns, **i32),
        "fin_s": torch.full((B, n_nodes, n_slots), float("inf"), dtype=ft,
                            device=dev),
        "idx_s": torch.zeros(B, n_nodes, n_slots, **i32),
        "busy": torch.zeros(B, n_nodes, **i32),
        "qn": torch.zeros(B, n_nodes, **i32),
        "chan": torch.zeros(B, n_nodes, dtype=ft, device=dev),
        "ring": inp["ring0"], "rsum": inp["rsum0"],
        "rlen": inp["rlen0"], "rpos": inp["rpos0"],
        "last_t": torch.zeros(B, n_est, n_fns, dtype=ft, device=dev),
        "prev_t": torch.zeros(B, n_est, n_fns, dtype=ft, device=dev),
        "narr": torch.zeros(B, n_est, n_fns, **i32),
    }
    n1 = t.shape[1]
    nq = n_copies * n1 if dup else n1
    if freeze:
        st.update(pend=torch.zeros(B, nq, dtype=torch.bool, device=dev),
                  fprio=torch.zeros(B, nq, dtype=ft, device=dev),
                  node_of=torch.zeros(B, nq, **i32))
    if fc_push:
        st.update(fcr=torch.full((B, n_nodes, n_fns, fc_ring), -float("inf"),
                                 dtype=ft, device=dev),
                  fcp=torch.zeros(B, n_nodes, n_fns, **i32))
    if cold:
        st.update(freec=torch.zeros(B, n_nodes, n_fns, **i32),
                  ncold=torch.zeros(B, **i32), nevt=torch.zeros(B, **i32),
                  coldq=torch.zeros(B, t.shape[1], dtype=torch.bool,
                                    device=dev))
    if hedge:
        st.update(hedge_t=torch.full((B, n1), float("inf"), dtype=ft,
                                     device=dev),
                  att=torch.zeros(B, n1, **i32), nbk=torch.zeros(B, **i32),
                  stolen=torch.zeros(B, n1, dtype=torch.bool, device=dev),
                  cring=torch.zeros(B, n_fns, window, dtype=ft, device=dev),
                  crsum=torch.zeros(B, n_fns, dtype=ft, device=dev),
                  crlen=torch.zeros(B, n_fns, **i32),
                  crpos=torch.zeros(B, n_fns, **i32),
                  qseq=torch.zeros(B, nq, **i32), stepc=torch.zeros(B, **i32),
                  ndone=torch.zeros(B, **i32))
        if dyn:
            st["unhedge"] = torch.zeros(B, n1, dtype=torch.bool, device=dev)
            if freeze:
                st["hedge_t2"] = torch.full((B, n1), float("inf"), dtype=ft,
                                            device=dev)
    if dup:
        st.update(done0=torch.zeros(B, n1, dtype=torch.bool, device=dev),
                  win_start=torch.zeros(B, n1, dtype=ft, device=dev),
                  win_fin=torch.zeros(B, n1, dtype=ft, device=dev),
                  win_node=torch.zeros(B, n1, **i32),
                  start_q=torch.zeros(B, nq, dtype=ft, device=dev))
    if het and freeze:
        st["sspd"] = torch.ones(B, n_nodes, n_slots, dtype=ft, device=dev)
    if dyn:
        dynp = inp["dynp"]
        st.update(act_t=inp["act0"],
                  dead=torch.zeros(B, n_nodes, dtype=torch.bool, device=dev),
                  killq=inp["killt"],
                  act_pend=torch.zeros(B, n_nodes, dtype=torch.bool,
                                       device=dev),
                  rearr=torch.full((B, n1), float("inf"), dtype=ft,
                                   device=dev),
                  next_tick=torch.where(dynp[:, 4] > 0, dynp[:, 0],
                                        float("inf")),
                  prov=inp["nodes"].to(torch.int32),
                  nfail=torch.zeros(B, **i32), ndone=torch.zeros(B, **i32))
        if freeze:
            st.update(dseq=torch.zeros(B, n_nodes, n_slots, **i32),
                      dcnt=torch.zeros(B, **i32),
                      rord=torch.zeros(B, n1, **i32))
        else:
            st.update(xq=torch.zeros(B, n1, dtype=torch.bool, device=dev),
                      rq_rt=torch.zeros(B, n1, dtype=ft, device=dev),
                      enq_t=t)
    if res:
        fz = dict(dtype=ft, device=dev)
        st.update(to_t=torch.full((B, n1), float("inf"), **fz),
                  rto=torch.full((B, n1), float("inf"), **fz),
                  eps=torch.zeros(B, n1, **fz), qep=torch.zeros(B, **fz),
                  ratt=torch.zeros(B, n1, **i32),
                  nfl=torch.zeros(B, n1, dtype=torch.bool, device=dev),
                  fcz=torch.zeros(B, n1, **i32),
                  sst=torch.zeros(B, n_nodes, n_slots, **fz),
                  nto=torch.zeros(B, **i32), nsh=torch.zeros(B, **i32),
                  nrt=torch.zeros(B, **i32), wst=torch.zeros(B, **fz),
                  ndn=torch.zeros(B, **i32), qsq=torch.zeros(B, n1, **i32),
                  stp=torch.zeros(B, **i32),
                  zring=torch.zeros(B, n_fns, window, **fz),
                  zrsum=torch.zeros(B, n_fns, **fz),
                  zrlen=torch.zeros(B, n_fns, **i32),
                  zrpos=torch.zeros(B, n_fns, **i32))
    if stream and not freeze:
        st["qcnt"] = torch.zeros(B, n_fns, **i32)
    return st


def make_planes(inp: dict[str, torch.Tensor], *, n_nodes: int, n_slots: int,
                window: int, freeze: bool = False, fc_push: bool = False,
                fc_ring: int = 1, dyn: bool = False, het: bool = False,
                cold: bool = False, hedge: bool = False, dup: bool = False,
                n_copies: int = 1, res: bool = False, stream: bool = False):
    """Per-cell initial carry of a bucket as the packed ``(clk, ctr)``
    planes, shapes ``(B, f_len)`` in the bucket's float type and ``(B,
    i_len)`` int32."""
    seg = dict(freeze=freeze, fc_push=fc_push, fc_ring=fc_ring, dyn=dyn,
               het=het, cold=cold, hedge=hedge, dup=dup, n_copies=n_copies,
               res=res, stream=stream)
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=inp["ring0"].shape[2],
                          n1=inp["t"].shape[1], **seg)
    return layout.pack(make_state0(inp, n_nodes=n_nodes, n_slots=n_slots,
                                   window=window, **seg))
