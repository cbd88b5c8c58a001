"""Dispatch of the port's kernels: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.

Counterpart of ``repro.kernels.ops``.  There is no fallback: a CUDA tensor
goes to the kernel or the call raises, and the plain version runs on the
card only when the caller asks for it with ``force="ref"``.

Each kernel counts the calls that launched it and the calls that ran its
plain version: ``KERNEL_LAUNCHES`` / ``REF_LAUNCHES`` for ``event_step``'s
pull kernel, ``FREEZE_LAUNCHES`` / ``FREEZE_REF_LAUNCHES`` for its
frozen-priority kernel (single-node and push buckets), ``DYN_LAUNCHES`` /
``DYN_REF_LAUNCHES`` for its float64 pull kernel (pull buckets with
capacity dynamics, node speeds or cold starts), ``FREEZE64_LAUNCHES`` /
``FREEZE64_REF_LAUNCHES`` for its float64 frozen-priority kernel
(single-node and push buckets with them), ``HEDGE_LAUNCHES`` /
``HEDGE_REF_LAUNCHES`` for that kernel's hedged instantiations (push
buckets with straggler hedging, steal or duplicate; their own sources),
``RES_LAUNCHES`` / ``RES_REF_LAUNCHES`` for its resilience instantiations
(push buckets with timeouts, retries or shedding; their own source),
``STREAM_LAUNCHES`` / ``STREAM_REF_LAUNCHES`` for the pull kernels' stream
instantiations (one chunk of the chunked stream replay, float32 or float64;
their own source), ``FREEZE_STREAM_LAUNCHES`` /
``FREEZE_STREAM_REF_LAUNCHES`` for the two frozen-priority kernels' stream
instantiations (one chunk of a push or single-node stream, float32 or
float64, the hedged and resilience sets included; their own source),
``FLASH_LAUNCHES`` / ``FLASH_REF_LAUNCHES`` and ``DECODE_LAUNCHES`` /
``DECODE_REF_LAUNCHES`` for the attention kernels, ``RGLRU_LAUNCHES`` /
``RGLRU_REF_LAUNCHES`` and ``RWKV6_LAUNCHES`` / ``RWKV6_REF_LAUNCHES`` for
the recurrences.  A count is one per call of the wrapper, however many
kernels the call launches (``decode_attention`` a split and a merge
kernel, ``rwkv6_scan`` three chunked passes at S > 16).  A caller sets
them to 0 before a run (``reset_launches``) and reads them after it
(``launches``).

The counts grow in Python, where a wrapper is called, so a CUDA graph's
replay adds nothing to them.  A graph's launches are counted once, at
capture (``counted_apart``), and its replays stand for that many each.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..core.planes import carry_layout
from .decode_attention import decode_attention_cuda, decode_attention_ref
from .event_step import event_step_ref, event_step_supported
from .flash_attention import flash_attention_cuda, flash_attention_ref
from .rglru_scan import rglru_scan_cuda, rglru_scan_ref
from .rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_ref

KERNEL_LAUNCHES = 0
REF_LAUNCHES = 0
FREEZE_LAUNCHES = 0
FREEZE_REF_LAUNCHES = 0
DYN_LAUNCHES = 0
DYN_REF_LAUNCHES = 0
FREEZE64_LAUNCHES = 0
FREEZE64_REF_LAUNCHES = 0
HEDGE_LAUNCHES = 0
HEDGE_REF_LAUNCHES = 0
RES_LAUNCHES = 0
RES_REF_LAUNCHES = 0
STREAM_LAUNCHES = 0
STREAM_REF_LAUNCHES = 0
FREEZE_STREAM_LAUNCHES = 0
FREEZE_STREAM_REF_LAUNCHES = 0
FLASH_LAUNCHES = 0
FLASH_REF_LAUNCHES = 0
DECODE_LAUNCHES = 0
DECODE_REF_LAUNCHES = 0
RGLRU_LAUNCHES = 0
RGLRU_REF_LAUNCHES = 0
RWKV6_LAUNCHES = 0
RWKV6_REF_LAUNCHES = 0


# each kernel's two counts: (launches of the kernel, runs of the plain
# version), by the names of the module's globals
_COUNTS = {
    "event_step": ("KERNEL_LAUNCHES", "REF_LAUNCHES"),
    "event_step_freeze": ("FREEZE_LAUNCHES", "FREEZE_REF_LAUNCHES"),
    "event_step_dyn": ("DYN_LAUNCHES", "DYN_REF_LAUNCHES"),
    "event_step_freeze64": ("FREEZE64_LAUNCHES", "FREEZE64_REF_LAUNCHES"),
    "event_step_hedge": ("HEDGE_LAUNCHES", "HEDGE_REF_LAUNCHES"),
    "event_step_res": ("RES_LAUNCHES", "RES_REF_LAUNCHES"),
    "event_step_stream": ("STREAM_LAUNCHES", "STREAM_REF_LAUNCHES"),
    "event_step_freeze_stream": ("FREEZE_STREAM_LAUNCHES",
                                 "FREEZE_STREAM_REF_LAUNCHES"),
    "flash_attention": ("FLASH_LAUNCHES", "FLASH_REF_LAUNCHES"),
    "decode_attention": ("DECODE_LAUNCHES", "DECODE_REF_LAUNCHES"),
    "rglru_scan": ("RGLRU_LAUNCHES", "RGLRU_REF_LAUNCHES"),
    "rwkv6_scan": ("RWKV6_LAUNCHES", "RWKV6_REF_LAUNCHES"),
}


def reset_launches() -> None:
    """Set every kernel's counts to 0."""
    for names in _COUNTS.values():
        for name in names:
            globals()[name] = 0


def launches() -> dict:
    """``{kernel: {"kernel": n, "plain": n}}`` since the last reset."""
    g = globals()
    return {k: {"kernel": g[a], "plain": g[b]}
            for k, (a, b) in _COUNTS.items()}


@contextlib.contextmanager
def counted_apart():
    """Counts of the wrapper calls made inside the block, kept out of the
    running counts: the block records its calls into a CUDA graph
    (``torch.cuda.graph``) and runs none of them, so each count goes back
    to its value before the block, and the dict yielded is filled, when the
    block ends, with the block's own counts as ``launches()`` gives them."""
    before = launches()
    out: dict = {}
    try:
        yield out
    finally:
        after = launches()
        g = globals()
        for k, (a, b) in _COUNTS.items():
            out[k] = {side: after[k][side] - before[k][side]
                      for side in ("kernel", "plain")}
            g[a], g[b] = before[k]["kernel"], before[k]["plain"]


def _check_force(force) -> None:
    if force not in (None, "ref"):
        raise ValueError(f"force must be None or 'ref', not {force!r}")

# carry entries in the order of ``struct Layout`` in
# csrc/event_step_pull.cuh (qcnt: a stream bucket's; absent, 0)
EVENT_STEP_LAYOUT = ("chan", "fin_s", "last_t", "prev_t", "ring", "rsum",
                     "ai", "busy", "head", "idx_s", "narr", "qn", "rlen",
                     "rpos", "qcnt")

# slots, nodes and functions one lane of the kernel holds in registers
# (``PL`` in csrc/event_step.cu): up to 32 * 8 = 256 of each a cell; a wider
# cell keeps them in device memory (the wide path)
EVENT_STEP_PER_LANE = (1, 2, 4, 8)
# lane-owned arrays of the wide path (``kWideArrays``), and those a stream
# bucket adds (``kStreamWideArrays``: each slot's row, each node's queue
# length, each function's qcnt)
EVENT_STEP_WIDE_ARRAYS = 20
EVENT_STEP_STREAM_WIDE_ARRAYS = 3
# shared memory one block may take on sm_90 (227 KB, opted in)
SMEM_BLOCK_BYTES = 232448
# bytes of one group summary on the float64 pull kernel's wide path
# (``dyn_group_bytes`` in csrc/event_step_pull.cuh): the least (base, head
# row)'s base and row and the least queued head row of 32 functions
EVENT_STEP_DYN_GROUP_BYTES = 16

# carry entries of the frozen-priority kernel, in the order of ``struct
# FLayout`` in csrc/event_step.cu (the push FC rings last: absent, 0)
EVENT_STEP_FREEZE_LAYOUT = ("chan", "fin_s", "fprio", "last_t", "prev_t",
                            "ring", "rsum", "fcr", "ai", "busy", "idx_s",
                            "narr", "node_of", "pend", "qn", "rlen", "rpos",
                            "fcp")
# lane-owned arrays of the frozen-priority kernel's wide path
# (``kFreezeWideArrays``): 5 a slot, 3 a node; a stream bucket keeps each
# slot's row too (``kFreezeStreamWideArrays``)
EVENT_STEP_FREEZE_WIDE_ARRAYS = 8
EVENT_STEP_FREEZE_STREAM_WIDE_ARRAYS = 1
# per-(node, function) estimator arrays of the frozen-priority kernel
# (``kEstArrays``): sum, last and previous arrival, length, position,
# arrivals, FC ring position
EVENT_STEP_FREEZE_EST_ARRAYS = 7

# carry entries of the float64 pull kernel, in the order of ``struct
# DLayout`` in csrc/event_step_pull.cuh (an entry of a segment the bucket
# lacks is 0: the dyn entries in a het or cold bucket, the cold ones
# without it, qcnt outside a stream bucket)
EVENT_STEP_DYN_LAYOUT = ("chan", "fin_s", "last_t", "prev_t", "ring", "rsum",
                         "act_t", "killq", "rearr", "next_tick", "rq_rt",
                         "enq_t", "ai", "busy", "head", "idx_s", "narr", "qn",
                         "rlen", "rpos", "dead", "act_pend", "prov", "nfail",
                         "ndone", "xq", "freec", "ncold", "nevt", "coldq",
                         "qcnt")

# carry entries of the float64 frozen-priority kernel, in the order of
# ``struct F64Layout`` in csrc/event_step_freeze64.cuh (an entry of a
# segment the bucket lacks is 0)
EVENT_STEP_FREEZE64_LAYOUT = (
    "chan", "fin_s", "fprio", "last_t", "prev_t", "ring", "rsum", "fcr",
    "sspd", "act_t", "killq", "rearr", "next_tick", "ai", "busy", "idx_s",
    "narr", "node_of", "pend", "qn", "rlen", "rpos", "fcp", "freec", "ncold",
    "nevt", "coldq", "dead", "act_pend", "prov", "nfail", "ndone", "dseq",
    "dcnt", "rord", "hedge_t", "hedge_t2", "cring", "crsum", "win_start",
    "win_fin", "start_q", "att", "nbk", "stolen", "crlen", "crpos", "qseq",
    "stepc", "unhedge", "done0", "win_node", "to_t", "rto", "eps", "qep",
    "sst", "wst", "zring", "zrsum", "ratt", "nfl", "fcz", "nto", "nsh", "nrt",
    "ndn", "qsq", "stp", "zrlen", "zrpos")
# lane-owned words of the float64 frozen-priority kernel's wide path
# (``kF64SlotWords``, ``kF64NodeWords``): 6 a slot, 12 a node
EVENT_STEP_FREEZE64_WIDE_WORDS = (6, 12)
# slots a lane the float64 frozen-priority kernel is built for in shared
# memory (the push grids' 4 x 8 cores and 3 x 6 autoscaled to 8 nodes); a
# wider cell takes its wide path
EVENT_STEP_FREEZE64_PER_LANE = (1, 2)

# the event-step launchers and their pointer arguments: inputs, outputs,
# scratch, layout, dims, plan; each in csrc/event_step.cu but the hedged,
# the resilience and the stream ones, in their own sources
# (``EVENT_STEP_SOURCES``); the hedged and resilience ones share one
# signature (``EVENT_STEP_F64_FAMILY_LAUNCHER`` in
# csrc/event_step_freeze64.cuh)
EVENT_STEP_LAUNCHERS = {"event_step_launch": 19,
                        "event_step_freeze_launch": 20,
                        "event_step_dyn_launch": 31,
                        "event_step_freeze64_launch": 33,
                        "event_step_hedge_launch": 46,
                        "event_step_dup_launch": 46,
                        "event_step_res_launch": 46,
                        "event_step_stream_launch": 22,
                        "event_step_dyn_stream_launch": 35,
                        "event_step_freeze_stream_launch": 23,
                        "event_step_freeze64_stream_launch": 50}
EVENT_STEP_SOURCES = {
    "event_step_hedge_launch": "event_step_hedge",
    "event_step_dup_launch": "event_step_dup",
    "event_step_res_launch": "event_step_res",
    "event_step_stream_launch": "event_step_stream",
    "event_step_dyn_stream_launch": "event_step_stream",
    "event_step_freeze_stream_launch": "event_step_freeze_stream",
    "event_step_freeze64_stream_launch": "event_step_freeze_stream"}
_event_step_fns: dict = {}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def event_step_cell_bytes(staged: bool, n1: int, n_fns: int,
                          window: int) -> int:
    """Shared-memory bytes of one cell in the kernel (``cell_bytes`` in
    csrc/event_step.cu): the runtime ring, and when ``staged`` the rows t /
    p / cost (float32) and fnid (8-bit); the queue sequences ``fn_ev`` stay
    in device memory."""
    nbytes = 4 * _round_up(n_fns * window, 4)
    if staged:
        nbytes += 12 * _round_up(n1, 4) + _round_up(n1, 16)
    return nbytes


def event_step_dyn_cell_bytes(staged: bool, n1: int, n_fns: int,
                              window: int, n_free: int = 0) -> int:
    """Shared-memory bytes of one cell in the float64 pull kernel
    (``dyn_cell_bytes`` in csrc/event_step.cu): the runtime ring, when
    ``staged`` the rows t / p / cost (float64) and fnid (8-bit), then the
    ``n_free`` free-container counts of a cold cell (int32, nodes x
    functions)."""
    nbytes = 8 * _round_up(n_fns * window, 2) + 4 * _round_up(n_free, 4)
    if staged:
        nbytes += 24 * _round_up(n1, 2) + _round_up(n1, 16)
    return nbytes


def _dyn_plan(n1: int, n_nodes: int, n_slots: int, n_fns: int, window: int,
              dyn: bool, cold: bool, stream: bool = False) -> dict:
    """The float64 pull kernel's plan (see :func:`event_step_plan`)."""
    nsl = n_nodes * n_slots
    per_lane = next((pl for pl in EVENT_STEP_PER_LANE if 32 * pl >= nsl),
                    None)
    wide = per_lane is None or n_nodes > 32 or n_fns > 32
    n_free = n_nodes * n_fns if cold else 0
    staged, cell, words = False, 0, 0
    if wide:
        per_lane = max(1, -(-nsl // 32))
        sw = int(stream)         # a node's qn, a function's qcnt
        plf = -(-n_fns // 32)    # functions a lane, and groups
        words = (2 * _round_up(n_fns * window, 2)
                 + 32 * (3 * per_lane + (11 + sw) * -(-n_nodes // 32)
                         + (16 + sw) * plf)
                 + _round_up(n_free, 2))
        # the group summaries: in shared memory, else in the scratch
        groups = EVENT_STEP_DYN_GROUP_BYTES * plf
        if groups <= SMEM_BLOCK_BYTES:
            cell = groups
        else:
            words += groups // 4
    else:
        staged = event_step_dyn_cell_bytes(True, n1, n_fns, window,
                                           n_free) <= SMEM_BLOCK_BYTES
        cell = event_step_dyn_cell_bytes(staged, n1, n_fns, window, n_free)
    if dyn:
        words += 7 * _round_up(n1, 2) + 2 * n_fns
    return {"per_lane": per_lane, "wide": wide, "staged": staged,
            "cell_bytes": cell, "scratch_words": words}


def event_step_freeze64_cell_bytes(staged: bool, n1: int, n_nodes: int,
                                   n_fns: int, window: int, cold: bool,
                                   hedge: bool = False, dyn: bool = False,
                                   dup: bool = False, n_copies: int = 1,
                                   res: bool = False) -> int:
    """Bytes of one cell's estimators, queue and free containers, hedge or
    res state and, when ``staged``, its rows, in the float64
    frozen-priority kernel (``f64_cell_bytes`` in
    csrc/event_step_freeze64.cuh): the float64 arrays (sum, last and
    previous arrival, rings; with ``hedge`` or ``res`` the controller's
    sums and ring; rows t / p / cost; queue keys; with ``hedge`` each row's
    deadline, two with ``dyn``; with ``res`` each row's deadline, retry
    re-arrival time and admitted E[p]; with ``dup`` each queue entry's
    start), the int32 ones (length, position, arrivals, FC ring position;
    with ``cold`` the free containers; queue nodes; with ``hedge`` or
    ``res`` the controller's lengths and positions, each row's word -- its
    attempts and flags, or submissions, failure flag and cause -- and each
    entry's push sequence) and the 8-bit fnid.  Under ``dup`` the queue has
    ``n_copies * n1`` entries."""
    e = n_nodes * n_fns
    nq = n_copies * n1 if dup else n1
    r2, q2, q4 = _round_up(n1, 2), _round_up(nq, 2), _round_up(nq, 4)
    f64 = (3 * _round_up(e, 2) + _round_up(e * window, 2)
           + (3 if staged else 0) * r2 + q2)
    i32 = 4 * _round_up(e, 4) + _round_up(e if cold else 0, 4) + q4
    if hedge or res:
        f64 += _round_up(n_fns, 2) + _round_up(n_fns * window, 2)
        i32 += 2 * _round_up(n_fns, 4) + _round_up(n1, 4) + q4
    if hedge:
        f64 += (2 if dyn else 1) * r2 + (q2 if dup else 0)
    if res:
        f64 += 3 * r2
    nbytes = 8 * f64 + 4 * i32 + (_round_up(n1, 16) if staged else 0)
    return _round_up(nbytes, 16)


def _freeze64_plan(n1: int, n_nodes: int, n_slots: int, n_fns: int,
                   window: int, fc_push: bool, fc_ring: int, dyn: bool,
                   cold: bool, hedge: bool, dup: bool,
                   n_copies: int, res: bool = False,
                   stream: bool = False) -> dict:
    """The float64 frozen-priority kernel's plan (see
    :func:`event_step_plan`)."""
    nsl = n_nodes * n_slots
    # the stream sets are built for the wide path alone (a stream bucket is
    # one cell, so no block shares its shared memory), which keeps their
    # source's build within that of the others
    per_lane = None if stream else next(
        (pl for pl in EVENT_STEP_FREEZE64_PER_LANE if 32 * pl >= nsl), None)
    hs = dict(hedge=hedge, dyn=dyn, dup=dup, n_copies=n_copies, res=res)
    cell = event_step_freeze64_cell_bytes(True, n1, n_nodes, n_fns, window,
                                          cold, **hs)
    staged = (per_lane is not None and n_nodes <= 32 and n_fns <= 256
              and cell <= SMEM_BLOCK_BYTES)
    words = 0
    # a stream cell keeps its per-(node, function) arrays (estimators,
    # rings, FC rings, free containers) in its output planes: the scratch
    # holds none of them (no node's, as far as its size goes)
    e_nodes = 0 if stream else n_nodes
    if not staged:
        per_lane = max(1, -(-nsl // 32))
        slot_w, node_w = EVENT_STEP_FREEZE64_WIDE_WORDS
        words = (32 * (slot_w * per_lane + node_w * -(-n_nodes // 32))
                 + event_step_freeze64_cell_bytes(
                     False, n1, e_nodes, n_fns, window, cold, **hs) // 4)
    if dyn:
        words += 2 * _round_up(n1, 2) + _round_up(n1, 4)
    if fc_push:
        words += 2 * e_nodes * n_fns * fc_ring
    return {"per_lane": per_lane, "wide": not staged, "staged": staged,
            "cell_bytes": cell if staged else 0, "scratch_words": words}


def event_step_plan(*, n1: int, n_nodes: int, n_slots: int, n_fns: int,
                    window: int, freeze: bool = False, fc_push: bool = False,
                    fc_ring: int = 1, f64: bool = False,
                    dyn: bool = False, cold: bool = False,
                    hedge: bool = False, dup: bool = False,
                    n_copies: int = 1, res: bool = False,
                    stream: bool = False) -> dict:
    """How the kernel runs a bucket of this shape, from the shape alone:
    the pull kernel's plan, with ``freeze`` the frozen-priority kernel's
    (whose push FC rings, ``fc_push``, take ``fc_ring`` entries), with
    ``f64`` the float64 pull kernel's (``dyn`` / ``het`` / ``cold``
    buckets; ``dyn`` sizes its per-row scratch, ``cold`` its free-container
    counts), and with both the float64 frozen-priority kernel's.

    The float64 frozen-priority kernel owns up to 2 slots and one node a
    lane and stages, in shared memory, the rows t / p / cost (float64) and
    fnid (8-bit), the per-(node, function) estimators and rings (float64),
    the free containers (``cold``), the queue (a 64-bit key and a node a
    row) and with ``hedge`` the controller's ring, each row's deadlines
    and hedge word and each entry's push sequence (``dup``: ``n_copies``
    queue entries a row, each with its start; ``res``: the controller's
    ring, each row's deadline, retry re-arrival time, admitted E[p] and
    word and each entry's push sequence) when one cell's fit (n_b up
    to ~5,000 at the push widths, ~1,600 with 4 copies); else,
    or past 64 slots, 32 nodes or 256 functions, it takes the wide path
    (``per_lane`` = ceil(slots / 32)): all of that and its lane arrays in
    the scratch, rows read in place.  The scratch adds, with ``dyn``, 3
    words a row (re-arrival time, re-route rank), and with ``fc_push`` the
    float64 FC rings.

    The float64 pull kernel owns up to 8 slots and one node and one
    function a lane (``per_lane``: its slots a lane), its ring in shared
    memory, and stages the rows t / p / cost (float64) and fnid (8-bit) in
    shared memory when one cell's fit (n_b up to ~9,000); past 256 slots or
    32 nodes or functions it takes the wide path (``per_lane`` = ceil(slots
    / 32); ring and lane arrays in the scratch, rows in place, and in
    ``cell_bytes`` of shared memory the summaries of its ceil(functions /
    32) groups of 32 functions, ``EVENT_STEP_DYN_GROUP_BYTES`` each, or in
    the scratch when one block's shared memory cannot hold them).  With
    ``dyn`` the scratch adds 7 words a row (re-arrival, last pull clock and
    enqueue times, the re-queued flag) and 2 a function.  With ``cold`` each
    (node, function)'s free containers take a word, in shared memory after
    the rows, or in the scratch on the wide path; each row's cold-start
    flag is written to its output at dispatch, as its start is.

    ``per_lane``: slots, nodes and (pull) functions each lane owns (the
    least of ``EVENT_STEP_PER_LANE`` that covers all of them across 32
    lanes).  ``staged``: pull stages the cell's rows in shared memory when
    they fit in one block's (n_b up to ~17,800); freeze stages the
    estimators, the queue and the rows when one cell's fit (n_b up to
    ~11,000 at the mega widths) and ``fnid`` fits in 8 bits.  A bucket not
    staged reads its rows in place, and under freeze keeps its estimators
    and queue in a device-memory scratch.  ``cell_bytes``: the shared
    memory each cell (warp) takes.  ``wide``: a cell of more than 256
    slots or nodes (pull: or functions, or a runtime ring too large for
    shared memory) keeps what its lanes own (``per_lane`` = ceil(widest /
    32)) in the scratch too, so every width is taken.  The push FC rings
    are always in the scratch.  ``scratch_words``: the scratch's 32-bit
    words a cell.  A pull ``stream`` bucket's wide path keeps more there:
    ``EVENT_STEP_STREAM_WIDE_ARRAYS`` arrays in float32, a word a node and
    a function in float64.  A frozen-priority ``stream`` bucket keeps
    each slot's row too: one more array a slot on the float32 kernel's wide
    path; the float64 kernel's stream sets take its wide path, whatever the
    width.  Unstaged, a frozen-priority ``stream`` bucket reads and writes
    its per-(node, function) estimators, rings, FC rings and free
    containers in place in its output planes, so its scratch holds none of
    them."""
    if stream and dup:
        raise NotImplementedError("a stream bucket has no dup")
    if f64 and freeze:
        return _freeze64_plan(n1, n_nodes, n_slots, n_fns, window, fc_push,
                              fc_ring, dyn, cold, hedge, dup, n_copies, res,
                              stream)
    if f64:
        return _dyn_plan(n1, n_nodes, n_slots, n_fns, window, dyn, cold,
                         stream)
    if freeze:
        widest = max(n_nodes * n_slots, n_nodes)
    else:
        widest = max(n_nodes * n_slots, n_nodes, n_fns)
    per_lane = next((pl for pl in EVENT_STEP_PER_LANE if 32 * pl >= widest),
                    None)
    if freeze:
        wide = per_lane is None
        if wide:
            per_lane = -(-widest // 32)
        cell = event_step_freeze_cell_bytes(n1, n_nodes, n_fns, window)
        staged = not wide and n_fns <= 256 and cell <= SMEM_BLOCK_BYTES
        arrays = EVENT_STEP_FREEZE_WIDE_ARRAYS + (
            EVENT_STEP_FREEZE_STREAM_WIDE_ARRAYS if stream else 0)
        words = arrays * 32 * per_lane if wide else 0
        # an unstaged stream cell keeps its estimators, rings and FC rings
        # in its output planes: the scratch holds none of them
        e_nodes = 0 if stream and not staged else n_nodes
        if not staged:
            words += (event_step_freeze_est_words(e_nodes, n_fns, window)
                      + 2 * _round_up(n1, 4))
        if fc_push:
            words += e_nodes * n_fns * fc_ring
        return {"per_lane": per_lane, "wide": wide, "staged": staged,
                "cell_bytes": cell if staged else 0, "scratch_words": words}
    if (per_lane is not None and event_step_cell_bytes(
            False, n1, n_fns, window) <= SMEM_BLOCK_BYTES):
        staged = event_step_cell_bytes(True, n1, n_fns,
                                       window) <= SMEM_BLOCK_BYTES
        return {"per_lane": per_lane, "wide": False, "staged": staged,
                "cell_bytes": event_step_cell_bytes(staged, n1, n_fns,
                                                    window),
                "scratch_words": 0}
    per_lane = max(1, -(-widest // 32))
    arrays = EVENT_STEP_WIDE_ARRAYS + (EVENT_STEP_STREAM_WIDE_ARRAYS
                                       if stream else 0)
    return {"per_lane": per_lane, "wide": True, "staged": False,
            "cell_bytes": 0,
            "scratch_words": arrays * 32 * per_lane + n_fns * window}


def event_step_freeze_est_words(n_nodes: int, n_fns: int,
                                window: int) -> int:
    """32-bit words of one cell's per-(node, function) estimators in the
    frozen-priority kernel (``est_words`` in csrc/event_step.cu): the
    scalar arrays, then the runtime rings."""
    e = n_nodes * n_fns
    return (EVENT_STEP_FREEZE_EST_ARRAYS * _round_up(e, 4)
            + _round_up(e * window, 4))


def event_step_freeze_cell_bytes(n1: int, n_nodes: int, n_fns: int,
                                 window: int) -> int:
    """Shared-memory bytes of one staged cell in the frozen-priority kernel
    (``freeze_cell_bytes`` in csrc/event_step.cu): the estimators, the
    queue (each row's frozen priority key, 32 bits, and node, 16 bits) and
    the rows t / p / cost (float32) and fnid (8-bit)."""
    return (4 * event_step_freeze_est_words(n_nodes, n_fns, window)
            + 4 * _round_up(n1, 4) + 2 * _round_up(n1, 8)
            + 12 * _round_up(n1, 4) + _round_up(n1, 16))


def _event_step_lib(name: str):
    """The launcher ``name`` (of csrc/event_step.cu, or its source in
    ``EVENT_STEP_SOURCES``), built at first use: its tensor and array
    pointers, the FC horizon, the stream."""
    if name not in _event_step_fns:
        from .build import load

        fn = getattr(load(EVENT_STEP_SOURCES.get(name, "event_step")), name)
        fn.argtypes = ([ctypes.c_void_p] * EVENT_STEP_LAUNCHERS[name]
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _event_step_fns[name] = fn
    return _event_step_fns[name]


def _checked(x: torch.Tensor, name: str, dtype: torch.dtype,
             shape: tuple, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``dtype`` on ``device`` with
    ``shape``.  Integer inputs are converted (torch indexes in int64, the
    kernel in int32); anything else that does not match raises."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if dtype == torch.int32 and x.dtype in (torch.int64, torch.int16,
                                            torch.int8, torch.uint8):
        x = x.to(torch.int32)
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    return x.contiguous()


def _bucket_args(clk, ctr, inp, layout, ncoef: int,
                 f32: torch.dtype = torch.float32) -> list:
    """The carry planes and the inputs every kernel reads, checked; floats
    of type ``f32`` (float64 for the float64 pull kernel)."""
    dev = clk.device
    B, n1 = inp["t"].shape
    i32 = torch.int32
    if ncoef < 4:
        raise ValueError(f"coef needs at least 4 columns, got {ncoef}")
    return [
        _checked(clk, "clk", f32, (B, layout.f_len), dev),
        _checked(ctr, "ctr", i32, (B, layout.i_len), dev),
        _checked(inp["t"], "t", f32, (B, n1), dev),
        _checked(inp["fnid"], "fnid", i32, (B, n1), dev),
        _checked(inp["p"], "p", f32, (B, n1), dev),
        _checked(inp["cost"], "cost", f32, (B, n1), dev),
        _checked(inp["coef"], "coef", f32, (B, ncoef), dev),
        _checked(inp["cores"], "cores", i32, (B,), dev),
        _checked(inp["nodes"], "nodes", i32, (B,), dev),
    ]


def _launch_event_step(name: str, args: list, order: tuple, layout, dims,
                       plan_c, plan: dict, horizon: float,
                       planes_out: tuple = ()):
    """Launch ``name`` of csrc/event_step.cu (or its source) on ``args``:
    zero-filled outputs (start, finish, prio float32; node int32), then
    ``planes_out`` (a stream launch's final carry planes), the scratch of
    ``plan["scratch_words"]`` words a cell (the kernel fills it), the
    carry offsets in ``order`` (an entry the layout lacks is 0), the dims
    and the plan; raises on a CUDA error."""
    dev = args[0].device
    B, n1 = args[2].shape            # t
    outs = [torch.zeros(B, n1, dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs.append(torch.zeros(B, n1, dtype=torch.int32, device=dev))
    outs += list(planes_out)
    scratch = (torch.empty(B * plan["scratch_words"], dtype=torch.int32,
                           device=dev)
               if plan["scratch_words"] else None)
    offs = layout.offsets()
    lay = (ctypes.c_int * len(order))(*(offs.get(k, 0) for k in order))
    fn = _event_step_lib(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in args + outs),
                 None if scratch is None else scratch.data_ptr(),
                 ctypes.addressof(lay), ctypes.addressof(dims),
                 ctypes.addressof(plan_c), float(horizon), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return tuple(outs)


def _stream_args(inp, B: int, n1: int, n_fns: int, f: torch.dtype,
                 dev) -> list:
    """A stream bucket's CSR queue lists and horizons, checked."""
    i32 = torch.int32
    return [_checked(inp["fnev"], "fnev", i32, (B, n1), dev),
            _checked(inp["fnst"], "fnst", i32, (B, n_fns), dev),
            _checked(inp["t_stop"], "t_stop", f, (B,), dev)]


def _event_step_cuda(clk, ctr, inp, *, n_nodes, n_slots, window, use_fc,
                     horizon, n_steps, stream=False):
    dev = clk.device
    B, n1 = inp["t"].shape
    n_fns, kq = inp["ring0"].shape[2], inp["fn_ev"].shape[2]
    nc, ncoef = inp["cumf"].shape[1], inp["coef"].shape[1]
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, stream=stream)
    if use_fc and nc != n1:
        raise ValueError(f"use_fc needs cumf rows = {n1}, got {nc}")
    args = _bucket_args(clk, ctr, inp, layout, ncoef)
    if stream:
        kq = 1
        args += _stream_args(inp, B, n1, n_fns, torch.float32, dev)
    else:
        args += [
            _checked(inp["cumf"], "cumf", torch.float32, (B, nc, n_fns),
                     dev),
            _checked(inp["fn_ev"], "fn_ev", torch.int32, (B, n_fns, kq),
                     dev),
        ]
    plan = event_step_plan(n1=n1, n_nodes=n_nodes, n_slots=n_slots,
                           n_fns=n_fns, window=window, stream=stream)
    dims = (ctypes.c_int * 13)(B, n1 - 1, n_nodes, n_slots, window, n_fns,
                               kq, nc, ncoef, layout.f_len, layout.i_len,
                               int(bool(use_fc)), n_steps)
    plan_c = (ctypes.c_int * 4)(plan["per_lane"], int(plan["staged"]),
                                plan["cell_bytes"], plan["scratch_words"])
    if not stream:
        return (*_launch_event_step("event_step_launch", args,
                                    EVENT_STEP_LAYOUT, layout, dims, plan_c,
                                    plan, horizon), {})
    # the final planes start as copies: the kernel writes every entry back
    planes = (args[0].clone(), args[1].clone())
    out = _launch_event_step("event_step_stream_launch", args,
                             EVENT_STEP_LAYOUT, layout, dims, plan_c, plan,
                             horizon, planes)
    return (*out[:4], {"clk": out[4], "ctr": out[5]})


def _event_step_freeze_cuda(clk, ctr, inp, *, n_nodes, n_slots, window,
                            horizon, n_steps, fc_push, fc_ring,
                            stream=False):
    dev = clk.device
    B, n1 = inp["t"].shape
    n_fns, ncoef = inp["ring0"].shape[2], inp["coef"].shape[1]
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, freeze=True, fc_push=fc_push, n1=n1,
                          fc_ring=fc_ring, stream=stream)
    args = _bucket_args(clk, ctr, inp, layout, ncoef) + [
        _checked(inp["cnt"], "cnt", torch.float32, (B, n1), dev),
        _checked(inp["home0"], "home0", torch.int32, (B, n1), dev),
        _checked(inp["route"], "route", torch.int32, (B,), dev),
    ]
    if stream:
        args.append(_checked(inp["t_stop"], "t_stop", torch.float32, (B,),
                             dev))
    plan = event_step_plan(n1=n1, n_nodes=n_nodes, n_slots=n_slots,
                           n_fns=n_fns, window=window, freeze=True,
                           fc_push=fc_push, fc_ring=fc_ring, stream=stream)
    dims = (ctypes.c_int * 12)(B, n1 - 1, n_nodes, n_slots, window, n_fns,
                               ncoef, layout.f_len, layout.i_len,
                               int(bool(fc_push)), fc_ring, n_steps)
    plan_c = (ctypes.c_int * 5)(plan["per_lane"], int(plan["staged"]),
                                int(plan["wide"]), plan["cell_bytes"],
                                plan["scratch_words"])
    if not stream:
        return (*_launch_event_step("event_step_freeze_launch", args,
                                    EVENT_STEP_FREEZE_LAYOUT, layout, dims,
                                    plan_c, plan, horizon), {})
    # the final planes start as copies: the kernel writes every entry back
    planes = (args[0].clone(), args[1].clone())
    out = _launch_event_step("event_step_freeze_stream_launch", args,
                             EVENT_STEP_FREEZE_LAYOUT, layout, dims, plan_c,
                             plan, horizon, planes)
    return (*out[:4], {"clk": out[4], "ctr": out[5]})


def _event_step_dyn_cuda(clk, ctr, inp, *, n_nodes, n_slots, window, use_fc,
                         horizon, n_steps, dyn, het, cold, stream=False):
    dev = clk.device
    B, n1 = inp["t"].shape
    n_fns, kq = inp["ring0"].shape[2], inp["fn_ev"].shape[2]
    ncoef = inp["coef"].shape[1]
    f64, i32 = torch.float64, torch.int32
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, n1=n1, dyn=dyn, cold=cold,
                          stream=stream)
    if dyn and ncoef < 5:
        raise ValueError(f"dyn needs 5 coef columns, got {ncoef}")
    nc = inp["cumf"].shape[1]
    if use_fc and nc != n1:
        raise ValueError(f"use_fc needs cumf rows = {n1}, got {nc}")
    n_ep = inp["epn"].shape[1] if het else 1

    def opt(on, key, dtype, shape):
        return _checked(inp[key], key, dtype, shape, dev) if on else None

    args = _bucket_args(clk, ctr, inp, layout, ncoef, f64)
    if stream:
        kq = 1
        args += _stream_args(inp, B, n1, n_fns, f64, dev)
    else:
        args.append(_checked(inp["fn_ev"], "fn_ev", i32, (B, n_fns, kq),
                             dev))
    args += [
        opt(dyn, "dynp", f64, (B, 5)), opt(dyn, "maxn", i32, (B,)),
        opt(dyn, "nreq", i32, (B,)),
        opt(het, "spd", f64, (B, n_nodes)), opt(het, "epn", i32, (B, n_ep)),
        opt(het, "ept0", f64, (B, n_ep)), opt(het, "ept1", f64, (B, n_ep)),
        opt(het, "epf", f64, (B, n_ep)),
    ]
    plan = event_step_plan(n1=n1, n_nodes=n_nodes, n_slots=n_slots,
                           n_fns=n_fns, window=window, f64=True, dyn=dyn,
                           cold=cold, stream=stream)
    outs = [torch.zeros(B, n1, dtype=f64, device=dev) for _ in range(3)]
    outs.append(torch.zeros(B, n1, dtype=i32, device=dev))
    summ = act = dead = csum = coldq = None
    if dyn:
        summ = torch.zeros(B, 3, dtype=i32, device=dev)
        act = torch.zeros(B, n_nodes, dtype=f64, device=dev)
        dead = torch.zeros(B, n_nodes, dtype=i32, device=dev)
    if cold:
        # cold starts and evictions; each row's flag (the kernel copies the
        # carry's in first)
        csum = torch.zeros(B, 2, dtype=i32, device=dev)
        coldq = torch.empty(B, n1, dtype=i32, device=dev)
    scratch = (torch.empty(B * plan["scratch_words"], dtype=i32, device=dev)
               if plan["scratch_words"] else None)
    offs = layout.offsets()
    lay = (ctypes.c_int * len(EVENT_STEP_DYN_LAYOUT))(
        *(offs.get(k, 0) for k in EVENT_STEP_DYN_LAYOUT))
    dims = (ctypes.c_int * 16)(B, n1 - 1, n_nodes, n_slots, window, n_fns,
                               kq, ncoef, n_ep, layout.f_len, layout.i_len,
                               int(bool(use_fc)), int(dyn), int(het),
                               int(cold), n_steps)
    plan_c = (ctypes.c_int * 5)(plan["per_lane"], int(plan["staged"]),
                                int(plan["wide"]), plan["cell_bytes"],
                                plan["scratch_words"])
    name = ("event_step_dyn_stream_launch" if stream
            else "event_step_dyn_launch")
    # a stream launch's final planes start as copies: the kernel writes
    # every entry back
    planes = [args[0].clone(), args[1].clone()] if stream else []
    fn = _event_step_lib(name)
    ptrs = [None if x is None else x.data_ptr()
            for x in args + outs + [summ, act, dead, csum, coldq] + planes
            + [scratch]]
    with torch.cuda.device(dev):
        cu_stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, ctypes.addressof(lay), ctypes.addressof(dims),
                 ctypes.addressof(plan_c), float(horizon), cu_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    aux = {}
    if dyn:
        aux = {"nfail": summ[:, 0], "ndone": summ[:, 1], "prov": summ[:, 2],
               "act_t": act, "dead": dead.to(torch.bool)}
    if cold:
        aux.update(ncold=csum[:, 0], nevt=csum[:, 1],
                   coldq=coldq.to(torch.bool))
    if stream:
        aux.update(clk=planes[0], ctr=planes[1])
    return (*outs, aux)


def _event_step_freeze64_cuda(clk, ctr, inp, *, n_nodes, n_slots, window,
                              horizon, n_steps, fc_push, fc_ring, dyn, het,
                              cold, hedge=False, dup=False, n_copies=1,
                              res=False, stream=False):
    dev = clk.device
    B, n1 = inp["t"].shape
    n_fns, ncoef = inp["ring0"].shape[2], inp["coef"].shape[1]
    f64, i32 = torch.float64, torch.int32
    layout = carry_layout(n_nodes=n_nodes, n_slots=n_slots, window=window,
                          n_fns=n_fns, freeze=True, fc_push=fc_push, n1=n1,
                          fc_ring=fc_ring, dyn=dyn, het=het, cold=cold,
                          hedge=hedge, dup=dup, n_copies=n_copies, res=res,
                          stream=stream)
    n_ep = inp["epn"].shape[1] if het else 1

    def opt(on, key, dtype, shape):
        return _checked(inp[key], key, dtype, shape, dev) if on else None

    args = _bucket_args(clk, ctr, inp, layout, ncoef, f64) + [
        _checked(inp["cnt"], "cnt", f64, (B, n1), dev),
        _checked(inp["home0"], "home0", i32, (B, n1), dev),
        _checked(inp["route"], "route", i32, (B,), dev),
        opt(dyn, "dynp", f64, (B, 5)), opt(dyn, "maxn", i32, (B,)),
        opt(dyn, "nreq", i32, (B,)),
        opt(het, "spd", f64, (B, n_nodes)), opt(het, "epn", i32, (B, n_ep)),
        opt(het, "ept0", f64, (B, n_ep)), opt(het, "ept1", f64, (B, n_ep)),
        opt(het, "epf", f64, (B, n_ep)),
    ]
    # the hedged and the resilience launchers share one signature, each
    # family's inputs and outputs null in the other's; the stream launcher
    # takes both families' and the horizon, the ranks (res) and the planes
    family = hedge or res or stream
    if family:
        args += [opt(hedge, "hmult", f64, (B,)),
                 opt(hedge, "hfloor", f64, (B,)),
                 opt(hedge, "hmax", i32, (B,)),
                 opt(res, "rto_p", f64, (B, 4)),
                 opt(res, "rrt_p", f64, (B, 6)),
                 opt(res, "adm_p", f64, (B, 2))]
    if stream:
        args += [opt(True, "t_stop", f64, (B,)),
                 opt(res, "gseq", i32, (B, n1))]
    plan = event_step_plan(n1=n1, n_nodes=n_nodes, n_slots=n_slots,
                           n_fns=n_fns, window=window, freeze=True, f64=True,
                           fc_push=fc_push, fc_ring=fc_ring, dyn=dyn,
                           cold=cold, hedge=hedge, dup=dup,
                           n_copies=n_copies, res=res, stream=stream)
    outs = [torch.zeros(B, n1, dtype=f64, device=dev) for _ in range(3)]
    outs.append(torch.zeros(B, n1, dtype=i32, device=dev))
    summ = act = dead = csum = coldq = None
    if dyn:
        summ = torch.zeros(B, 3, dtype=i32, device=dev)
        act = torch.zeros(B, n_nodes, dtype=f64, device=dev)
        dead = torch.zeros(B, n_nodes, dtype=i32, device=dev)
    if cold:
        # cold starts and evictions; each row's flag (the kernel copies the
        # carry's in first)
        csum = torch.zeros(B, 2, dtype=i32, device=dev)
        coldq = torch.empty(B, n1, dtype=i32, device=dev)
    hout, rout = [None, None], [None] * 5
    if hedge:
        # backups, calls stolen or won by a copy, calls done, steps taken;
        # each row's attempts
        hout = [torch.zeros(B, 4, dtype=i32, device=dev),
                torch.zeros(B, n1, dtype=i32, device=dev)]
    if res:
        # timeouts, sheds, retries, calls resolved, steps taken; the wasted
        # seconds; each row's failure flag, cause and submissions
        rout = [torch.zeros(B, 5, dtype=i32, device=dev),
                torch.zeros(B, dtype=f64, device=dev),
                *(torch.zeros(B, n1, dtype=i32, device=dev)
                  for _ in range(3))]
    scratch = (torch.empty(B * plan["scratch_words"], dtype=i32, device=dev)
               if plan["scratch_words"] else None)
    offs = layout.offsets()
    lay = (ctypes.c_int * len(EVENT_STEP_FREEZE64_LAYOUT))(
        *(offs.get(k, 0) for k in EVENT_STEP_FREEZE64_LAYOUT))
    dims = (ctypes.c_int * 20)(B, n1 - 1, n_nodes, n_slots, window, n_fns,
                               ncoef, n_ep, layout.f_len, layout.i_len,
                               int(bool(fc_push)), fc_ring, int(dyn),
                               int(het), int(cold), n_steps, int(hedge),
                               int(dup), n_copies, int(res))
    plan_c = (ctypes.c_int * 5)(plan["per_lane"], int(plan["staged"]),
                                int(plan["wide"]), plan["cell_bytes"],
                                plan["scratch_words"])
    name = ("event_step_freeze64_stream_launch" if stream
            else "event_step_res_launch" if res else "event_step_dup_launch"
            if dup else "event_step_hedge_launch" if hedge
            else "event_step_freeze64_launch")
    # a stream launch's final planes start as copies: the kernel writes
    # every entry back
    planes = [args[0].clone(), args[1].clone()] if stream else []
    fn = _event_step_lib(name)
    ptrs = [None if x is None else x.data_ptr()
            for x in args + outs + [summ, act, dead, csum, coldq]
            + (hout + rout if family else []) + planes + [scratch]]
    with torch.cuda.device(dev):
        cu_stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, ctypes.addressof(lay), ctypes.addressof(dims),
                 ctypes.addressof(plan_c), float(horizon), cu_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    aux = {}
    if dyn:
        aux = {"nfail": summ[:, 0], "ndone": summ[:, 1], "prov": summ[:, 2],
               "act_t": act, "dead": dead.to(torch.bool)}
    if cold:
        aux.update(ncold=csum[:, 0], nevt=csum[:, 1],
                   coldq=coldq.to(torch.bool))
    if hedge:
        hsum, att = hout
        aux.update(nbk=hsum[:, 0], nstl=hsum[:, 1], att=att,
                   ndone=hsum[:, 2], stepc=hsum[:, 3])
    if res:
        rsum, wst, nfl, fcz, ratt = rout
        aux.update(nto=rsum[:, 0], nsh=rsum[:, 1], nrt=rsum[:, 2],
                   wst=wst, nfl=nfl.to(torch.bool), fcz=fcz, ratt=ratt,
                   ndn=rsum[:, 3], stepc=rsum[:, 4])
    if stream:
        aux.update(clk=planes[0], ctr=planes[1])
    return (*outs, aux)


def event_step(clk, ctr, inp, *, force: str | None = None, n_nodes: int,
               n_slots: int, window: int, use_fc: bool, horizon: float,
               n_steps: int, fc_ring: int = 1, **flags):
    """Batched cluster event scan -- the simulator's hot path.

    ``clk``/``ctr`` are the ``(B, f_len)`` / ``(B, i_len)`` carry planes
    (``repro_torch.core.planes.make_planes``) and ``inp`` the bucket's input
    tensors; ``flags`` are the JAX package's feature flags (``freeze``,
    ``fc_push``, ``dyn``, ...), which must describe the pull regime or the
    frozen-priority regime (``freeze``, with the push FC rings of
    ``fc_ring`` entries when ``fc_push``), each with capacity dynamics
    ``dyn``, node speeds ``het`` and the cold-start containers ``cold`` or
    without, or the call raises ``NotImplementedError``.  Each goes to its
    own kernel: static frozen-priority buckets to the freeze kernel
    (``event_step_plan(..., freeze=True)``), whose ``prio`` and ``node``
    are each call's values fixed at its arrival; ``dyn`` / ``het`` /
    ``cold`` buckets (float64) to the float64 pull kernel
    (``event_step_plan(..., f64=True)``) or, with ``freeze``, the float64
    frozen-priority kernel (``event_step_plan(..., freeze=True,
    f64=True)``); ``hedge`` buckets (frozen-priority only; ``dup`` without
    ``dyn``, its ``n_copies`` queue entries a call) to that kernel's hedged
    instantiations (csrc/event_step_hedge.cu, csrc/event_step_dup.cu),
    counted apart as ``event_step_hedge``; ``res`` buckets (frozen-priority
    alone) to its resilience instantiations (csrc/event_step_res.cu),
    counted apart as ``event_step_res``.  Returns ``(start, finish,
    prio, node, aux)``: rows ``[:n]`` are the per-request records (a call
    dispatched twice keeps its last dispatch; under ``dup`` the winning
    copy's) and row ``n`` is the no-op sentinel (the kernels leave it 0);
    ``aux`` is ``{}``, or with ``dyn`` each cell's ``nfail``, ``ndone``,
    ``prov`` (B,), ``act_t`` and ``dead`` (B, nodes) at the end, with
    ``cold`` its ``ncold``, ``nevt`` (B,) and ``coldq`` (B, n+1), and with
    ``hedge`` its ``nbk``, ``nstl``, ``ndone``, ``stepc`` (B,) and ``att``
    (B, n+1), and with ``res`` its ``nto``, ``nsh``, ``nrt``, ``ndn``,
    ``stepc`` (B,), ``wst`` (B,; float64) and ``nfl``, ``fcz``, ``ratt``
    (B, n+1) (``event_step.event_step_ref``).
    ``stream`` (not beside ``dup``) scans one chunk of the chunked stream
    replay (``repro_torch.core.streamscan``): a pull bucket through the
    pull kernels' stream instantiations (csrc/event_step_stream.cu),
    counted apart as ``event_step_stream``, with ``fnev`` / ``fnst`` in
    place of ``fn_ev``; a frozen-priority bucket through the two
    frozen-priority kernels' (csrc/event_step_freeze_stream.cu), counted
    apart as ``event_step_freeze_stream``, with each row's global rank
    ``gseq`` under ``res``.  ``inp`` adds each cell's horizon ``t_stop``,
    and ``aux`` the final carry planes ``clk`` / ``ctr``.
    The kernel keeps the FC counts itself from ``t`` and ``fnid`` and does
    not read ``cumf``, which must equal ``event_step.fc_prefix_counts`` of
    them (their prefix count over the real rows), as the bucket runner
    fills it.  Whether it stages a
    cell's rows in shared memory depends on the shape alone
    (``event_step_plan``).

    ``force``: ``None`` runs the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors; ``"ref"`` runs the plain version on any
    device."""
    global KERNEL_LAUNCHES, REF_LAUNCHES, FREEZE_LAUNCHES, FREEZE_REF_LAUNCHES
    global DYN_LAUNCHES, DYN_REF_LAUNCHES, FREEZE64_LAUNCHES
    global FREEZE64_REF_LAUNCHES, HEDGE_LAUNCHES, HEDGE_REF_LAUNCHES
    global RES_LAUNCHES, RES_REF_LAUNCHES, STREAM_LAUNCHES
    global STREAM_REF_LAUNCHES, FREEZE_STREAM_LAUNCHES
    global FREEZE_STREAM_REF_LAUNCHES
    _check_force(force)
    if not event_step_supported(use_fc=use_fc, **flags):
        raise NotImplementedError(
            "event_step covers the pull and the frozen-priority regimes, "
            "with or without dyn / het / cold, and hedge / dup (dup "
            "without dyn) or res (alone) under the frozen-priority regime, "
            "and stream under both but beside dup; no pull FC counts under "
            "freeze, no push FC rings under pull")
    freeze, fc_push = bool(flags.get("freeze")), bool(flags.get("fc_push"))
    dyn, het = bool(flags.get("dyn")), bool(flags.get("het"))
    cold, hedge = bool(flags.get("cold")), bool(flags.get("hedge"))
    dup, n_copies = bool(flags.get("dup")), int(flags.get("n_copies", 1))
    res, stream = bool(flags.get("res")), bool(flags.get("stream"))
    f64 = dyn or het or cold or hedge or res
    static = dict(n_nodes=n_nodes, n_slots=n_slots, window=window,
                  horizon=horizon, n_steps=n_steps)
    if force == "ref" or clk.device.type != "cuda":
        out = event_step_ref(clk, ctr, inp, use_fc=use_fc, freeze=freeze,
                             fc_push=fc_push, fc_ring=fc_ring, dyn=dyn,
                             het=het, cold=cold, hedge=hedge, dup=dup,
                             n_copies=n_copies, res=res, stream=stream,
                             **static)
        if stream and freeze:
            FREEZE_STREAM_REF_LAUNCHES += 1
        elif stream:
            STREAM_REF_LAUNCHES += 1
        elif res:
            RES_REF_LAUNCHES += 1
        elif hedge:
            HEDGE_REF_LAUNCHES += 1
        elif freeze and f64:
            FREEZE64_REF_LAUNCHES += 1
        elif freeze:
            FREEZE_REF_LAUNCHES += 1
        elif f64:
            DYN_REF_LAUNCHES += 1
        else:
            REF_LAUNCHES += 1
        return out
    if freeze and f64:
        out = _event_step_freeze64_cuda(clk, ctr, inp, fc_push=fc_push,
                                        fc_ring=fc_ring, dyn=dyn, het=het,
                                        cold=cold, hedge=hedge, dup=dup,
                                        n_copies=n_copies, res=res,
                                        stream=stream, **static)
        if stream:
            FREEZE_STREAM_LAUNCHES += 1
        elif res:
            RES_LAUNCHES += 1
        elif hedge:
            HEDGE_LAUNCHES += 1
        else:
            FREEZE64_LAUNCHES += 1
        return out
    if freeze:
        out = _event_step_freeze_cuda(clk, ctr, inp, fc_push=fc_push,
                                      fc_ring=fc_ring, stream=stream,
                                      **static)
        if stream:
            FREEZE_STREAM_LAUNCHES += 1
        else:
            FREEZE_LAUNCHES += 1
        return out
    if f64:
        out = _event_step_dyn_cuda(clk, ctr, inp, use_fc=use_fc, dyn=dyn,
                                   het=het, cold=cold, stream=stream,
                                   **static)
    else:
        out = _event_step_cuda(clk, ctr, inp, use_fc=use_fc, stream=stream,
                               **static)
    if stream:
        STREAM_LAUNCHES += 1
    elif f64:
        DYN_LAUNCHES += 1
    else:
        KERNEL_LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=-1, softmax_scale=None,
                    force: str | None = None):
    """Attention of q (B, Sq, Hq, dh) over k / v (B, Sk, Hkv, dh), positions
    suffix-aligned -- the model's prefill path (see ``flash_attention``'s
    module).  ``force``: ``None`` runs the CUDA kernel on CUDA tensors and
    the plain version on CPU tensors; ``"ref"`` the plain version on any
    device."""
    global FLASH_LAUNCHES, FLASH_REF_LAUNCHES
    _check_force(force)
    kw = dict(causal=causal, window=window, softmax_scale=softmax_scale)
    if force == "ref" or q.device.type != "cuda":
        FLASH_REF_LAUNCHES += 1
        return flash_attention_ref(q, k, v, **kw)
    out = flash_attention_cuda(q, k, v, **kw)
    FLASH_LAUNCHES += 1
    return out


def decode_attention(q, k, v, lengths, *, softmax_scale=None,
                     force: str | None = None):
    """One new token q (B, Hq, dh) over the first ``lengths[b]`` entries of
    the cache k / v (B, Sk, Hkv, dh) -- the model's decode path.  ``force``
    as for ``flash_attention``."""
    global DECODE_LAUNCHES, DECODE_REF_LAUNCHES
    _check_force(force)
    if force == "ref" or q.device.type != "cuda":
        DECODE_REF_LAUNCHES += 1
        return decode_attention_ref(q, k, v, lengths,
                                    softmax_scale=softmax_scale)
    out = decode_attention_cuda(q, k, v, lengths,
                                softmax_scale=softmax_scale)
    DECODE_LAUNCHES += 1
    return out


def rglru_scan(a, gx, h0, *, force: str | None = None):
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + gx_t`` over a, gx
    (B, S, W) from h0 (B, W), the float32 carry -> (hs (B, S, W), hT (B,
    W)) in a's dtype -- the RG-LRU block's path (see ``rglru_scan``'s
    module).  ``force`` as for ``flash_attention``."""
    global RGLRU_LAUNCHES, RGLRU_REF_LAUNCHES
    _check_force(force)
    if force == "ref" or a.device.type != "cuda":
        RGLRU_REF_LAUNCHES += 1
        return rglru_scan_ref(a, gx, h0)
    out = rglru_scan_cuda(a, gx, h0)
    RGLRU_LAUNCHES += 1
    return out


def rwkv6_scan(r, k, v, w, u, s0=None, *, force: str | None = None):
    """The RWKV-6 time-mix recurrence over r, k, v, w (B, S, H, dh) with
    bonus u (H, dh) from the float32 state s0 (B, H, dh, dh; zeros when
    None) -> (out (B, S, H, dh) in r's dtype, sT) -- the time mix's path
    (see ``rwkv6_scan``'s module).  ``force`` as for
    ``flash_attention``."""
    global RWKV6_LAUNCHES, RWKV6_REF_LAUNCHES
    _check_force(force)
    if force == "ref" or r.device.type != "cuda":
        RWKV6_REF_LAUNCHES += 1
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    out = rwkv6_scan_cuda(r, k, v, w, u, s0)
    RWKV6_LAUNCHES += 1
    return out
