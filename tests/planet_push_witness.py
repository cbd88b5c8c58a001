"""The planet fleet under push, replayed by the JAX package's reference
event loop (``repro.core.cluster.simulate_cluster(backend="reference")``,
plain Python on the CPU, no scan): an independent witness of the response
times and the backlog that the port's chunked stream replay reports for
the same prefixes (``chip_smoke.py`` phase 3i's ladder, on the card).

The fleet and stream are ``chip_smoke.py``'s ``planet_push_fleet()`` and
``planet_model()``: 96 single-core nodes autoscaling to 128, SEPT, push
with the least-loaded balancer, warm, 4 MB containers; the Azure-fitted
day over 10,000 functions, seed 7.  For each prefix it prints one JSON
line: the reference loop's seconds, R_avg, R_p95, R_p99 (response times
as the port counts them: completion, response overhead included, less the
call's submission), the nodes used, and the most calls in flight (arrived,
not completed) at any arrival.

    PYTHONPATH=src python tests/planet_push_witness.py 4096 16384 32768

It imports the JAX package, so it is a test-side script (pytest does not
collect it); the reference loop itself runs no JAX.  The 256-function cut
of the same fleet is held call for call against the port in
``tests/test_torch_freeze_stream_scan.py``.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro.core import synth
from repro.core.cluster import simulate_cluster
from repro.core.request import Request

ROOT = Path(__file__).resolve().parent.parent
FLEET = dict(nodes=96, cores_per_node=1, policy="sept", assignment="push",
             lb="least_loaded", warm=True, container_mb=4,
             autoscale=True, autoscale_interval_s=15.0,
             scale_up_queue_per_slot=0.5, provision_delay_s=60.0,
             max_nodes=128)


def planet_requests(k: int, n_fns: int = 10_000) -> list[Request]:
    model = synth.expand_catalog(
        synth.fit_azure_csv(ROOT / "data" / "azure_trace_slice.csv"),
        n_fns, rate_scale=40.0, tail_alpha=0.7)
    reqs = []
    for ch in model.stream(7, max_invocations=k).iter_chunks():
        reqs.extend(Request(fn=model.fns[fi], r=float(t), p_true=float(p))
                    for t, fi, p in zip(ch.r, ch.fn, ch.p))
    return reqs


def witness(k: int, n_fns: int = 10_000) -> dict:
    reqs = planet_requests(k, n_fns)
    t0 = time.perf_counter()
    res = simulate_cluster(reqs, backend="reference", **FLEET)
    wall = time.perf_counter() - t0
    done = [q for q in res.requests if q.c is not None]
    resp = np.array([q.response_time for q in done])
    arr = np.sort(np.array([q.r for q in res.requests]))
    fin = np.sort(np.array([q.c for q in done]))
    # calls in flight just after each arrival: arrived so far, less done
    in_flight = (np.arange(1, len(arr) + 1)
                 - np.searchsorted(fin, arr, side="right"))
    return {"invocations": k, "served": len(done), "reference_s": wall,
            "R_avg": float(resp.mean()),
            "R_p95": float(np.percentile(resp, 95)),
            "R_p99": float(np.percentile(resp, 99)),
            "nodes_used": res.nodes_used,
            "max_in_flight": int(in_flight.max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("prefixes", type=int, nargs="+",
                    help="invocations of the planet day to replay")
    ap.add_argument("--fns", type=int, default=10_000,
                    help="the catalog's functions (the planet's 10,000)")
    args = ap.parse_args()
    for k in args.prefixes:
        print(json.dumps(witness(k, args.fns)), flush=True)


if __name__ == "__main__":
    main()
