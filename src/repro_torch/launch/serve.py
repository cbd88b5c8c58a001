"""Serving launcher:

    python -m repro_torch.launch.serve --arch qwen3_1_7b --policy fc
        [--device cpu] [--full-width]

Port of ``repro.launch.serve``.  Stands up a single serving node with the
paper's scheduler over two endpoints of the chosen architecture family
("chat": prompt 2, gen 4; "batch": prompt 4, gen 24), warms the runtime
estimator with 3 + 3 calls, fires a burst and reports response-time
statistics.  ``--arch`` takes every decoder-only family of the port's
registry (``configs.ARCHS``: dense, gemma3_27b's windowed layers, the MoE
qwen2_moe_a2_7b and llama4_scout_17b_a16e, the M-RoPE qwen2_vl_7b, the
recurrent recurrentgemma_9b and rwkv6_3b).  Models are scaled down as in
the JAX launcher unless ``--full-width`` is given (the published
configuration; a card's work).  The two endpoints are one model behind two
generation profiles and share one copy of its weights (seed 0), where the
JAX launcher gives each its own: so a full-width model needs its weights
on the card once (gemma3_27b's 54 GB fit an 80 GB card;
llama4_scout_17b_a16e's 218 GB fit no one card, and ``chip_smoke.py``
serves it cut in depth through ``make_endpoints(..., layers=)``).  Runs on
CUDA unless ``--device cpu``; on CUDA every decode step is a replay of its
lane's CUDA graph (``serving.engine``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from ..configs import get_config
from ..models import init, scale_down
from ..serving import Endpoint, ServingEngine


# the launcher's generation profiles: (name, prompt_len, gen_len)
PROFILES = (("chat", 2, 4), ("batch", 4, 24))


def make_endpoints(arch: str, full_width: bool = False, device=None,
                   layers: int | None = None) -> list[Endpoint]:
    """The launcher's two endpoints, one a profile of ``PROFILES``,
    sharing one copy of the weights from seed 0 on ``device`` (CUDA by
    default).  ``layers`` cuts the depth."""
    base = get_config(arch)
    if not full_width:
        base = scale_down(base)
    if layers is not None:
        base = dataclasses.replace(base, n_layers=layers)
    params = init(base, 0, device)
    return [Endpoint(f"{arch}-{name}", dataclasses.replace(base),
                     prompt_len=p, gen_len=g, params=params)
            for name, p, g in PROFILES]


def run_burst(eng: ServingEngine, short: str, long_: str, requests: int,
              heavy_fraction: float) -> dict:
    """Estimator warm-up (3 + 3 calls, paper §V-A), then a burst of
    ``requests`` calls, the first ``heavy_fraction`` of them to ``long_``.
    Returns the burst's summary with its wall seconds and decode steps."""
    for _ in range(3):
        eng.submit(short)
        eng.submit(long_)
    eng.run(max_wall_s=120)
    eng.completed.clear()

    n_heavy = int(requests * heavy_fraction)
    steps0 = eng.decode_steps
    t0 = time.monotonic()
    for i in range(requests):
        eng.submit(long_ if i < n_heavy else short)
    eng.run(max_wall_s=300)
    wall = time.monotonic() - t0
    return eng.summary() | {"wall_s": wall,
                            "decode_steps": eng.decode_steps - steps0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="fc",
                    choices=["fifo", "sept", "eect", "rect", "fc"])
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--heavy-fraction", type=float, default=0.3,
                    help="fraction of calls hitting the long-generation "
                         "endpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published configuration, not the "
                         "scaled-down one")
    args = ap.parse_args(argv)

    short, long_ = make_endpoints(args.arch, args.full_width,
                                   args.device)
    eng = ServingEngine([short, long_], slots=args.slots, policy=args.policy,
                        device=args.device)
    s = run_burst(eng, short.name, long_.name, args.requests,
                  args.heavy_fraction)
    print(f"[serve] arch={args.arch} policy={args.policy} "
          f"slots={args.slots} device={eng.device}")
    print(f"[serve] n={s['n']} R_avg={s['R_avg']*1e3:.1f}ms "
          f"R_p50={s['R_p50']*1e3:.1f}ms R_p95={s['R_p95']*1e3:.1f}ms "
          f"cold_starts={s['cold_starts']} decode_steps={s['decode_steps']}")


if __name__ == "__main__":
    main()
