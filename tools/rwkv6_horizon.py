"""How long a prompt rwkv6_3b's bf16 logits can be held to BF16_LOGIT_RTOL.

    python3 tools/rwkv6_horizon.py [--lengths 1,16,...] [--layers 32,16,...]
                                   [--decode 16]

rwkv6_3b at full width in bfloat16, with the serving engine's random
weights (the chat endpoint's, ``ServingEngine(seed=0)``), cut to each
depth of ``--layers`` (its first layers; 32 is the whole model): for each
prompt length S, an S-token prefill and ``--decode`` greedy decode steps
through the kernels, through the plain versions, and through the plain
versions in float32 on the same weights (widened, exactly), all fed the
kernel run's tokens, by ``chip_smoke.prompt_run`` as
``chip_smoke.long_prompt`` runs them.  Prints one
JSON line per (depth, S) with the largest |logit difference| of each pair
over the largest |logit| of the plain bf16 run, at the prefill's logits
and over the decode steps, and last, for each depth, the longest S up to
which the plain bf16 run lies within BF16_LOGIT_RTOL of the float32 run at
every length (``horizon``; null if none): beyond it random-weight
rwkv6_3b is chaotic in bf16, and a gate of the kernels against the plain
versions means nothing.  The first line is the card's name and power
limit.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import BF16_LOGIT_RTOL, cut_depth  # noqa: E402
from chip_smoke import prompt_run, widen  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init  # noqa: E402

LENGTHS = (1, 16, 64, 256, 1024, 4096)
LAYERS = (32, 16, 8, 4, 2, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", default=",".join(map(str, LENGTHS)))
    ap.add_argument("--layers", default=",".join(map(str, LAYERS)))
    ap.add_argument("--decode", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rwkv6_horizon: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config("rwkv6_3b")
    seed = int(np.random.default_rng(0).integers(2**62))
    full_params = init(full, seed, dev)
    n = args.decode
    horizons = {}
    for depth in (int(x) for x in args.layers.split(",")):
        params, cfg = cut_depth(full_params, full, depth)
        params32 = widen(params)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        held = True
        horizons[depth] = None
        for S in (int(x) for x in args.lengths.split(",")):
            tokens = torch.randint(
                0, cfg.vocab, (1, S),
                generator=torch.Generator().manual_seed(3))
            feed = []

            def run(p, c, force):
                return prompt_run(p, c, dev, tokens, n, feed, force)[0]

            runs = {"kernel": run(params, cfg, None),
                    "plain": run(params, cfg, "ref"),
                    "f32": run(params32, cfg32, "ref")}
            scale = float(runs["plain"].abs().max())
            out = {"layers": depth, "S": S, "decode_steps": n,
                   "max_abs_logit": scale, "rtol": BF16_LOGIT_RTOL}
            for a, b in (("plain", "f32"), ("kernel", "plain"),
                         ("kernel", "f32")):
                d = (runs[a] - runs[b]).abs()
                out[f"{a}_vs_{b}"] = {
                    "all": float(d.max()) / scale,
                    "prefill": float(d[0].max()) / scale,
                    "decode": float(d[1:].max()) / scale if n else 0.0}
            print(json.dumps(out), flush=True)
            held = held and out["plain_vs_f32"]["all"] <= BF16_LOGIT_RTOL
            if held:
                horizons[depth] = S
            del runs
            torch.cuda.empty_cache()
        del params32
    print(json.dumps({"horizon": horizons, "rtol": BF16_LOGIT_RTOL}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
