"""Request sets for the float64 pull kernel's wide path (more than 32
functions a cell), shared by the CPU tests (held to the JAX package) and
the card tests (kernel held to the plain version).  Imports no JAX: the
request class is the caller's.

* ``many_fn_requests``: a burst over ``n_fns`` functions, every one called
  at least once and the rest drawn with a Zipf-like skew, so that some
  queues hold several calls while most hold one or none.
* ``merged_bases_requests``: an EECT burst in which two functions' bases
  (their estimates) differ by one unit in the last place, 1 and 1 +
  2^-52, while base + now rounds to one priority at the dispatch that
  picks between them; the larger base holds the smaller head row, so the
  oracle's first-index tie-break takes it.  A dispatch that compared the
  bases alone would take the other.  ``same_group`` puts the two
  functions 16 entries apart (one group of 32 functions on the wide path
  when the bucket pads 300 functions to 512), else next to each other.
"""

import numpy as np

TIE_FNS = 300           # functions of the merged-bases burst (padded: 512)
TIE_NODES, TIE_CORES = 2, 1


def fn_name(k: int) -> str:
    return f"fn{k:05d}"


def many_fn_requests(req, n: int, n_fns: int, seed: int, span: float,
                     p_lo: float = 0.05, p_hi: float = 0.9) -> list:
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_fns + 1) ** 0.8
    extra = rng.choice(n_fns, size=max(n - n_fns, 0), p=w / w.sum())
    fns = rng.permutation(np.concatenate([np.arange(n_fns), extra]))
    r = np.sort(rng.uniform(0.0, span, len(fns)))
    return [req(fn=fn_name(int(f)), r=float(t),
                p_true=float(rng.uniform(p_lo, p_hi)))
            for f, t in zip(fns, r)]


def merged_bases_requests(req, same_group: bool) -> list:
    """Functions 3 (B) and 19 or 4 (A) of ``TIE_FNS``: B's first call runs
    1 + 2^-52 s and A's 1 s, so their estimates differ in the last place;
    two long calls of functions 0 and 1 then hold both slots while B's and
    A's second calls queue, B's first; when the first long call ends (now
    ~ 15 s) est + now rounds equal for both.  The other functions arrive
    later, one call each."""
    b, a = 3, (19 if same_group else 4)
    out = [req(fn=fn_name(b), r=0.0, p_true=1.0 + 2.0 ** -52),
           req(fn=fn_name(a), r=0.0, p_true=1.0),
           req(fn=fn_name(0), r=2.0, p_true=10.0),
           req(fn=fn_name(1), r=2.0, p_true=10.5),
           req(fn=fn_name(b), r=3.0, p_true=0.5),
           req(fn=fn_name(a), r=4.0, p_true=0.5)]
    rest = [k for k in range(TIE_FNS) if k not in (0, 1, a, b)]
    out += [req(fn=fn_name(k), r=30.0 + 0.1 * i, p_true=0.2)
            for i, k in enumerate(rest)]
    return out
