"""The port's plain recurrences and widened attention against the JAX
package, on the CPU.

``repro_torch.kernels.ops.rglru_scan`` / ``rwkv6_scan`` on CPU tensors run
the plain PyTorch versions that the CUDA kernels are held to on the card.
Here they are held to the Pallas kernels run in interpret mode, at the
shapes of ``tests/test_kernels.py``, and to the jnp oracles
(``ref.rglru_ref``, ``ref.rwkv6_ref``); inputs come from numpy with a seed.

Tolerances:
- against the Pallas kernels, those ``tests/test_kernels.py`` holds the
  kernels to the oracles with: RG-LRU 2e-3 (float32) / 2e-2 (bfloat16),
  RWKV-6 5e-3.  In float32 the RG-LRU versions take the same steps (1e-6
  would do); the RWKV-6 sum over the head runs in another order.
- against the oracles in float32: 1e-5 (the same float32 function, sums in
  another order).  In bfloat16 the oracle ``rglru_ref`` carries h in
  bfloat16 and ``rwkv6_ref`` rounds k v^T to bfloat16, where the Pallas
  kernels and the port carry and multiply in float32; the port follows the
  Pallas kernels, so bfloat16 is held to them.
- the oracle ``rwkv6_ref`` is the only JAX function that takes a state s0
  and returns sT, so a nonzero s0 and sT are held to it (float32, 1e-5).
- ``TestChunkedAlgebra``: a plain mirror of the CUDA kernel's chunked
  passes (``_chunked_rwkv6``) against ``rwkv6_scan_ref`` in float64 within
  1e-10 (the same function summed in another order: float64 rounding), and
  against ``rwkv6_scan_ref`` and ``ref.rwkv6_ref`` in float32 within 1e-5,
  ``chip_smoke.py``'s float32 ``RWKV6_TOL``.  ``ref.rwkv6_ref`` casts to
  float32 inside, so it is not a float64 yardstick.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_ref
from repro_torch.models import layers as TL
from torch_threads import one_torch_thread  # noqa: E402,F401

ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
RWKV6_TOL = dict(rtol=5e-3, atol=5e-3)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(a, dtype="float32"):
    """A numpy float array as a jnp and a torch array of ``dtype``, the
    same values (rounded to ``dtype`` once, by JAX)."""
    j = jnp.asarray(np.asarray(a, np.float32), jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch,
                                                                   dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rglru_inputs(seed, B, S, W, dtype):
    rng = np.random.default_rng(seed)
    return (_pair(rng.uniform(0.8, 0.999, (B, S, W)), dtype),
            _pair(0.1 * rng.standard_normal((B, S, W)), dtype),
            _pair(0.1 * rng.standard_normal((B, W)), dtype))


def _rwkv6_inputs(seed, B, S, H, dh, dtype="float32"):
    rng = np.random.default_rng(seed)
    r = _pair(rng.standard_normal((B, S, H, dh)), dtype)
    k = _pair(0.2 * rng.standard_normal((B, S, H, dh)), dtype)
    v = _pair(0.2 * rng.standard_normal((B, S, H, dh)), dtype)
    w = _pair(rng.uniform(0.9, 0.999, (B, S, H, dh)))
    u = _pair(0.1 * rng.standard_normal((H, dh)))
    return r, k, v, w, u


class TestRGLRU:
    @pytest.mark.parametrize("B,S,W", [(1, 256, 512), (2, 512, 1024),
                                       (1, 128, 2048)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, B, S, W, dtype):
        (ja, ta), (jg, tg), (jh, th) = _rglru_inputs(S + W, B, S, W, dtype)
        hs, hT = ops.rglru_scan(ta, tg, th)
        assert hs.dtype == ta.dtype and hs.shape == (B, S, W)
        assert hT.dtype == ta.dtype and hT.shape == (B, W)
        phs, phT = pallas_rglru(ja, jg, jh, interpret=True)
        np.testing.assert_allclose(_np(hs), _np(phs), **_tol(dtype))
        np.testing.assert_allclose(_np(hT), _np(phT), **_tol(dtype))
        if dtype == "float32":
            ehs, ehT = ref.rglru_ref(ja, jg, jh)
            np.testing.assert_allclose(_np(hs), _np(ehs), **ORACLE_TOL)
            np.testing.assert_allclose(_np(hT), _np(ehT), **ORACLE_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_one_step(self, dtype):
        """S = 1, a decode step: h1 = a h0 + gx, and hT is that step."""
        (ja, ta), (jg, tg), (jh, th) = _rglru_inputs(1, 3, 1, 700, dtype)
        hs, hT = ops.rglru_scan(ta, tg, th)
        want = (ta.float()[:, 0] * th.float() + tg.float()[:, 0]).to(
            ta.dtype)
        assert torch.equal(hs[:, 0], want) and torch.equal(hT, want)
        phs, _ = pallas_rglru(ja, jg, jh, block_w=700, interpret=True)
        np.testing.assert_allclose(_np(hs), _np(phs), **_tol(dtype))

    def test_carry_is_float32(self):
        """In bf16 the carry is not rounded between steps: hs[t] is h_t in
        float32 rounded once, as the Pallas kernel writes it."""
        (_, ta), (_, tg), (_, th) = _rglru_inputs(2, 1, 64, 32, "bfloat16")
        hs, _ = ops.rglru_scan(ta, tg, th)
        f32, _ = ops.rglru_scan(ta.float(), tg.float(), th.float())
        assert torch.equal(hs, f32.to(torch.bfloat16))

    def test_split_run_continues_the_state(self):
        """A prefill then decode steps carry hT as h0: the same as one run
        (float32)."""
        (_, ta), (_, tg), (_, th) = _rglru_inputs(3, 2, 40, 96, "float32")
        whole, hT = ops.rglru_scan(ta, tg, th)
        part, h = ops.rglru_scan(ta[:, :33].contiguous(),
                                 tg[:, :33].contiguous(), th)
        steps = [part]
        for t in range(33, 40):
            hs, h = ops.rglru_scan(ta[:, t:t + 1].contiguous(),
                                   tg[:, t:t + 1].contiguous(), h)
            steps.append(hs)
        assert torch.equal(torch.cat(steps, 1), whole) and torch.equal(h, hT)


class TestRWKV6:
    @pytest.mark.parametrize("B,S,H,dh", [(1, 128, 2, 64), (2, 256, 4, 32)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, B, S, H, dh, dtype):
        (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv6_inputs(
            S + H, B, S, H, dh, dtype)
        out, sT = ops.rwkv6_scan(tr, tk, tv, tw, tu)
        assert out.dtype == tr.dtype and out.shape == (B, S, H, dh)
        assert sT.dtype == torch.float32 and sT.shape == (B, H, dh, dh)
        pallas = pallas_rwkv6(jr, jk, jv, jw, ju, interpret=True)
        tol = RWKV6_TOL if dtype == "float32" else _tol(dtype)
        np.testing.assert_allclose(_np(out), _np(pallas), **tol)
        if dtype == "float32":
            eout, esT = ref.rwkv6_ref(jr, jk, jv, jw, ju,
                                      jnp.zeros((B, H, dh, dh), jnp.float32))
            np.testing.assert_allclose(_np(out), _np(eout), **ORACLE_TOL)
            np.testing.assert_allclose(_np(sT), _np(esT), **ORACLE_TOL)

    def test_nonzero_state_matches_the_oracle(self):
        B, S, H, dh = 2, 40, 3, 16
        (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv6_inputs(
            5, B, S, H, dh)
        js0, ts0 = _pair(np.random.default_rng(6).standard_normal(
            (B, H, dh, dh)))
        before = ts0.clone()
        out, sT = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
        eout, esT = ref.rwkv6_ref(jr, jk, jv, jw, ju, js0)
        np.testing.assert_allclose(_np(out), _np(eout), **ORACLE_TOL)
        np.testing.assert_allclose(_np(sT), _np(esT), **ORACLE_TOL)
        assert torch.equal(ts0, before)             # s0 is not written

    def test_float64_inputs_run_in_float64(self):
        """The plain version on float64 inputs keeps float64 throughout
        (``chip_smoke.py``'s yardstick for the float32 rounding of the
        scan): float64 out and state, the oracle's values within its
        float32 tolerance."""
        B, S, H, dh = 2, 40, 3, 16
        ins = _rwkv6_inputs(5, B, S, H, dh)
        js0, ts0 = _pair(np.random.default_rng(6).standard_normal(
            (B, H, dh, dh)))
        out, sT = ops.rwkv6_scan(*(t.double() for _, t in ins),
                                 ts0.double())
        assert out.dtype == sT.dtype == torch.float64
        eout, esT = ref.rwkv6_ref(*(j for j, _ in ins), js0)
        np.testing.assert_allclose(out.numpy(), _np(eout), **ORACLE_TOL)
        np.testing.assert_allclose(sT.numpy(), _np(esT), **ORACLE_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_one_step(self, dtype):
        """S = 1 from a nonzero state: out = r (s0 + u k v^T), sT = w s0 +
        k v^T (float32 products)."""
        B, H, dh = 2, 4, 32
        (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu) = _rwkv6_inputs(
            7, B, 1, H, dh, dtype)
        js0, ts0 = _pair(np.random.default_rng(8).standard_normal(
            (B, H, dh, dh)))
        out, sT = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts0)
        kv = tk.float()[:, 0, :, :, None] * tv.float()[:, 0, :, None, :]
        want = torch.einsum("bhk,bhkv->bhv", tr.float()[:, 0],
                            ts0 + tu.float()[None, :, :, None] * kv)
        torch.testing.assert_close(out[:, 0].float(),
                                   want.to(tr.dtype).float(), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(sT, tw[:, 0, :, :, None] * ts0 + kv,
                                   rtol=0, atol=0)
        if dtype == "float32":
            eout, esT = ref.rwkv6_ref(jr, jk, jv, jw, ju, js0)
            np.testing.assert_allclose(_np(out), _np(eout), **ORACLE_TOL)
            np.testing.assert_allclose(_np(sT), _np(esT), **ORACLE_TOL)

    def test_split_run_continues_the_state(self):
        (_, tr), (_, tk), (_, tv), (_, tw), (_, tu) = _rwkv6_inputs(
            9, 1, 20, 2, 16)
        whole, sT = ops.rwkv6_scan(tr, tk, tv, tw, tu)
        part, s = ops.rwkv6_scan(*(x[:, :13].contiguous()
                                   for x in (tr, tk, tv, tw)), tu)
        outs = [part]
        for t in range(13, 20):
            o, s = ops.rwkv6_scan(*(x[:, t:t + 1].contiguous()
                                    for x in (tr, tk, tv, tw)), tu, s)
            outs.append(o)
        torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(s, sT, rtol=1e-6, atol=1e-6)


def _chunked_rwkv6(r, k, v, w, u, s0, C):
    """The chunked passes of ``csrc/rwkv6_scan.cu`` in plain PyTorch, chunk
    length C, in float32 (float64 for float64 inputs).  Decays are only
    multiplied, as in the kernel.

    A, per chunk c: D_c = prod_{tau in c} w_tau and K_c = sum_s (k_s *
    prod_{tau in c, tau > s} w_tau) v_s^T, by a running product backwards.
    B: S_{c+1} = D_c S_c + K_c from s0, each chunk's start state kept.
    C: out_t = (r_t * P_t) S_c + sum_{s <= t} A[t, s] v_s, P_t = prod_{tau
    in c, tau < t} w_tau by a running product forwards, A[t, s] (s < t) =
    r_t . (k_s * prod_{s < tau < t} w_tau) by a running product over t for
    each s, and A[t, t] the bonus r_t . (u * k_t)."""
    B, S, H, dh = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf = (x.to(acc) for x in (r, k, v, w))
    uf = u.to(acc)
    bounds = [(c, min(S, c + C)) for c in range(0, S, C)]
    decays, sums = [], []
    for lo, hi in bounds:                                   # pass A
        g = torch.ones(B, H, dh, dtype=acc)
        kd = torch.empty_like(kf[:, lo:hi])
        for s in reversed(range(hi - lo)):
            kd[:, s] = kf[:, lo + s] * g
            g = g * wf[:, lo + s]
        decays.append(g)
        sums.append(torch.einsum("bshi,bshj->bhij", kd, vf[:, lo:hi]))
    st = s0.to(acc).clone()
    starts = []
    for d, kc in zip(decays, sums):                         # pass B
        starts.append(st)
        st = d[..., None] * st + kc
    out = torch.empty_like(r)
    for (lo, hi), sc in zip(bounds, starts):                # pass C
        rc, kc, vc, wc = (x[:, lo:hi] for x in (rf, kf, vf, wf))
        n = hi - lo
        A = torch.zeros(B, H, n, n, dtype=acc)
        q = torch.zeros_like(kc)
        p = torch.ones(B, H, dh, dtype=acc)
        rp = torch.empty_like(rc)
        for t in range(n):
            if t:
                A[:, :, t, :t] = torch.einsum("bhi,bshi->bhs", rc[:, t],
                                              q[:, :t])
                q[:, :t] = q[:, :t] * wc[:, t, None]
            q[:, t] = kc[:, t]
            A[:, :, t, t] = (rc[:, t] * uf * kc[:, t]).sum(-1)
            rp[:, t] = rc[:, t] * p
            p = p * wc[:, t]
        o = (torch.einsum("bthi,bhij->bthj", rp, sc)
             + torch.einsum("bhts,bshj->bthj", A, vc))
        out[:, lo:hi] = o.to(r.dtype)
    return out, st


def _extreme_decays(rng, shape):
    """w = exp(-exp(x)), x uniform in [-6, 4] (w from ~1e-24 to ~0.9975),
    with exact zeros, float32 denormals and exact ones mixed in."""
    w = np.exp(-np.exp(rng.uniform(-6.0, 4.0, shape))).astype(np.float32)
    pick = rng.random(shape)
    w[pick < 0.05] = 0.0
    w[(pick >= 0.05) & (pick < 0.08)] = np.float32(1e-40)
    w[pick >= 0.92] = 1.0
    return w


def _chunk_cases():
    cases = []
    for C in (1, 16, 64):
        for S in sorted({1, C - 1, C, C + 1, 3 * C + 5}):
            cases.append((C, S))
    return cases


class TestChunkedAlgebra:
    """The chunked form the CUDA kernel computes, held to the step-by-step
    recurrence on the CPU, from a nonzero state, with decays from 0 to 1
    (zeros, denormals and ones included)."""

    @staticmethod
    def _inputs(seed, B, S, H, dh):
        rng = np.random.default_rng(seed)
        r = rng.standard_normal((B, S, H, dh)).astype(np.float32)
        k = (0.2 * rng.standard_normal((B, S, H, dh))).astype(np.float32)
        v = (0.2 * rng.standard_normal((B, S, H, dh))).astype(np.float32)
        w = _extreme_decays(rng, (B, S, H, dh))
        u = (0.1 * rng.standard_normal((H, dh))).astype(np.float32)
        s0 = rng.standard_normal((B, H, dh, dh)).astype(np.float32)
        return r, k, v, w, u, s0

    @pytest.mark.parametrize("C,S", _chunk_cases())
    def test_float64_matches_the_recurrence(self, C, S):
        ins = [torch.from_numpy(x).double()
               for x in self._inputs(100 + S, 2, S, 3, 16)]
        out, sT = _chunked_rwkv6(*ins, C)
        wout, wsT = rwkv6_scan_ref(*ins)
        assert out.dtype == sT.dtype == torch.float64
        torch.testing.assert_close(out, wout, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(sT, wsT, rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize("C,S", _chunk_cases())
    def test_float32_matches_plain_and_oracle(self, C, S):
        np_ins = self._inputs(200 + S, 2, S, 3, 16)
        ins = [torch.from_numpy(x) for x in np_ins]
        out, sT = _chunked_rwkv6(*ins, C)
        wout, wsT = rwkv6_scan_ref(*ins)
        torch.testing.assert_close(out, wout, **ORACLE_TOL)
        torch.testing.assert_close(sT, wsT, **ORACLE_TOL)
        eout, esT = ref.rwkv6_ref(*(jnp.asarray(x) for x in np_ins))
        np.testing.assert_allclose(_np(out), _np(eout), **ORACLE_TOL)
        np.testing.assert_allclose(_np(sT), _np(esT), **ORACLE_TOL)


class TestWideAttention:
    """recurrentgemma_9b's attention: head_dim 256, 16 query heads on one
    KV head, a window of 2048 (here 64)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_flash_dh256_mqa_window(self, dtype):
        rng = np.random.default_rng(10)
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal(s), dtype)
            for s in ((1, 128, 16, 256), (1, 128, 1, 256), (1, 128, 1, 256)))
        got = ops.flash_attention(tq, tk, tv, window=64)
        np.testing.assert_allclose(
            _np(got), _np(pallas_flash(jq, jk, jv, window=64,
                                       interpret=True)), **_tol(dtype))
        if dtype == "float32":
            np.testing.assert_allclose(
                _np(got), _np(ref.attention_ref(jq, jk, jv, window=64)),
                **ORACLE_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_dh256_group16(self, dtype):
        rng = np.random.default_rng(11)
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal(s), dtype)
            for s in ((2, 16, 256), (2, 128, 1, 256), (2, 128, 1, 256)))
        lengths = np.array([128, 37], np.int32)
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
        np.testing.assert_allclose(
            _np(got), _np(pallas_decode(jq, jk, jv, jnp.asarray(lengths),
                                        interpret=True)), **_tol(dtype))
        if dtype == "float32":
            np.testing.assert_allclose(
                _np(got), _np(ref.decode_attention_ref(
                    jq, jk, jv, jnp.asarray(lengths))), **ORACLE_TOL)

    def test_windowed_decode_over_a_ring(self):
        """A ring of Sc <= window entries: every valid entry is in the
        window, so the decode is plain attention over the first lengths."""
        rng = np.random.default_rng(12)
        tq, tk, tv = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((2, 1, 4, 32), (2, 16, 1, 32),
                                   (2, 16, 1, 32)))
        lengths = torch.tensor([16, 5])
        got = TL.attention(tq, tk, tv, lengths, window=16)
        want = TL.attention(tq, tk, tv, lengths)
        assert torch.equal(got, want)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TL.attention(tq, tk, tv, lengths, window=8)


class TestLayers:
    """The port's RG-LRU block and RWKV-6 mixes against the JAX layers, in
    float32, on the same weights and a nonzero carried state."""

    @staticmethod
    def _params(shapes, seed):
        rng = np.random.default_rng(seed)
        return {k: 0.3 * rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}

    @staticmethod
    def _cfg(**kw):
        from repro_torch.configs import get_config
        from repro_torch.models import scale_down
        return scale_down(get_config(kw.pop("arch")), **kw)

    def test_rglru_block(self):
        cfg = self._cfg(arch="recurrentgemma_9b")
        p = self._params(TL.rglru_params_shapes(cfg), 13)
        rng = np.random.default_rng(14)
        x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
        st = {"h": rng.standard_normal((2, cfg.lru_dim)).astype(np.float32),
              "conv": rng.standard_normal((2, cfg.conv1d_width - 1,
                                           cfg.lru_dim)).astype(np.float32)}
        jout, jst = JL.rglru_block({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), cfg,
                                   {k: jnp.asarray(v) for k, v in st.items()})
        tout, tst = TL.rglru_block(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), cfg,
            {k: torch.from_numpy(v) for k, v in st.items()})
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4,
                                   atol=1e-4)
        for name in ("h", "conv"):
            np.testing.assert_allclose(_np(tst[name]), _np(jst[name]),
                                       **ORACLE_TOL)

    def test_rwkv_time_and_channel_mix(self):
        cfg = self._cfg(arch="rwkv6_3b")
        p = self._params(TL.rwkv_params_shapes(cfg), 15)
        rng = np.random.default_rng(16)
        B, S, d = 2, 9, cfg.d_model
        H, dh = cfg.rwkv_heads, cfg.rwkv_head_size
        x = rng.standard_normal((B, S, d)).astype(np.float32)
        st = {"shift": rng.standard_normal((B, d)).astype(np.float32),
              "wkv": rng.standard_normal((B, H, dh, dh)).astype(np.float32),
              "cm_shift": rng.standard_normal((B, d)).astype(np.float32)}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        js = {k: jnp.asarray(v) for k, v in st.items()}
        ts = {k: torch.from_numpy(v) for k, v in st.items()}
        jout, jst = JL.rwkv_time_mix(jp, jnp.asarray(x), cfg, js)
        tout, tst = TL.rwkv_time_mix(tp, torch.from_numpy(x), cfg, ts)
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4,
                                   atol=1e-4)
        for name in ("shift", "wkv"):
            np.testing.assert_allclose(_np(tst[name]), _np(jst[name]),
                                       rtol=1e-4, atol=1e-4)
        jout, jst = JL.rwkv_channel_mix(jp, jnp.asarray(x), js)
        tout, tst = TL.rwkv_channel_mix(tp, torch.from_numpy(x), ts)
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(tst["cm_shift"]),
                                   _np(jst["cm_shift"]), rtol=0, atol=0)

    def test_group_norm_heads(self):
        x = np.random.default_rng(17).standard_normal(
            (2, 3, 4, 16)).astype(np.float32)
        scale = np.random.default_rng(18).standard_normal(
            (4, 16)).astype(np.float32)
        got = TL.group_norm_heads(torch.from_numpy(x), torch.from_numpy(scale))
        want = JL.group_norm_heads(jnp.asarray(x), jnp.asarray(scale))
        np.testing.assert_allclose(_np(got), _np(want), **ORACLE_TOL)


class TestDispatch:
    def test_cpu_tensors_run_the_plain_versions(self):
        (_, ta), (_, tg), (_, th) = _rglru_inputs(19, 1, 4, 8, "float32")
        (_, tr), (_, tk), (_, tv), (_, tw), (_, tu) = _rwkv6_inputs(
            20, 1, 4, 2, 16)
        ops.reset_launches()
        ops.rglru_scan(ta, tg, th)
        ops.rglru_scan(ta, tg, th, force="ref")
        ops.rwkv6_scan(tr, tk, tv, tw, tu)
        n = ops.launches()
        assert n["rglru_scan"] == {"kernel": 0, "plain": 2}
        assert n["rwkv6_scan"] == {"kernel": 0, "plain": 1}
        ops.reset_launches()
        assert all(v == {"kernel": 0, "plain": 0}
                   for v in ops.launches().values())

    def test_bad_force_raises(self):
        (_, ta), (_, tg), (_, th) = _rglru_inputs(21, 1, 4, 8, "float32")
        with pytest.raises(ValueError):
            ops.rglru_scan(ta, tg, th, force="pallas")
        (_, tr), (_, tk), (_, tv), (_, tw), (_, tu) = _rwkv6_inputs(
            22, 1, 4, 2, 16)
        with pytest.raises(ValueError):
            ops.rwkv6_scan(tr, tk, tv, tw, tu, force="kernel")

    def test_launchers_refuse_cpu_tensors(self):
        """The CUDA launchers never run the plain version in their place."""
        (_, ta), (_, tg), (_, th) = _rglru_inputs(23, 1, 4, 8, "float32")
        with pytest.raises(ValueError, match="CUDA"):
            rglru_scan_cuda(ta, tg, th)
        (_, tr), (_, tk), (_, tv), (_, tw), (_, tu) = _rwkv6_inputs(
            24, 1, 4, 2, 16)
        with pytest.raises(ValueError, match="CUDA"):
            rwkv6_scan_cuda(tr, tk, tv, tw, tu)
