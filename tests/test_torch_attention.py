"""The port's plain attention against the JAX package, on the CPU.

``repro_torch.kernels.ops.flash_attention`` / ``decode_attention`` on CPU
tensors run the plain PyTorch versions that the CUDA kernels are held to on
the card.  Here they are held to the jnp oracles (``repro.kernels.ref``)
and to the Pallas kernels run in interpret mode, at the shapes of
``tests/test_kernels.py``; inputs come from numpy with a seed.

Tolerances: 1e-5 against the oracle in float32 (the same float32 function,
summed in another order); 2e-3 (float32) and 2e-2 (bfloat16) against the
Pallas kernels, as ``tests/test_kernels.py`` holds those kernels to the
oracle.  Rows with nothing to attend to (decode length 0, a query before
every key) are held to the Pallas kernel only, and must be 0: the oracles
give the mean of V there, the kernels and the JAX model's attention give 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models import layers as TL
from torch_threads import one_torch_thread  # noqa: E402,F401

ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _inputs(seed, *shapes, dtype="float32"):
    """numpy float32 arrays rounded to ``dtype``, and the same values as
    jnp and torch arrays of that dtype."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        j = jnp.asarray(a, jnp.dtype(dtype))
        t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch,
                                                                   dtype))
        out.append((j, t))
    return out


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


class TestFlash:
    @pytest.mark.parametrize("B,S,Hq,Hkv,dh", [
        (1, 128, 4, 4, 64),      # MHA
        (2, 256, 8, 2, 64),      # GQA 4:1
        (1, 256, 4, 1, 128),     # MQA
        (1, 512, 2, 2, 32),      # long seq, small heads
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_causal(self, B, S, Hq, Hkv, dh, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            S, (B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh), dtype=dtype)
        got = ops.flash_attention(tq, tk, tv, causal=True)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        pallas = pallas_flash(jq, jk, jv, causal=True, interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
        if dtype == "float32":
            oracle = ref.attention_ref(jq, jk, jv, causal=True)
            np.testing.assert_allclose(_np(got), _np(oracle), **ORACLE_TOL)

    @pytest.mark.parametrize("window", [32, 64, 128])
    def test_sliding_window(self, window):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            window, *[(1, 256, 4, 64)] * 3)
        got = ops.flash_attention(tq, tk, tv, window=window)
        np.testing.assert_allclose(
            _np(got), _np(ref.attention_ref(jq, jk, jv, window=window)),
            **ORACLE_TOL)
        np.testing.assert_allclose(
            _np(got), _np(pallas_flash(jq, jk, jv, window=window,
                                       interpret=True)), **_tol("float32"))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bidirectional(self, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            3, *[(1, 128, 2, 64)] * 3, dtype=dtype)
        got = ops.flash_attention(tq, tk, tv, causal=False)
        np.testing.assert_allclose(
            _np(got), _np(pallas_flash(jq, jk, jv, causal=False,
                                       interpret=True)), **_tol(dtype))
        if dtype == "float32":
            np.testing.assert_allclose(
                _np(got), _np(ref.attention_ref(jq, jk, jv, causal=False)),
                **ORACLE_TOL)

    def test_cross_lengths(self):
        """Sq < Sk: suffix-aligned, every query sees keys."""
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            4, (1, 128, 2, 64), (1, 256, 2, 64), (1, 256, 2, 64))
        got = ops.flash_attention(tq, tk, tv)
        np.testing.assert_allclose(
            _np(got), _np(ref.attention_ref(jq, jk, jv)), **ORACLE_TOL)
        np.testing.assert_allclose(
            _np(got), _np(pallas_flash(jq, jk, jv, interpret=True)),
            **_tol("float32"))

    def test_fully_masked_rows_are_zero(self):
        """Sq > Sk, causal: the first Sq - Sk queries precede every key."""
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            5, (1, 256, 2, 64), (1, 128, 2, 64), (1, 128, 2, 64))
        got = ops.flash_attention(tq, tk, tv)
        np.testing.assert_allclose(
            _np(got), _np(pallas_flash(jq, jk, jv, interpret=True)),
            **_tol("float32"))
        assert not _np(got)[:, :128].any()
        np.testing.assert_allclose(
            _np(got)[:, 128:],
            _np(ref.attention_ref(jq, jk, jv))[:, 128:], **ORACLE_TOL)

    @pytest.mark.parametrize("S,window", [(100, -1), (200, -1), (133, 20)])
    def test_sequence_not_a_tile_multiple(self, S, window):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            S, (2, S, 4, 32), (2, S, 2, 32), (2, S, 2, 32))
        got = ops.flash_attention(tq, tk, tv, window=window)
        np.testing.assert_allclose(
            _np(got), _np(ref.attention_ref(jq, jk, jv, window=window)),
            **ORACLE_TOL)

    def test_softmax_scale(self):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(6, *[(1, 64, 2, 32)] * 3)
        got = ops.flash_attention(tq, tk, tv, softmax_scale=0.3)
        np.testing.assert_allclose(
            _np(got), _np(ref.attention_ref(jq, jk, jv, softmax_scale=0.3)),
            **ORACLE_TOL)


class TestDecode:
    @pytest.mark.parametrize("B,Sk,Hq,Hkv,dh", [
        (2, 256, 4, 4, 64),
        (4, 512, 8, 2, 64),
        (1, 1024, 4, 1, 128),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ragged_lengths(self, B, Sk, Hq, Hkv, dh, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            Sk + B, (B, Hq, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh),
            dtype=dtype)
        lengths = np.random.default_rng(Sk).integers(1, Sk + 1, B)
        lengths[0] = 1
        lengths = lengths.astype(np.int32)
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
        assert got.dtype == tq.dtype and got.shape == tq.shape
        pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths),
                               interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
        if dtype == "float32":
            oracle = ref.decode_attention_ref(jq, jk, jv,
                                              jnp.asarray(lengths))
            np.testing.assert_allclose(_np(got), _np(oracle), **ORACLE_TOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_length_zero_rows_are_zero(self, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            7, (3, 8, 64), (3, 256, 2, 64), (3, 256, 2, 64), dtype=dtype)
        lengths = np.array([0, 256, 0], np.int32)
        got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
        pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths),
                               interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))
        assert not _np(got)[[0, 2]].any()
        assert _np(got)[1].any()

    def test_entries_past_length_are_ignored(self):
        (_, tq), (_, tk), (_, tv) = _inputs(
            8, (1, 2, 64), (1, 256, 2, 64), (1, 256, 2, 64))
        lengths = torch.tensor([100], dtype=torch.int32)
        out1 = ops.decode_attention(tq, tk, tv, lengths)
        tk[:, 100:], tv[:, 100:] = 99.0, -99.0
        out2 = ops.decode_attention(tq, tk, tv, lengths)
        assert torch.equal(out1, out2)

    def test_matches_flash_on_the_last_query(self):
        """One token over a full cache is the last row of causal flash."""
        (_, tq), (_, tk), (_, tv) = _inputs(
            9, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
        full = ops.flash_attention(tq, tk, tv)
        one = ops.decode_attention(tq[:, -1].contiguous(), tk, tv,
                                   torch.tensor([64, 64]))
        torch.testing.assert_close(one, full[:, -1], rtol=1e-6, atol=1e-6)


# cache shapes of chip_smoke.py's decode cases: (B, Sk, Hq, Hkv, dh)
DECODE_32K = (8, 32768, 16, 8, 128)
RG_RING_2K = (1, 2048, 16, 1, 256)


def _live_blocks(lengths, B, Sk, Hq, Hkv, dh, heads_per_block):
    """Blocks of the split kernel that hold keys for these lengths, with
    ``heads_per_block`` query heads of a group in a block."""
    n_split, chunk = dec.split_plan(Sk, B, Hkv)
    per_row = Hkv * -(-(Hq // Hkv) // heads_per_block)
    return sum(min(n_split, -(-n // chunk)) for n in lengths) * per_row


class TestSplitPlan:
    """``split_plan`` picks how many blocks share a cache row, from Sk and
    the launch geometry only."""

    @pytest.mark.parametrize("Hkv", [8, 1, 32, 2])
    def test_one_split_for_short_caches(self, Hkv):
        """The serving caches (36 slots) and every Sk up to ONE_SPLIT_KEYS
        take one split: one launch, no scratch."""
        assert dec.split_plan(36, 1, Hkv) == (1, 36)
        for Sk in range(1, dec.ONE_SPLIT_KEYS + 1):
            for B in (1, 2, 8):
                n_split, chunk = dec.split_plan(Sk, B, Hkv)
                assert n_split == 1 and chunk >= Sk

    @pytest.mark.parametrize("B,Sk,Hq,Hkv,dh", [
        DECODE_32K, RG_RING_2K, (8, 4096, 16, 8, 128), (4, 4096, 32, 32, 128),
        (1, 2064, 16, 8, 128), (3, 1000, 16, 1, 256), (2, 65, 4, 2, 64),
        (64, 32768, 16, 8, 128)])
    def test_chunks_cover_the_cache(self, B, Sk, Hq, Hkv, dh):
        n_split, chunk = dec.split_plan(Sk, B, Hkv)
        assert 1 <= n_split and n_split * chunk >= Sk
        assert (n_split == 1) == (Sk <= chunk)
        if n_split > 1:
            assert chunk % dec.KEY_STRIDE == 0
            assert (n_split - 1) * chunk < Sk     # no split is empty when full

    def test_enough_blocks_at_decode_32k(self):
        """chip_smoke.py's ragged decode_32k rows fill 2 x 132 blocks or
        more (64 blocks with one split a row)."""
        lengths = [1, 300, 32768, 17000, 4096, 32768, 9999, 32768]
        assert _live_blocks(lengths, *DECODE_32K, heads_per_block=2) \
            >= 2 * dec.SMS

    def test_enough_blocks_on_the_recurrentgemma_ring(self):
        """One full ring of 2,048 slots, 16 query heads on one KV head of
        256: 4 blocks with one split; splits of one warp step (32 keys)
        give 256, about 2 x 132."""
        blocks = _live_blocks([2048], *RG_RING_2K, heads_per_block=4)
        assert blocks == 4 * 2048 // dec.KEY_STRIDE >= 1.9 * dec.SMS


class TestDecodeSplitRef:
    """``decode_attention_split_ref``, the kernel's split-and-merge
    arithmetic in plain PyTorch, against the plain version and the Pallas
    kernel, on lengths at the chunk edges."""

    @pytest.mark.parametrize("split", ["plan", "uneven", "one"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_plain_and_pallas(self, dtype, split):
        B, Sk, Hq, Hkv, dh = 6, 1024, 4, 2, 64
        n_split, chunk = {"plan": dec.split_plan(Sk, B, Hkv),
                          "uneven": (3, 352), "one": (1, Sk)}[split]
        (jq, tq), (jk, tk), (jv, tv) = _inputs(
            31, (B, Hq, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh), dtype=dtype)
        lengths = np.array([0, 1, chunk - 1, chunk, chunk + 1, Sk], np.int32)
        tl = torch.from_numpy(lengths)
        got = dec.decode_attention_split_ref(tq, tk, tv, tl, n_split, chunk)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        assert not _np(got)[0].any()                  # length 0 gives 0
        plain = ops.decode_attention(tq, tk, tv, tl)
        tol = ORACLE_TOL if dtype == "float32" else _tol(dtype)
        np.testing.assert_allclose(_np(got), _np(plain), **tol)
        pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths),
                               interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


class TestDispatch:
    def test_cpu_tensors_run_the_plain_versions(self):
        ops.reset_launches()
        (_, tq), (_, tk), (_, tv) = _inputs(10, *[(1, 16, 2, 32)] * 3)
        ops.flash_attention(tq, tk, tv)
        ops.flash_attention(tq, tk, tv, force="ref")
        ops.decode_attention(tq[:, 0].contiguous(), tk, tv,
                             torch.tensor([16]))
        n = ops.launches()
        assert n["flash_attention"] == {"kernel": 0, "plain": 2}
        assert n["decode_attention"] == {"kernel": 0, "plain": 1}
        assert n["event_step"] == {"kernel": 0, "plain": 0}
        ops.reset_launches()
        assert all(v == {"kernel": 0, "plain": 0}
                   for v in ops.launches().values())

    def test_bad_force_raises(self):
        (_, tq), (_, tk), (_, tv) = _inputs(11, *[(1, 4, 1, 32)] * 3)
        with pytest.raises(ValueError):
            ops.flash_attention(tq, tk, tv, force="pallas")
        with pytest.raises(ValueError):
            ops.decode_attention(tq[:, 0], tk, tv, torch.tensor([4]),
                                 force="kernel")

    def test_launchers_refuse_cpu_tensors(self):
        """The CUDA launchers never run the plain version in their place."""
        (_, tq), (_, tk), (_, tv) = _inputs(12, *[(1, 4, 1, 32)] * 3)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(tq, tk, tv)
        with pytest.raises(ValueError, match="CUDA"):
            decode_attention_cuda(tq[:, 0], tk, tv, torch.tensor([4]))

    def test_layer_attention_routes_by_lengths(self):
        (_, tq), (_, tk), (_, tv) = _inputs(13, *[(2, 8, 4, 32)] * 3)
        ops.reset_launches()
        TL.attention(tq, tk, tv)
        out = TL.attention(tq[:, -1:], tk, tv, torch.tensor([8, 3]))
        assert out.shape == (2, 1, 4, 32)
        n = ops.launches()
        assert n["flash_attention"]["plain"] == 1
        assert n["decode_attention"]["plain"] == 1
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TL.attention(tq[:, -1:], tk, tv, torch.tensor([8, 3]), window=4)
