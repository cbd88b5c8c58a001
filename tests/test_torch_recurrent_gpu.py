"""The CUDA recurrence kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so these tests carry the ``gpu``
marker and skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_recurrent_gpu.py

This file imports no JAX, so it runs where only the port is installed.

Tolerances:
- ``rglru_scan``: none.  Both versions take the same float32 steps, a
  product and a sum each rounded (the kernel is built with
  ``--fmad=false``), so they must agree bit for bit.
- ``rwkv6_scan``: 1e-5 relative and absolute in float32 on outputs and
  state (the sum over the head runs in another order than the plain
  version's einsum), and 2e-2 in bfloat16 on outputs (the same float32
  values rounded to bf16 may land one ulp apart), the tolerance
  ``tests/test_kernels.py`` uses for bf16 kernels.

Both kernels have two paths (``rglru_scan.DIRECT_MAX_S``,
``rwkv6_scan.DIRECT_MAX_S``; rwkv6's chunks of ``rwkv6_scan.CHUNK``
steps): the cases below take each path, its edges (tile and chunk
boundaries, one past the direct path), rows that are not 16-byte aligned
(RG-LRU widths 700 and 1), and RWKV-6 decays from 0 to 1.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rwkv6_mod
from repro_torch.models import decode_step, init, init_cache, prefill
from repro_torch.models import scale_down

DTYPES = [torch.float32, torch.bfloat16]
RWKV6_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the recurrence kernels are CUDA "
                    "only")
    return torch.device("cuda")


def _gen(cuda, seed):
    return torch.Generator(device=cuda).manual_seed(seed)


def _rglru_inputs(cuda, seed, B, S, W, dtype):
    g = _gen(cuda, seed)
    a = (0.8 + 0.199 * torch.rand(B, S, W, generator=g, device=cuda))
    gx = 0.1 * torch.randn(B, S, W, generator=g, device=cuda)
    h0 = 0.1 * torch.randn(B, W, generator=g, device=cuda)
    return a.to(dtype), gx.to(dtype), h0.to(dtype)


def _rwkv6_inputs(cuda, seed, B, S, H, dh, dtype, state=False):
    g = _gen(cuda, seed)
    r, k, v = (s * torch.randn(B, S, H, dh, generator=g, device=cuda)
               for s in (1.0, 0.2, 0.2))
    w = 0.9 + 0.099 * torch.rand(B, S, H, dh, generator=g, device=cuda)
    u = 0.1 * torch.randn(H, dh, generator=g, device=cuda)
    s0 = (torch.randn(B, H, dh, dh, generator=g, device=cuda)
          if state else None)
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype), s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", [
    (1, 256, 512),       # tests/test_kernels.py shapes
    (2, 512, 1024),
    (1, 37, 4096),       # odd S, recurrentgemma's width
    (3, 100, 700),       # B > 1, W not a multiple of 128
    (2, 1, 4096),        # one decode step
    (1, 13, 1),          # one channel
    (2, 4096, 4096),     # recurrentgemma's prefill width, B = 2
    (1, 4096, 700),      # rows not 16-byte aligned in bf16
    (1, 300, 1),         # one channel past the direct path
    (1, 8, 700),         # the direct path's last S
    (1, 9, 700),         # the staged path's first S
    (3, 129, 333),       # one past a bf16 tile (128 steps), odd width
    (2, 65, 96),         # one past a float32 tile (64 steps)
    (1, 1000, 4100),     # a last block of 4 channels
])
def test_rglru_matches_plain(cuda, B, S, W, dtype):
    a, gx, h0 = _rglru_inputs(cuda, S + W, B, S, W, dtype)
    k0 = ops.RGLRU_LAUNCHES
    hs, hT = ops.rglru_scan(a, gx, h0)
    ws, wT = ops.rglru_scan(a, gx, h0, force="ref")
    torch.cuda.synchronize()
    assert ops.RGLRU_LAUNCHES == k0 + 1
    assert hs.dtype == dtype and hs.shape == (B, S, W)
    assert hT.dtype == dtype and hT.shape == (B, W)
    assert torch.equal(hs, ws) and torch.equal(hT, wT)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,dh,state", [
    (1, 128, 2, 64, False),     # tests/test_kernels.py shapes
    (2, 256, 4, 32, False),
    (1, 77, 40, 64, True),      # odd S, rwkv6_3b's heads, a carried state
    (3, 1, 40, 64, True),       # one decode step, B > 1
    (2, 33, 3, 16, True),       # small heads (the scaled-down models)
    (1, 20, 2, 128, True),      # wide heads
    (1, 16, 40, 64, True),      # the direct path's last S
    (1, 17, 40, 64, True),      # the chunked path's first S
    (2, 63, 40, 64, True),      # one chunk short of 64 steps
    (2, 64, 40, 64, True),      # one chunk
    (2, 65, 40, 64, True),      # one step into a second chunk
    (2, 4096, 40, 64, True),    # rwkv6_3b's prefill width, B = 2
    (2, 100, 3, 16, True),      # chunked, every head size
    (1, 150, 4, 32, True),
    (1, 130, 2, 128, True),
])
def test_rwkv6_matches_plain(cuda, B, S, H, dh, state, dtype):
    r, k, v, w, u, s0 = _rwkv6_inputs(cuda, S + H, B, S, H, dh, dtype,
                                      state)
    before = None if s0 is None else s0.clone()
    k0 = ops.RWKV6_LAUNCHES
    out, sT = ops.rwkv6_scan(r, k, v, w, u, s0)
    wout, wsT = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    torch.cuda.synchronize()
    assert ops.RWKV6_LAUNCHES == k0 + 1
    assert out.dtype == dtype and out.shape == (B, S, H, dh)
    assert sT.dtype == torch.float32 and sT.shape == (B, H, dh, dh)
    tol = RWKV6_TOL[dtype]
    torch.testing.assert_close(out.float(), wout.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(sT, wsT, rtol=1e-5, atol=1e-5)
    if s0 is not None:
        assert torch.equal(s0, before)              # s0 is not written


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 16, 63, 64, 65, 4096])
def test_rwkv6_decay_extremes(cuda, S, dtype):
    """w = exp(-exp(x)), x uniform in [-6, 4], with exact zeros, float32
    denormals and exact ones mixed in (the model's decay can reach each):
    a chunked form that divided decays would give 0/0 or inf here."""
    B, H, dh = 2, 40, 64
    r, k, v, _, u, s0 = _rwkv6_inputs(cuda, 1000 + S, B, S, H, dh, dtype,
                                      True)
    g = _gen(cuda, 2000 + S)
    w = torch.exp(-torch.exp(-6.0 + 10.0 * torch.rand(
        B, S, H, dh, generator=g, device=cuda)))
    pick = torch.rand(B, S, H, dh, generator=g, device=cuda)
    w[pick < 0.05] = 0.0
    w[(pick >= 0.05) & (pick < 0.08)] = 1e-40
    w[pick >= 0.92] = 1.0
    out, sT = ops.rwkv6_scan(r, k, v, w, u, s0)
    wout, wsT = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(sT).all()
    tol = RWKV6_TOL[dtype]
    torch.testing.assert_close(out.float(), wout.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(sT, wsT, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("S", [1, 100])
def test_rwkv6_u_in_any_float_dtype(cuda, S, u_dtype):
    """The kernels read u in r's dtype or float32; another dtype is cast to
    float32 first.  Both paths, bf16 r, k, v."""
    r, k, v, w, u, s0 = _rwkv6_inputs(cuda, 11 + S, 1, S, 40, 64,
                                      torch.bfloat16, True)
    u = u.float().to(u_dtype)
    out, sT = ops.rwkv6_scan(r, k, v, w, u, s0)
    wout, wsT = ops.rwkv6_scan(r, k, v, w, u, s0, force="ref")
    torch.cuda.synchronize()
    tol = RWKV6_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), wout.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(sT, wsT, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_rwkv6_paths_meet_at_the_threshold(cuda):
    """One more step than the direct path takes runs the chunked path; the
    two agree on the steps they share."""
    S = rwkv6_mod.DIRECT_MAX_S
    r, k, v, w, u, s0 = _rwkv6_inputs(cuda, 7, 1, S + 1, 40, 64,
                                      torch.float32, True)
    long_out, _ = ops.rwkv6_scan(r, k, v, w, u, s0)
    short = [x[:, :S].contiguous() for x in (r, k, v, w)]
    short_out, _ = ops.rwkv6_scan(*short, u, s0)
    torch.testing.assert_close(long_out[:, :S], short_out, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    a, gx, h0 = _rglru_inputs(cuda, 1, 1, 8, 64, torch.float32)
    with pytest.raises(TypeError):
        ops.rglru_scan(a.half(), gx.half(), h0.half())
    with pytest.raises(TypeError):
        ops.rglru_scan(a, gx.bfloat16(), h0)
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan(a, gx, h0[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a, torch.cat([gx, gx], 2)[:, :, ::2], h0)
    with pytest.raises(ValueError, match="on"):
        ops.rglru_scan(a, gx, h0.cpu())
    r, k, v, w, u, s0 = _rwkv6_inputs(cuda, 2, 1, 8, 2, 64, torch.float32,
                                      True)
    with pytest.raises(ValueError, match="head size"):
        ops.rwkv6_scan(*(x[..., :48].contiguous() for x in (r, k, v, w)),
                       u[:, :48].contiguous())
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        ops.rwkv6_scan(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6_scan(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_scan(r, k.transpose(1, 2).contiguous().transpose(1, 2),
                       v, w, u, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6_3b", "recurrentgemma_9b"])
def test_model_kernels_match_plain(cuda, arch):
    """A small model of each recurrent family in float32 (head sizes the
    kernels take: rwkv 64, attention 64), 5 layers of recurrentgemma so
    the tail runs, a prompt past its window of 64 so the ring wraps:
    prefill and 6 decode steps through the kernels and through the plain
    versions agree."""
    cfg = dataclasses.replace(
        scale_down(get_config(arch), layers=3, d_model=256, n_heads=4,
                   d_ff=512), dtype="float32")
    if arch == "recurrentgemma_9b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    params = init(cfg, 0, cuda)
    S = 70
    tokens = torch.randint(0, cfg.vocab, (2, S), device=cuda,
                           generator=_gen(cuda, 0))
    ops.reset_launches()
    logits = {}
    for force in (None, "ref"):
        cache = init_cache(cfg, 2, S + 8, device=cuda)
        out, cache = prefill(params, cfg, {"tokens": tokens}, cache,
                             force=force)
        seq = [out]
        for pos in range(S, S + 6):
            out, cache = decode_step(params, cfg,
                                     seq[-1].argmax(-1).to(torch.int32),
                                     cache, pos, force=force)
            seq.append(out)
        logits[force] = torch.stack(seq)
    torch.cuda.synchronize()
    n = ops.launches()
    kinds = [s.kind for s in cfg.layer_specs()]
    for name, kind in (("rglru_scan", "rglru"), ("rwkv6_scan", "rwkv"),
                       ("flash_attention", "attn")):
        want = kinds.count(kind) * 7 if kind != "attn" else kinds.count(kind)
        assert n[name] == {"kernel": want, "plain": want}, name
    want = kinds.count("attn") * 6
    assert n["decode_attention"] == {"kernel": want, "plain": want}
    torch.testing.assert_close(logits[None], logits["ref"], rtol=1e-4,
                               atol=1e-4)
