"""The CUDA attention kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so these tests carry the ``gpu``
marker and skip where there is no card; run them on a card with

    python -m pytest -q -m gpu tests/test_torch_attention_gpu.py

This file imports no JAX, so it runs where only the port is installed.
Tolerances are those of ``tests/test_kernels.py``: 2e-3 in float32 and
2e-2 in bfloat16 (the kernels sum in another order and round p to bf16
after another running max than the plain versions).  Rows with nothing to
attend to must be exactly 0 in both.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init, init_cache, prefill
from repro_torch.models import scale_down

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels are CUDA only")
    return torch.device("cuda")


def _rand(cuda, seed, *shapes, dtype):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in shapes]


def _close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sk,Hq,Hkv,dh", [
    (2, 256, 4, 4, 64),       # MHA
    (4, 512, 8, 2, 64),       # GQA 4:1
    (2, 1024, 4, 1, 128),     # MQA
    (3, 300, 16, 8, 128),     # qwen3 heads, odd Sk
    (2, 77, 8, 8, 32),        # odd Sk, small heads
    (2, 100, 16, 2, 128),     # group of 8
    (2, 300, 16, 1, 256),     # recurrentgemma: MQA group of 16, dh 256
    (3, 129, 16, 1, 128),     # group of 16 over two blocks
    (2, 64, 12, 2, 256),      # group of 6, dh 256: blocks of 4 and 2
    (2, 2048, 16, 1, 256),    # recurrentgemma's full window ring
])
def test_decode_matches_plain(cuda, B, Sk, Hq, Hkv, dh, dtype):
    q, k, v = _rand(cuda, Sk, (B, Hq, dh), (B, Sk, Hkv, dh),
                    (B, Sk, Hkv, dh), dtype=dtype)
    lengths = torch.randint(1, Sk + 1, (B,), device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(B)).to(torch.int32)
    lengths[0] = 0
    lengths[-1] = Sk
    k0 = ops.DECODE_LAUNCHES
    got = ops.decode_attention(q, k, v, lengths)
    want = ops.decode_attention(q, k, v, lengths, force="ref")
    torch.cuda.synchronize()
    assert ops.DECODE_LAUNCHES == k0 + 1
    _close(got, want, dtype)
    assert not got[0].float().any()                 # length 0 gives 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window", [
    (1, 128, 128, 4, 4, 64, True, -1),       # MHA
    (2, 256, 256, 8, 2, 64, True, -1),       # GQA 4:1
    (1, 256, 256, 4, 1, 128, True, -1),      # MQA
    (1, 200, 200, 16, 8, 128, True, -1),     # S not a tile multiple
    (1, 256, 256, 4, 4, 64, True, 32),       # sliding window
    (1, 128, 128, 2, 2, 64, False, -1),      # bidirectional
    (1, 128, 256, 2, 2, 64, True, -1),       # Sq < Sk
    (1, 77, 133, 4, 2, 32, True, 20),        # odd S and Sk, window
    (2, 70, 70, 4, 2, 32, False, 16),        # bidirectional window
    (1, 300, 300, 16, 1, 256, True, 64),     # recurrentgemma: dh 256, MQA
    (1, 128, 128, 4, 2, 256, True, -1),      # dh 256, causal
    (2, 77, 133, 4, 4, 256, True, 20),       # dh 256, odd S and Sk
])
def test_flash_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, dh, causal, window,
                             dtype):
    q, k, v = _rand(cuda, Sq + Sk, (B, Sq, Hq, dh), (B, Sk, Hkv, dh),
                    (B, Sk, Hkv, dh), dtype=dtype)
    kw = dict(causal=causal, window=window)
    k0 = ops.FLASH_LAUNCHES
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, force="ref", **kw)
    torch.cuda.synchronize()
    assert ops.FLASH_LAUNCHES == k0 + 1
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_fully_masked_rows_are_zero(cuda, dtype):
    """Sq > Sk, causal: the first Sq - Sk queries precede every key."""
    q, k, v = _rand(cuda, 1, (1, 256, 4, 64), (1, 128, 2, 64),
                    (1, 128, 2, 64), dtype=dtype)
    got = ops.flash_attention(q, k, v)
    _close(got, ops.flash_attention(q, k, v, force="ref"), dtype)
    assert not got[:, :128].float().any()


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _rand(cuda, 2, (1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                    dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, torch.cat([k, k], 2)[:, :, :2], v)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :16].contiguous(),
                            k[..., :16].contiguous(),
                            v[..., :16].contiguous())
    with pytest.raises(ValueError, match="fold"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="on"):
        ops.decode_attention(q[:, 0], k, v, torch.tensor([8]))
    q32, = _rand(cuda, 3, (1, 32, 64), dtype=torch.float32)
    k1, = _rand(cuda, 4, (1, 8, 1, 64), dtype=torch.float32)
    with pytest.raises(ValueError, match="at most"):
        ops.decode_attention(q32, k1, k1, torch.tensor([8], device=cuda))


@pytest.mark.gpu
def test_model_kernels_match_plain(cuda):
    """A small qwen3 (head_dim 64) in float32: prefill and 6 decode steps
    through the kernels and through the plain versions agree."""
    cfg = dataclasses.replace(
        scale_down(get_config("qwen3_1_7b"), layers=3, d_model=256,
                   n_heads=4, n_kv_heads=2, d_ff=512), dtype="float32")
    params = init(cfg, 0, cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 9), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(0))
    ops.reset_launches()
    logits = {}
    for force in (None, "ref"):
        cache = init_cache(cfg, 2, 16, device=cuda)
        out, cache = prefill(params, cfg, {"tokens": tokens}, cache,
                             force=force)
        seq = [out]
        for pos in range(9, 15):
            out, cache = decode_step(params, cfg,
                                     seq[-1].argmax(-1).to(torch.int32),
                                     cache, pos, force=force)
            seq.append(out)
        logits[force] = torch.stack(seq)
    torch.cuda.synchronize()
    n = ops.launches()
    assert n["flash_attention"] == {"kernel": 3, "plain": 3}
    assert n["decode_attention"] == {"kernel": 18, "plain": 18}
    torch.testing.assert_close(logits[None], logits["ref"], rtol=1e-4,
                               atol=1e-4)
