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
from repro_torch.kernels.decode_attention import split_plan
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


# Sq and Sk around the bf16 kernel's tiles (128 query rows, 128 keys at
# dh 64); B = 3, so a tail read from the next batch row would show
EDGES = [1, 63, 64, 65, 127, 128, 129, 777]


@pytest.mark.gpu
@pytest.mark.parametrize("Sk", EDGES)
@pytest.mark.parametrize("Sq", EDGES)
def test_flash_bf16_tile_edges(cuda, Sq, Sk):
    q, k, v = _rand(cuda, 7 * Sq + Sk, (3, Sq, 4, 64), (3, Sk, 2, 64),
                    (3, Sk, 2, 64), dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q, k, v, force="ref")
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)
    if Sq > Sk:                 # the first Sq - Sk queries precede every key
        assert not got[:, :Sq - Sk].float().any()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,window", [(64, 70), (128, 200), (256, 100)])
def test_flash_bf16_window_mid_tile(cuda, dh, window, causal):
    """Windows whose first key falls inside a KV tile (BK 128, 64 at dh
    256), Sq < Sk."""
    q, k, v = _rand(cuda, window, (2, 333, 4, dh), (2, 517, 2, dh),
                    (2, 517, 2, dh), dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, force="ref", **kw)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("G", [1, 2, 8, 16])
def test_flash_bf16_groups(cuda, G, dh):
    Hkv = 2 if G < 16 else 1
    q, k, v = _rand(cuda, G, (2, 200, G * Hkv, dh), (2, 200, Hkv, dh),
                    (2, 200, Hkv, dh), dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q, k, v, force="ref")
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_flash_bf16_head_dims(cuda, dh, causal):
    q, k, v = _rand(cuda, dh, (3, 257, 4, dh), (3, 257, 2, dh),
                    (3, 257, 2, dh), dtype=torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, force="ref")
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Hq,Hkv,dh", [(16, 8, 128), (16, 1, 256), (8, 8, 64)])
def test_decode_split_edges(cuda, Hq, Hkv, dh, dtype):
    """Lengths one short of a split's chunk C, at it and one past it, 0, 1
    and the whole cache, on a cache cut into at least 3 splits."""
    B, Sk = 6, 4096
    n_split, C = split_plan(Sk, B, Hkv)
    assert n_split >= 3
    q, k, v = _rand(cuda, dh, (B, Hq, dh), (B, Sk, Hkv, dh),
                    (B, Sk, Hkv, dh), dtype=dtype)
    lengths = torch.tensor([C - 1, C, C + 1, 0, 1, Sk], dtype=torch.int32,
                           device=cuda)
    k0 = ops.DECODE_LAUNCHES
    got = ops.decode_attention(q, k, v, lengths)
    want = ops.decode_attention(q, k, v, lengths, force="ref")
    torch.cuda.synchronize()
    assert ops.DECODE_LAUNCHES == k0 + 1
    _close(got, want, dtype)
    assert not got[3].float().any()                 # length 0 gives 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sk", [36, 64])
def test_decode_one_split_allocates_no_scratch(cuda, Sk, dtype):
    """A cache that fits one chunk (the serving caches hold 36 slots):
    one split, and the call allocates its output and nothing else."""
    B, Hq, Hkv, dh = 1, 16, 8, 128
    assert split_plan(Sk, B, Hkv) == (1, Sk)
    q, k, v = _rand(cuda, Sk, (B, Hq, dh), (B, Sk, Hkv, dh),
                    (B, Sk, Hkv, dh), dtype=dtype)
    lengths = torch.tensor([Sk - 5], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = ops.decode_attention(q, k, v, lengths)
    n1 = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert n1 - n0 == 1
    _close(got, ops.decode_attention(q, k, v, lengths, force="ref"), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_recurrentgemma_ring(cuda, dtype):
    """recurrentgemma_9b's full window ring: one row, 2,048 keys, 16 query
    heads on one KV head of 256."""
    q, k, v = _rand(cuda, 2048, (1, 16, 256), (1, 2048, 1, 256),
                    (1, 2048, 1, 256), dtype=dtype)
    assert split_plan(2048, 1, 1)[0] > 1
    lengths = torch.tensor([2048], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths)
    want = ops.decode_attention(q, k, v, lengths, force="ref")
    torch.cuda.synchronize()
    _close(got, want, dtype)


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
def test_bf16_flash_refuses_what_the_wgmma_kernel_does_not_take(cuda):
    """A bf16 CUDA tensor the tensor-core kernel does not take raises; it
    reaches neither the float32 kernel nor the plain version."""
    q, k, v = _rand(cuda, 5, (1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                    dtype=torch.bfloat16)
    ops.reset_launches()
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :16].contiguous(),
                            k[..., :16].contiguous(),
                            v[..., :16].contiguous())
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)            # 2 bytes off 16
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(shifted, k, v)
    assert ops.launches()["flash_attention"] == {"kernel": 0, "plain": 0}


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
