"""The decomposition the tensor-core flash backward relies on, on the CPU.

The dK / dV launch cuts each KV head's G query heads into slices
(``ops.head_splits`` of ``ops.dkdv_splits``), writes each slice's float32
partial sums and adds them in slice order.  Here the plain backward
(``ref.flash_backward``) on each slice's query heads, summed in that order,
equals the whole call within float32 rounding, and the split choice and the
path choice hold the properties the kernel and the card tests count on.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import ops, ref, rehearse

#: SMs of an H100, the card the split choice is made for in these checks
H100_SMS = 132


def _inputs(G: int, seed: int, *, B=1, Sq=40, Sk=40, KvH=2, D=16):
    rng = np.random.default_rng(seed)
    H = G * KvH
    q, do = (torch.as_tensor(rng.standard_normal((B, Sq, H, D),
                                                 dtype=np.float32))
             for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((B, Sk, KvH, D),
                                                dtype=np.float32))
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("G,splits,kw", [
    (12, 4, dict(window=24)),
    (5, 3, dict(causal=False)),
    (5, 2, dict(chunk_size=16)),
])
def test_head_slices_sum_to_the_whole(G, splits, kw):
    """dK and dV of the slices' query heads, added in slice order, equal
    the whole call's within float32 rounding; each slice's dQ is the
    whole call's dQ of those heads."""
    q, k, v, do = _inputs(G, 7 + G)
    KvH = k.shape[2]
    o, lse = ref.flash_prefill_lse(q, k, v, **kw)
    dq, dk, dv = ref.flash_backward(q, k, v, o, lse, do, **kw)
    sum_k = sum_v = None
    for g0, g1 in ops.head_splits(G, splits):
        heads = [kvh * G + g for kvh in range(KvH) for g in range(g0, g1)]
        part = ref.flash_backward(q[:, :, heads], k, v, o[:, :, heads],
                                  lse[:, heads], do[:, :, heads], **kw)
        torch.testing.assert_close(part[0], dq[:, :, heads], rtol=1e-5,
                                   atol=1e-6)
        sum_k = part[1] if sum_k is None else sum_k + part[1]
        sum_v = part[2] if sum_v is None else sum_v + part[2]
    for got, want in ((sum_k, dk), (sum_v, dv)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_head_splits_cover_each_head_once():
    for G in range(1, 17):
        for splits in range(1, G + 1):
            ranges = ops.head_splits(G, splits)
            assert [h for g0, g1 in ranges for h in range(g0, g1)] == \
                list(range(G))
            assert all(g1 > g0 for g0, g1 in ranges)
            assert max(g1 - g0 for g0, g1 in ranges) == -(-G // splits)


def _heaviest_and_mean(B, Sq, Sk, KvH, G, D, splits, kw, sms):
    """(the heaviest CTA's query tiles x heads, an SM's mean share)."""
    keys = ops.dkdv_keys(D)
    tiles = [ops._q_tiles(k0, min(k0 + keys, Sk) - 1, Sq,
                          kw.get("window", 0), kw.get("chunk_size", 0),
                          kw.get("causal", True))
             for k0 in range(0, Sk, keys)]
    halves = 2 if D > 128 else 1
    total = sum(tiles) * G * KvH * B * halves
    return -(-G // splits) * max(tiles), total / sms


@pytest.mark.parametrize("shape,kw,want", [
    # starcoder2-3b's training attention: 32 key blocks of 128, 4 slices
    # of 3 heads (256 CTAs)
    ((1, 4096, 4096, 2, 12, 128), dict(window=4096), 4),
    # gemma3-12b's local layers at D 256: one slice (384 CTAs)
    ((1, 1536, 1536, 8, 2, 256), dict(window=1024), 1),
    # the G = 5 card row: 27 key blocks of one query tile, slices 1, 2, 2
    ((1, 64, 3456, 2, 5, 64), dict(causal=False), 3),
])
def test_dkdv_splits_at_the_card_shapes(shape, kw, want):
    assert ops.dkdv_splits(*shape, sms=H100_SMS, **kw) == want


def test_dkdv_splits_is_the_fewest_that_balance():
    """The chosen split's heaviest CTA fits an SM's mean share and one
    slice fewer's does not (or it is G, where none fits)."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        B = int(rng.integers(1, 3))
        Sq, Sk = (int(x) for x in rng.integers(1, 3000, 2))
        KvH, G = int(rng.integers(1, 9)), int(rng.integers(1, 13))
        D = int(rng.choice([64, 80, 128, 256]))
        kw = dict(window=int(rng.choice([0, 100, 1024])),
                  chunk_size=int(rng.choice([0, 0, 96])),
                  causal=bool(rng.random() < 0.8))
        s = ops.dkdv_splits(B, Sq, Sk, KvH, G, D, sms=H100_SMS, **kw)
        assert 1 <= s <= G
        heavy, mean = _heaviest_and_mean(B, Sq, Sk, KvH, G, D, s, kw, H100_SMS)
        if heavy == 0:
            assert s == 1
            continue
        assert heavy <= mean or s == G
        if s > 1:
            assert _heaviest_and_mean(B, Sq, Sk, KvH, G, D, s - 1, kw,
                                      H100_SMS)[0] > mean


def test_bf16_rows_take_the_tensor_cores():
    """Every bf16 card row, D 256 included, runs the tensor-core kernels
    (three launches); float32 rows the CUDA-core pair (two); the G = 5 row
    cuts its heads into slices that do not divide G."""
    assert ops.BACKWARD_LAUNCHES == {"tensor_core": 3, "cuda_core": 2}
    uneven = False
    for B, Sq, H, KvH, D, w, ck, causal, Sk, dn in rehearse.BACKWARD_CASES:
        path = ops.backward_path(getattr(torch, dn), D)
        assert path == ("tensor_core" if dn == "bfloat16" else "cuda_core")
        if dn == "bfloat16":
            s = ops.dkdv_splits(B, Sq, Sk, KvH, H // KvH, -(-D // 8) * 8,
                                window=w, chunk_size=ck, causal=causal,
                                sms=H100_SMS)
            uneven |= (H // KvH) % s != 0
    assert uneven
