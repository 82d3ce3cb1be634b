"""The tensor-core SSD-scan backward's head slices, on the CPU.

``ops.backward_slices`` chooses how many slices of each group's heads the
head-slice kernel (``csrc/ssd_scan_tc_bwd.cu``, launch 3) takes, and
``ref.slice_bounds`` which heads each holds.  The kernel sums (dy x^T) o D
over a slice's heads in float32, then adds the slices in order;
``ref.ssd_scan_chunked_backward(..., slices=)`` mirrors that order.  Here:
the choice's bounds, the mirror's slice order against its head order, and
the mirror with several slices against ``jax.vjp`` of the JAX package's
oracle (``src/repro/kernels/ssd_scan/ref.py::ssd_scan``), at the limits of
``tests/test_torch_ssd_backward.py``.  Five items or fewer, so that
``--dist loadfile`` schedules the file beside the run's longest one.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as j_ref
from repro_torch.kernels.ssd_scan import ops as t_ops, ref as t_ref
from _torch_parity import one_torch_thread

F32_LIMIT = 1e-4
BF16_LIMIT = 5e-2
#: the slice order against the head order in float32: sums of the same
#: float32 terms in another grouping
ORDER_LIMIT = 1e-6
NAMES = ("x", "a", "B", "C")
# Bsz, L, H, P, G, N: a ragged last chunk with 6 heads a group (slices of
# 2 and 3 heads, and of 1 and 2 when 4 do not divide 6), two groups of 5
CASES = [(1, 300, 6, 8, 1, 16), (2, 200, 10, 8, 2, 16)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread beside the other test processes
    (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _inputs(case, seed=0):
    """numpy x, a, B, C and cotangents dy, d_state (float32)."""
    Bz, L, H, P, G, N = case
    rng = np.random.default_rng(seed + L + H)
    x = (0.5 * rng.standard_normal((Bz, L, H, P))).astype(np.float32)
    a = rng.uniform(0.7, 0.999, (Bz, L, H)).astype(np.float32)
    B, C = ((0.3 * rng.standard_normal((Bz, L, G, N))).astype(np.float32)
            for _ in range(2))
    dy = rng.standard_normal((Bz, L, H, P)).astype(np.float32)
    ds = (0.1 * rng.standard_normal((Bz, H, P, N))).astype(np.float32)
    return (x, a, B, C), dy, ds


def test_backward_slices_stay_within_a_group_and_repeat():
    """At least 1 and at most a group's heads, the same answer for the same
    arguments, one wave of CTAs for mamba2-780m's training shape on an
    H100's 132 SMs (4 slices of 12 heads: 128 CTAs), and one head a CTA
    where the CTAs fit the card anyway."""
    for Bz, L, H, G, sms in itertools.product(
            (1, 2, 8), (1, 128, 257, 4096), (1, 6, 48, 64), (1, 2, 3),
            (1, 16, 132, 1000)):
        if H % G:
            continue
        got = t_ops.backward_slices(Bz, L, H, G, sms=sms)
        assert 1 <= got <= H // G, (Bz, L, H, G, sms, got)
        assert got == t_ops.backward_slices(Bz, L, H, G, sms=sms)
    assert t_ops.backward_slices(1, 4096, 48, 1, sms=132) == 4
    assert t_ops.backward_slices(1, 257, 48, 1, sms=1000) == 48
    assert t_ops.backward_slices(1, 0, 4, 1, sms=132) == 1


def test_slice_bounds_cover_the_heads_in_order():
    """Each slice's heads follow the last one's, none is empty, and
    together they are the group's heads, for slice counts that do and do
    not divide them."""
    for hpg in range(1, 50):
        for slices in range(1, hpg + 1):
            b = t_ref.slice_bounds(hpg, slices)
            assert len(b) == slices and b[0][0] == 0 and b[-1][1] == hpg
            assert all(lo < hi for lo, hi in b)
            assert all(b[i][1] == b[i + 1][0] for i in range(slices - 1))


def test_slice_order_matches_head_order_in_float32():
    """float32 arithmetic (no bf16 rounding), each case at several slice
    counts: dx and da do not use the group sum and are equal; dB and dC
    within ORDER_LIMIT of the one-slice (head order) mirror."""
    for case in CASES:
        ins, dy, ds = _inputs(case)
        t = [torch.as_tensor(v) for v in (*ins, dy, ds)]
        want = t_ref.ssd_scan_chunked_backward(*t)
        hpg = case[2] // case[4]
        for slices in sorted({2, 3, 4, hpg} & set(range(1, hpg + 1))):
            got = t_ref.ssd_scan_chunked_backward(*t, slices=slices)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            for name, g, w in zip(("dB", "dC"), got[2:], want[2:]):
                assert _rel(g.numpy(), w.numpy()) <= ORDER_LIMIT, \
                    (case, slices, name)


def test_sliced_mirror_matches_reference_vjp():
    """The mirror with 3 slices against ``jax.vjp`` of the oracle: float32
    within the float32 limit; bf16 x, B, C and dy with the tensor-core
    rounding points within the bf16 limit (each gradient in its input's
    dtype)."""
    case = CASES[0]
    ins, dy, ds = _inputs(case, seed=1)
    x, a, B, C = ins
    _, vjp = jax.vjp(j_ref.ssd_scan, *(jnp.asarray(v) for v in ins))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]
    got = t_ref.ssd_scan_chunked_backward(
        *(torch.as_tensor(v) for v in (*ins, dy, ds)), slices=3)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w) <= F32_LIMIT, name
    bf = [torch.as_tensor(v).bfloat16() for v in (x, B, C, dy)]
    ins = (bf[0].float().numpy(), a, bf[1].float().numpy(),
           bf[2].float().numpy())
    _, vjp = jax.vjp(j_ref.ssd_scan,
                     *(jnp.asarray(v, jnp.bfloat16) if i != 1
                       else jnp.asarray(v) for i, v in enumerate(ins)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(
        (jnp.asarray(bf[3].float().numpy(), jnp.bfloat16),
         jnp.asarray(ds)))]
    got = t_ref.ssd_scan_chunked_backward(
        bf[0], torch.as_tensor(a), bf[1], bf[2], bf[3], torch.as_tensor(ds),
        tensor_core=True, slices=3)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name == "a" else torch.bfloat16)
        assert _rel(g.float().numpy(), w) <= BF16_LIMIT, name


def test_tensor_core_padding_adds_zeros_only():
    """``ops._tc_pad`` pads P and N to multiples of 8 with zeros and keeps
    the values (the kernel's TMA rows); a tensor already padded and aligned
    comes back as it is."""
    x = torch.randn(2, 5, 3, 36)
    got = t_ops._tc_pad(x, 40)
    assert got.shape == (2, 5, 3, 40) and torch.equal(got[..., :36], x)
    assert not got[..., 36:].any() and got.data_ptr() % 16 == 0
    s = torch.randn(1, 2, 3, 36, 100)
    got = t_ops._tc_pad(s, 40, 104)
    assert got.shape == (1, 2, 3, 40, 104)
    assert torch.equal(got[..., :36, :100], s)
    assert not got[..., 36:, :].any() and not got[..., 100:].any()
    y = torch.randn(1, 4, 2, 64)
    assert t_ops._tc_pad(y, 64) is y
