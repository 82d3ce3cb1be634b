"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package's oracle and Pallas kernel.

The same numpy inputs (``tests/test_kernels.py``'s cases and draws) go
through both packages.  The port's plain scan walks the tokens in the
reference oracle's order in float32, so its float32 outputs and the final
state agree to 1e-5 (sums in another order); a bf16 y is the float32 value
rounded once, and agrees to one bf16 ulp (2^-7 relative), since a float32
value a hair from a rounding midpoint can round either way.  Against the
Pallas kernel (run in interpret mode, as the JAX tests run it) the limits
are that test's own: max-abs error over the max-abs of the output, 2e-3 in
float32 and 1e-1 in bf16, since the chunked form sums in another order.
On the CPU the wrapper takes the plain version and launches nothing.

``ref.ssd_scan_chunked`` is the tensor-core kernel's arithmetic on the CPU
(chunks of 128, C B^T once per group, the state pass, the kernel's bf16
rounding points); it is held against the same oracle and Pallas kernel
under the same limits, at the cases above, one prompt shorter than a chunk
and one with G = 2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as j_ops, ref as j_ref
from repro_torch.kernels.ssd_scan import ops as t_ops, ref as t_ref
from _torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


SSD_CASES = [
    # Bsz, L, H, P, G, N, chunk, dtype (tests/test_kernels.py:88-94)
    (2, 256, 4, 64, 1, 128, 64, "float32"),
    (1, 100, 3, 32, 1, 64, 32, "float32"),
    (2, 128, 8, 64, 2, 128, 128, "float32"),
    (1, 512, 4, 64, 1, 128, 128, "bfloat16"),
]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
PALLAS_TOL = {"float32": 2e-3, "bfloat16": 1e-1}
# the chunked mirror's extra cases: below one 128-token chunk, and G = 2
MIRROR_CASES = SSD_CASES + [
    (1, 50, 4, 64, 1, 128, 128, "bfloat16"),
    (1, 300, 4, 32, 2, 64, 128, "bfloat16"),
]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _inputs(case, seed):
    """x, a, B, C as tests/test_kernels.py draws them: jnp arrays of the
    case's dtype, and the same values as torch tensors."""
    Bz, L, H, P, G, N, _, dn = case
    rng = np.random.default_rng(seed)
    dt = getattr(jnp, dn)
    j = (jnp.asarray(rng.standard_normal((Bz, L, H, P)) * 0.5, dt),
         jnp.asarray(rng.uniform(0.7, 0.999, (Bz, L, H)), jnp.float32),
         jnp.asarray(rng.standard_normal((Bz, L, G, N)) * 0.3, dt),
         jnp.asarray(rng.standard_normal((Bz, L, G, N)) * 0.3, dt))
    t = tuple(torch.as_tensor(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dn) if v.dtype == dt else torch.float32) for v in j)
    return j, t


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: f"L{c[1]}-{c[7]}")
def test_plain_scan_matches_reference_oracle(case):
    (jx, ja, jB, jC), (tx, ta, tB, tC) = _inputs(case, 0)
    yr, sr = j_ref.ssd_scan(jx, ja, jB, jC)
    yt, st = t_ref.ssd_scan(tx, ta, tB, tC)
    assert yt.dtype == tx.dtype and st.dtype == torch.float32
    assert tuple(st.shape) == (case[0], case[2], case[3], case[5])
    tol = BF16_ULP_TOL if case[7] == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_f32(yt), _f32(yr), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **F32_TOL)


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: f"L{c[1]}-{c[7]}")
def test_plain_scan_matches_pallas_kernel(case):
    """Against the chunked Pallas kernel in interpret mode (the reference
    wrapper pads L to a chunk multiple; L = 100 takes a ragged chunk)."""
    (jx, ja, jB, jC), (tx, ta, tB, tC) = _inputs(case, 1)
    yk, sk = j_ops.ssd_scan(jx, ja, jB, jC, chunk=case[6], interpret=True)
    yt, st = t_ref.ssd_scan(tx, ta, tB, tC)
    tol = PALLAS_TOL[case[7]]
    yk, sk = _f32(yk), np.asarray(sk)
    assert np.abs(_f32(yt) - yk).max() / (np.abs(yk).max() + 1e-9) < tol
    assert np.abs(st.numpy() - sk).max() / (np.abs(sk).max() + 1e-9) < tol


@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: f"L{c[1]}-G{c[4]}-{c[7]}")
def test_chunked_mirror_matches_reference_oracle(case):
    (jx, ja, jB, jC), (tx, ta, tB, tC) = _inputs(case, 5)
    yr, sr = j_ref.ssd_scan(jx, ja, jB, jC)
    yc, sc = t_ref.ssd_scan_chunked(tx, ta, tB, tC)
    assert yc.dtype == tx.dtype and sc.dtype == torch.float32
    assert tuple(yc.shape) == tuple(tx.shape)
    tol = PALLAS_TOL[case[7]]
    assert _rel(_f32(yc), _f32(yr)) < tol
    assert _rel(sc.numpy(), np.asarray(sr)) < tol


@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: f"L{c[1]}-G{c[4]}-{c[7]}")
def test_chunked_mirror_matches_pallas_kernel(case):
    (jx, ja, jB, jC), (tx, ta, tB, tC) = _inputs(case, 6)
    yk, sk = j_ops.ssd_scan(jx, ja, jB, jC, chunk=case[6], interpret=True)
    yc, sc = t_ref.ssd_scan_chunked(tx, ta, tB, tC)
    tol = PALLAS_TOL[case[7]]
    assert _rel(_f32(yc), _f32(yk)) < tol
    assert _rel(sc.numpy(), np.asarray(sk)) < tol


def test_chunked_mirror_strong_decay_takes_both_decay_forms():
    """Heads of strong decay (a down to 1e-30: a chunk's decay spans more
    than 2^120, so M takes one exponential an entry) beside heads of mild
    decay (the factored form): finite, within the bf16 limit of the plain
    scan, and the float32 mirror within the float32 limit."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.7, 0.999, (1, 300, 4)).astype(np.float32)
    a[:, :, :2] = rng.random((1, 300, 2)) ** 8
    x, B, C = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((1, 300, 4, 64), (1, 300, 2, 128), (1, 300, 2, 128)))
    ta = torch.as_tensor(a)
    ca = torch.log(ta[:, :256].double()).reshape(1, 2, 128, 4).cumsum(2)
    span = (ca[:, :, 0] - ca[:, :, -1]) / np.log(2.0)
    assert bool((span[..., :2] > 120).all() and (span[..., 2:] <= 120).all())
    for dt, tol in ((torch.bfloat16, PALLAS_TOL["bfloat16"]),
                    (torch.float32, PALLAS_TOL["float32"])):
        tx, tB, tC = (torch.as_tensor(v).to(dt) for v in (x, B, C))
        yr, sr = t_ref.ssd_scan(tx, ta, tB, tC)
        yc, sc = t_ref.ssd_scan_chunked(tx, ta, tB, tC)
        assert bool(torch.isfinite(yc.float()).all()
                    and torch.isfinite(sc).all())
        assert _rel(_f32(yc), _f32(yr)) < tol
        assert _rel(sc.numpy(), sr.numpy()) < tol


def test_decode_step_matches_reference_and_scan_tail():
    """The decode-tail case of tests/test_kernels.py:116-130: L-1 tokens
    by the scan, then one decode step, equals the whole scan; and the
    port's decode step equals the reference's on the same state."""
    Bz, L, H, P, G, N = 1, 64, 2, 32, 1, 64
    case = (Bz, L, H, P, G, N, 64, "float32")
    (jx, ja, jB, jC), (tx, ta, tB, tC) = _inputs(case, 2)
    y_full, s_full = t_ref.ssd_scan(tx, ta, tB, tC)
    _, s_head = t_ref.ssd_scan(tx[:, :L - 1], ta[:, :L - 1], tB[:, :L - 1],
                               tC[:, :L - 1])
    s_dec, y_dec = t_ref.ssd_decode_step(s_head, tx[:, L - 1], ta[:, L - 1],
                                         tB[:, L - 1], tC[:, L - 1])
    np.testing.assert_allclose(y_dec.numpy(), y_full[:, L - 1].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_dec.numpy(), s_full.numpy(), rtol=1e-4,
                               atol=1e-4)
    _, js_head = j_ref.ssd_scan(jx[:, :L - 1], ja[:, :L - 1], jB[:, :L - 1],
                                jC[:, :L - 1])
    js_dec, jy_dec = j_ref.ssd_decode_step(js_head, jx[:, L - 1],
                                           ja[:, L - 1], jB[:, L - 1],
                                           jC[:, L - 1])
    ts_dec, ty_dec = t_ref.ssd_decode_step(
        torch.as_tensor(np.array(js_head)), tx[:, L - 1], ta[:, L - 1],
        tB[:, L - 1], tC[:, L - 1])
    np.testing.assert_allclose(ty_dec.numpy(), np.asarray(jy_dec),
                               **F32_TOL)
    np.testing.assert_allclose(ts_dec.numpy(), np.asarray(js_dec),
                               **F32_TOL)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_step_maps_groups_to_heads(G):
    """Head h reads group h * G // H, as the reference, for G = 1, 2, H."""
    rng = np.random.default_rng(3)
    Bz, H, P, N = 2, 4, 8, 16
    vals = (rng.standard_normal((Bz, H, P, N)), rng.standard_normal(
        (Bz, H, P)), rng.uniform(0.5, 1.0, (Bz, H)),
        rng.standard_normal((Bz, G, N)), rng.standard_normal((Bz, G, N)))
    vals = [v.astype(np.float32) for v in vals]
    js, jy = j_ref.ssd_decode_step(*map(jnp.asarray, vals))
    ts, ty = t_ref.ssd_decode_step(*map(torch.as_tensor, vals))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32_TOL)


def test_wrapper_runs_plain_version_on_cpu():
    """A CPU tensor goes to the plain version; nothing is launched."""
    case = SSD_CASES[1]
    _, (tx, ta, tB, tC) = _inputs(case, 4)
    before = t_ops.LAUNCHES
    y, s = t_ops.ssd_scan(tx, ta, tB, tC)
    yr, sr = t_ops.ssd_scan_plain(tx, ta, tB, tC)
    assert t_ops.LAUNCHES == before
    assert torch.equal(y, yr) and torch.equal(s, sr)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 4, 2, 8), device="meta")
    a = torch.zeros((1, 4, 2), device="meta")
    B = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        t_ops.ssd_scan(x, a, B, B)
