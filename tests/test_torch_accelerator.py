"""Port parity: float32 grid interpolation of ``repro_torch`` against the
JAX package, bitwise, over every integer message size 1..2^20 (plus sizes
above, where the grid clips) and every catalogue accelerator."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro_torch.core import accelerator as tacc
from _torch_parity import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


SIZES = np.concatenate([np.arange(1, 2**20 + 1),
                        [2**20 + 1, 2**20 + 4097, 3_000_000, 2**31 - 1]]
                       ).astype(np.float32)
ACCELS = list(jacc.CATALOG)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_log2_matches_jnp_log2_everywhere():
    """``jnp.log2`` is XLA's float32 log polynomial times 1/ln 2; neither
    torch.log2 nor torch.log reproduces it, the port's expansion does."""
    got = tacc.log2(torch.as_tensor(SIZES)).numpy()
    want = np.asarray(jax.jit(jnp.log2)(SIZES))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    eager = np.asarray(jnp.log2(jnp.asarray(SIZES)))
    np.testing.assert_array_equal(_bits(got), _bits(eager))


@pytest.fixture(scope="module")
def tables():
    jt = jacc.AccelTable.build([jacc.CATALOG[n] for n in ACCELS])
    tt = tacc.AccelTable.build([tacc.CATALOG[n] for n in ACCELS])
    return jt, tt


def test_accel_tables_match_reference(tables):
    jt, tt = tables
    assert jt.names == tt.names
    np.testing.assert_array_equal(jt.service_cycles, tt.service_cycles)
    np.testing.assert_array_equal(jt.egress_bytes, tt.egress_bytes)
    np.testing.assert_array_equal(jt.parallelism, tt.parallelism)
    np.testing.assert_array_equal(jacc.size_grid(), tacc.size_grid())


@pytest.mark.parametrize("name", ACCELS)
def test_interp_grid_matches_compiled_reference(tables, name):
    """The engine calls ``interp_grid`` inside its compiled tick, where XLA
    fuses part of it; the port reproduces that compiled form."""
    jt, tt = tables
    a = ACCELS.index(name)
    f = jax.jit(jacc.interp_grid)
    m = torch.as_tensor(SIZES)
    for jtab, ttab in ((jt.service_cycles, tt.service_cycles),
                       (jt.egress_bytes, tt.egress_bytes)):
        want = np.asarray(f(jnp.asarray(jtab), jnp.int32(a),
                            jnp.asarray(SIZES)))
        got = tacc.interp_grid(torch.as_tensor(ttab), a, m).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_grid_position_table_is_grid_position():
    """The per-device table the engine indexes equals the elementwise
    function on every size, including the clipped sizes above 2^20."""
    i0_tab, frac_tab = tacc.grid_position_table("cpu")
    m = torch.as_tensor(SIZES)
    i0, frac = tacc.grid_position(m)
    idx = torch.clamp(m.long(), 0, tacc.GRID_TAB_MAX)
    np.testing.assert_array_equal(i0_tab[idx].numpy(), i0.long().numpy())
    np.testing.assert_array_equal(_bits(frac_tab[idx].numpy()),
                                  _bits(frac.numpy()))
    # size 0 (an empty queue slot) reads as size 1, as max(m, 1) does
    assert int(i0_tab[0]) == int(i0_tab[1])


def _fma_exact(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once, to nearest even, from exact
    rational arithmetic."""
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(q))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda x: (abs(Fraction(float(x)) - q),
                                    int(np.float32(x).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``fma32`` is the correctly rounded fused multiply-add, also where a
    float64 sum rounded again to float32 is not: exact values a hair off a
    float32 midpoint, which the float64 sum rounds onto the midpoint."""
    rng = np.random.default_rng(0)
    a, b, c = [], [], []
    for k in range(15, 24):                  # (1+2^-k)(1-2^-k) = 1 - 2^-2k
        for sign in (1.0, -1.0):
            for e in (-20, 0, 11):
                odd = np.float32((1 + 2.0**-23 * (2 * rng.integers(0, 2**21)
                                                  + 1)) * 2.0**e)
                a.append(np.float32(1 + 2.0**-k))
                b.append(np.float32(sign * (1 - 2.0**-k) * 2.0**(e - 24)))
                c.append(odd)
    n_hard = len(a)
    rand = lambda m: (rng.standard_normal(m)                 # noqa: E731
                      * 2.0 ** rng.integers(-30, 30, m)).astype(np.float32)
    a, b, c = (np.concatenate([np.asarray(x, np.float32), rand(3000)])
               for x in (a, b, c))
    want = np.array([_fma_exact(*x) for x in zip(a, b, c)], np.float32)
    got = tacc.fma32(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (_bits(twice[:n_hard]) != _bits(want[:n_hard])).all()
