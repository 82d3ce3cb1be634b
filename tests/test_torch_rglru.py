"""The port's RG-LRU block (``repro_torch.models.layers.RGLRU``, layer kind
``rglru``) against the JAX package, at the reduced recurrentgemma size
(``get_reduced_config("recurrentgemma-9b")``: 3 layers rglru, rglru,
local; d_model 256, lru_width 256).

The scan mirrors ``jax.lax.associative_scan``'s recursion (pairs, recurse,
fix up the evens), so on the same (a, b) it is bitwise the reference's scan
run op by op.  ``rglru_scan`` also forms sqrt(1 - a^2) gx, where torch's
CPU sqrt and the compiled reference's fused multiply-adds round a few
values the other way: the whole scan agrees with ``jax.jit`` of the
reference to 2e-6 relative plus 1e-6 absolute (|h| stays below about 5).

The block's parameters that ``init_rglru`` sets to zeros or ones (conv
taps and bias, gate biases, Lambda) carry seeded noise (``RGLRU_NOISE``),
so a wrong tap order or gate shows.  float32 block outputs and states
agree to 1e-5 relative plus 5e-5 absolute (float32 GEMMs summed in another
order); bf16 to 1e-2 relative plus one bf16 ulp at the compared tensor's
largest magnitude, as the Mamba2 tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config
from repro.models import layers as JL
from repro_torch.models import layers as TL, transformer as TT
from _torch_parity import (RGLRU_NOISE, assert_serving_matches,
                           jax_and_port_model, port_arch)

SCAN_LENGTHS = [1, 2, 3, 5, 8, 64, 97]
SCAN_TOL = dict(rtol=2e-6, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=5e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype: str, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    tol = F32_TOL
    if dtype == "bfloat16":
        scale = float(np.abs(want).max())
        tol = dict(rtol=1e-2,
                   atol=2.0 ** (np.floor(np.log2(scale)) - 7) if scale else 0)
    np.testing.assert_allclose(got, want, **tol, err_msg=msg)


def _scan_inputs(S: int):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 0.999, (2, S, 16)).astype(np.float32)
    gx = rng.standard_normal((2, S, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    return a, gx, h0


@pytest.mark.parametrize("S", SCAN_LENGTHS)
def test_associative_scan_is_the_reference_recursion(S):
    """The port's recursion on (a, b) equals ``jax.lax.associative_scan``
    with the RG-LRU combine, run op by op, bit for bit: the same pairs
    combine in the same order (odd and even lengths at every level)."""
    a, b, _ = _scan_inputs(S)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]
    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = TL._associative_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", SCAN_LENGTHS)
def test_rglru_scan_matches_reference(S, with_h0):
    """``rglru_scan`` against the compiled reference, with and without an
    initial state (the port counterpart of tests/test_layers_properties.py
    :109 and :126): every h_t and the last state within SCAN_TOL."""
    a, gx, h0 = _scan_inputs(S)
    h0 = h0 if with_h0 else None
    jh, jlast = jax.jit(JL.rglru_scan)(jnp.asarray(a), jnp.asarray(gx),
                                       None if h0 is None else
                                       jnp.asarray(h0))
    th, tlast = TL.rglru_scan(torch.as_tensor(a), torch.as_tensor(gx),
                              None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **SCAN_TOL)
    assert float(np.abs(np.asarray(jh)).max()) < 5.0


def test_rglru_scan_with_initial_state_closed_form():
    """h_1 = a h0 + sqrt(1 - a^2) gx at a = 0.9, gx = 1, h0 = 3, as the
    reference's own test (tests/test_layers_properties.py:126)."""
    a = torch.full((1, 5, 4), 0.9)
    h, _ = TL.rglru_scan(a, torch.ones((1, 5, 4)), 3.0 * torch.ones((1, 4)))
    np.testing.assert_allclose(h[:, 0].numpy(), 0.9 * 3.0 + np.sqrt(0.19),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_reference(dtype):
    """One RG-LRU mixer with noisy conv, gate and decay parameters: a
    37-token prefill from no state, then three decode steps from the
    prefill's state with the conv state held in a float32 cache (as the
    engine keeps it); out, conv state and h at every call."""
    cfg = get_reduced_config("recurrentgemma-9b", dtype=dtype)
    params, model = jax_and_port_model(cfg, 0, rglru_seed=1)
    p = jax.tree.map(lambda v: v[0], params["blocks"]["pos1"]["mixer"])
    mix = model.blocks[1].mixer
    assert isinstance(mix, TL.RGLRU)
    rng = np.random.default_rng(2)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    x = jnp.asarray(rng.standard_normal((2, 37, cfg.d_model)), jd)
    y, (conv, h) = jax.jit(lambda p, x: JL.rglru_block(p, x, cfg))(p, x)
    W = cfg.lru_width
    cache = (torch.zeros((2, 3, W)), torch.zeros((2, W)))
    got = mix.prefill(torch.as_tensor(_np(x).copy()).to(td), cache)
    assert got.dtype == td
    _assert_close(got, y, dtype, "prefill out")
    _assert_close(cache[0], conv, dtype, "prefill conv")
    _assert_close(cache[1], h, dtype, "prefill h")
    step = jax.jit(lambda p, x, c, s: JL.rglru_block(p, x, cfg, (c, s)))
    conv = conv.astype(jnp.float32)
    for i in range(3):
        x1 = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jd)
        y1, (conv, h) = step(p, x1, conv, h)
        conv = conv.astype(jnp.float32)
        got1 = mix.decode(torch.as_tensor(_np(x1).copy()).to(td), cache)
        _assert_close(got1, y1, dtype, f"decode {i} out")
        _assert_close(cache[0], conv, dtype, f"decode {i} conv")
        _assert_close(cache[1], h, dtype, f"decode {i} h")


def test_init_cache_and_weights_follow_the_reference():
    """``init_cache`` for an ``rglru`` layer: conv [B, 3, W] in the cache
    dtype, h [B, W] float32, W = lru_width; a local layer's k / v beside
    it.  ``init_model`` at bf16: wx, wy, wo in bf16; wa, wi float32 (the
    reference uses them as float32); conv, gate biases and Lambda float32
    at their init values (zeros, Lambda ones)."""
    cfg = get_reduced_config("recurrentgemma-9b", dtype="bfloat16")
    assert cfg.layer_kinds() == ["rglru", "rglru", "local"]
    cache = TT.init_cache(port_arch(cfg), 3, 100, torch.bfloat16,
                          device="cpu")
    conv, h = cache[0]
    assert conv.shape == (3, 3, 256) and conv.dtype == torch.bfloat16
    assert h.shape == (3, 256) and h.dtype == torch.float32
    assert cache[2][0].shape == (3, 64, 1, 64)
    model = TT.init_model(0, port_arch(cfg), device="cpu")
    mix = model.blocks[0].mixer
    for name in ("wx", "wy", "wo"):
        assert getattr(mix, name).dtype == torch.bfloat16, name
    for name in ("wa", "wi"):
        t = getattr(mix, name)
        assert t.dtype == torch.float32 and t.shape == (256, 256), name
    for name in RGLRU_NOISE:
        t = getattr(mix, name)
        want = 1.0 if name == "lam" else 0.0
        assert t.dtype == torch.float32 and bool((t == want).all()), name
    assert mix.conv_w.shape == (4, 256)


def test_engine_and_scheduler_match_reference():
    """Reduced recurrentgemma (noisy RG-LRU parameters) through both
    packages' ``ServingEngine`` + ``ArcusScheduler`` (the bucket kernel's
    route): ``admit`` zeroes an ``rglru`` slot's (conv, h) before its
    prefill; logits at every call, tokens, statistics and caches
    (``assert_serving_matches``)."""
    cfg = get_reduced_config("recurrentgemma-9b")
    params, model = jax_and_port_model(cfg, 0, rglru_seed=10)
    assert_serving_matches(cfg, params, model, "recurrentgemma-9b")
