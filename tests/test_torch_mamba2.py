"""The port's Mamba2 model (``repro_torch.models``, layer kind ``ssd``)
against the JAX package, at reduced size (``get_reduced_config
("mamba2-780m")``: 2 layers, d_model 256, H 16 heads of P 32, G 1, N 64).

The reduced config keeps ``reduced()``'s MLP (d_ff 512); the full config
has none (d_ff 0), and the ``no-ffn`` cases run that layout.  The reference
initialises the weights, with seeded numpy noise on the
parameters ``init_mamba2`` sets to zeros or ones (conv taps and bias,
``a_log``, ``dt_bias``, ``d_skip``, ``norm_scale``), so the conv, the decay,
the skip and the norm scale all act; ``convert.params_from_jax`` loads the
same numpy tree into the port.  On the CPU the port's prefill runs the SSD
scan's plain version (the sequential recurrence the reference's serving
prefill runs too).

Tolerances.  float32: sums run in another order (the in-projection, the
scan, the norm), so block outputs, logits and caches agree to 1e-5
relative plus 5e-5 absolute (logits: 1e-4, as the dense models' tests).
bf16 (the full-width dtype): a few values round the other way upstream
(bf16 products summed in another order), so outputs, logits and conv
states agree to 1e-2 relative plus one bf16 ulp at the largest magnitude of
the compared tensor; the float32 SSD state sums those bf16 inputs and is
held to the same.  Tokens and the scheduler's statistics are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.models import convert, layers as TL, transformer as TT
from _torch_parity import (jax_and_port_model, one_torch_thread, port_arch,
                           run_serving, serving_mix)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


F32_TOL = dict(rtol=1e-5, atol=5e-5)
LOGIT_F32_TOL = dict(rtol=1e-5, atol=1e-4)
B, PROMPT, MAX_LEN, STEPS = 2, 80, 128, 10


def _cfg(dtype="float32", ffn=True):
    cfg = get_reduced_config("mamba2-780m", dtype=dtype)
    return cfg if ffn else dataclasses.replace(cfg, d_ff=0)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, dtype: str, tol=None, msg=""):
    """float32: ``tol`` (default F32_TOL); bf16: 1e-2 relative plus one
    bf16 ulp at the largest magnitude of ``want``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if dtype == "bfloat16":
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0
        tol = dict(rtol=1e-2, atol=ulp)
    np.testing.assert_allclose(got, want, **(tol or F32_TOL), err_msg=msg)


def _to_torch(x, dtype: str) -> torch.Tensor:
    return torch.as_tensor(_np(x).copy()).to(getattr(torch, dtype))


def test_config_is_the_reduced_mamba2():
    cfg = _cfg()
    Din, H, G, N = TL.mamba2_split(port_arch(cfg))
    assert (cfg.n_layers, cfg.d_model, H, cfg.ssm_head_dim, G, N, cfg.d_ff) \
        == (2, 256, 16, 32, 1, 64, 512)
    assert Din == 512 and cfg.layer_kinds() == ["ssd", "ssd"]


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    """bf16 activations under float32 taps (the bf16-rounded ``conv_w`` plus
    the exact identity tap): the products promote to float32 and the taps
    are summed in the reference's order before the cast back, bit for bit
    with the reference run op by op; the new state is the last K-1 inputs."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 9, 48)), jnp.bfloat16)
    p = {"conv_w": jnp.asarray(0.3 * rng.standard_normal((4, 48)),
                               jnp.float32)}
    w = p["conv_w"].astype(jnp.bfloat16) + JL._conv_id_wide(p)
    b = jnp.asarray(0.1 * rng.standard_normal(48), jnp.bfloat16)
    state = jnp.asarray(rng.standard_normal((2, 3, 48)), jnp.float32) \
        if with_state else None
    want, want_state = JL._causal_conv1d(x, w, b, state)
    assert w.dtype == jnp.float32
    got, got_state = TL.causal_conv1d(
        _to_torch(x, "bfloat16"), _to_torch(w, "float32"),
        _to_torch(b, "bfloat16"),
        None if state is None else _to_torch(state, "float32"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_state), _np(want_state))


def test_silu_matches_xla_bitwise_on_every_bf16():
    """``jax.nn.silu`` on bf16 rounds after every step of
    x * (1 / (1 + exp(-x))); the port's ``silu`` does the same, so it agrees
    on every finite bf16 value whose intermediate values and result are
    normal numbers: |x| >= 2^-124 and x > -87 (below, 1 / (1 + exp(-x)) is
    subnormal; XLA on the CPU flushes subnormals to zero, torch keeps
    them).  In float32 within 1e-6 relative (the two libraries' exp)."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) >= 2.0 ** -124) & (x > -87)]
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(x, jnp.bfloat16))
                      .astype(jnp.float32))
    got = TL.silu(torch.as_tensor(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
    xf = np.random.default_rng(1).standard_normal(10_000).astype(np.float32)
    np.testing.assert_allclose(TL.silu(torch.as_tensor(xf * 8)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(xf * 8))),
                               rtol=1e-6, atol=1e-7)


def test_softplus_is_logaddexp_without_threshold():
    """``jax.nn.softplus`` = logaddexp(x, 0), within 1e-6 relative on
    [-60, 60], including the range where ``F.softplus`` would switch to x."""
    x = np.linspace(-60, 60, 20_001).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = TL.softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype):
    """One Mamba2 mixer: a 37-token prefill from no state, then one decode
    step from the prefill's state with the conv state held in a float32
    cache (as the engine keeps it); out, conv state and SSD state."""
    cfg = _cfg(dtype)
    params, model = jax_and_port_model(cfg, 0, ssd_seed=1)
    p = jax.tree.map(lambda v: v[1], params["blocks"]["pos0"]["mixer"])
    mix = model.blocks[1].mixer
    rng = np.random.default_rng(2)
    jd = getattr(jnp, dtype)
    x = jnp.asarray(rng.standard_normal((2, 37, cfg.d_model)), jd)
    y, (conv, state) = jax.jit(lambda p, x: JL.mamba2_block(p, x, cfg))(p, x)
    t_conv = torch.zeros((2, cfg.conv_kernel - 1, conv.shape[-1]))
    t_state = torch.zeros(tuple(state.shape))
    got = mix.prefill(_to_torch(x, dtype), (t_conv, t_state))
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, y, dtype, msg="prefill out")
    _assert_close(t_conv, conv, dtype, msg="prefill conv")
    _assert_close(t_state, state, dtype, msg="prefill state")

    x1 = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jd)
    y1, (conv1, state1) = jax.jit(
        lambda p, x, c, s: JL.mamba2_block(p, x, cfg, (c, s)))(
        p, x1, conv.astype(jnp.float32), state)
    got1 = mix.decode(_to_torch(x1, dtype), (t_conv, t_state))
    _assert_close(got1, y1, dtype, msg="decode out")
    _assert_close(t_conv, conv1, dtype, msg="decode conv")
    _assert_close(t_state, state1, dtype, msg="decode state")


def _assert_cache(j_cache, t_cache, cfg, msg=""):
    ref = convert.cache_from_jax(jax.tree.map(np.asarray, j_cache),
                                 port_arch(cfg))
    assert len(ref) == len(t_cache) == cfg.n_layers
    for li, ((rc, rs), (tc, ts)) in enumerate(zip(ref, t_cache)):
        assert rs.dtype == ts.dtype == torch.float32
        assert rc.shape == tc.shape and rs.shape == ts.shape
        _assert_close(tc, rc, cfg.dtype, msg=f"{msg} layer {li} conv")
        _assert_close(ts, rs, cfg.dtype, msg=f"{msg} layer {li} state")


@pytest.mark.parametrize("dtype,ffn", [("float32", True), ("bfloat16", True),
                                       ("float32", False),
                                       ("bfloat16", False)],
                         ids=["float32", "bfloat16", "float32-no-ffn",
                              "bfloat16-no-ffn"])
def test_prefill_and_decode_match_reference(dtype, ffn):
    """Prefill logits and caches, then STEPS decode steps: logits and greedy
    tokens at every step, and the final caches."""
    cfg = _cfg(dtype, ffn)
    params, model = jax_and_port_model(cfg, 0, ssd_seed=3)
    logit_tol = LOGIT_F32_TOL if dtype == "float32" else None
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    j_cache = JT.init_cache(cfg, B, MAX_LEN, jnp.float32)
    j_logits, j_cache, _ = jax.jit(
        lambda p, t, c: JT.prefill(p, cfg, t, c))(params, jnp.asarray(toks),
                                                  j_cache)
    t_cache = TT.init_cache(model.cfg, B, MAX_LEN, torch.float32,
                            device="cpu")
    t_logits, t_len = TT.prefill(model, torch.as_tensor(toks).long(),
                                 t_cache)
    assert t_logits.dtype == getattr(torch, dtype)
    assert t_len.tolist() == [PROMPT] * B
    _assert_close(t_logits, j_logits, dtype, logit_tol, "prefill logits")
    _assert_cache(j_cache, t_cache, cfg, "prefill")

    dec = jax.jit(lambda p, t, ln, c: JT.decode_step(p, cfg, t, ln, c))
    lengths = np.array([PROMPT, PROMPT - 23], np.int32)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    for step in range(STEPS):
        j_logits, j_cache = dec(params, jnp.asarray(tok[:, None]),
                                jnp.asarray(lengths), j_cache)
        t_logits = TT.decode_step(model, torch.as_tensor(tok[:, None]).long(),
                                  torch.as_tensor(lengths), t_cache)
        _assert_close(t_logits, j_logits, dtype, logit_tol, f"step {step}")
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        assert t_logits.argmax(-1).tolist() == tok.tolist(), step
        lengths += 1
    _assert_cache(j_cache, t_cache, cfg, "decode")


def test_cache_from_jax_resumes_decode():
    """A reference cache carried across, (conv, state) per ``ssd`` layer,
    resumes decoding in the port."""
    cfg = _cfg()
    params, model = jax_and_port_model(cfg, 2, ssd_seed=4)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, 70)).astype(np.int32)
    cache = JT.init_cache(cfg, 1, MAX_LEN, jnp.float32)
    _, cache, _ = JT.prefill(params, cfg, jnp.asarray(toks), cache)
    t_cache = convert.cache_from_jax(jax.tree.map(np.asarray, cache),
                                     model.cfg)
    assert [tuple(t.shape) for t in t_cache[0]] == [(1, 3, 640),
                                                    (1, 16, 32, 64)]
    dec = jax.jit(lambda p, t, ln, c: JT.decode_step(p, cfg, t, ln, c))
    lengths = np.array([70], np.int32)
    for step in range(3):
        tok = np.array([[5 + step]], np.int32)
        j_logits, cache = dec(params, jnp.asarray(tok), jnp.asarray(lengths),
                              cache)
        t_logits = TT.decode_step(model, torch.as_tensor(tok).long(),
                                  torch.as_tensor(lengths), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_F32_TOL)
        lengths += 1


def test_init_cache_and_weights_follow_the_reference():
    """``init_cache``: conv [B, K-1, Din + 2GN] in the cache dtype, state
    [B, H, P, N] float32.  ``init_model`` at bf16: projections in bf16, the
    conv, decay, skip and norm parameters float32 at their init values; no
    RoPE tables for a model without attention; no MLP at d_ff 0."""
    cfg = _cfg("bfloat16", ffn=False)
    cache = TT.init_cache(cfg, 3, 64, torch.bfloat16, device="cpu")
    assert len(cache) == 2
    conv, state = cache[0]
    assert conv.shape == (3, 3, 640) and conv.dtype == torch.bfloat16
    assert state.shape == (3, 16, 32, 64) and state.dtype == torch.float32
    model = TT.init_model(0, cfg, device="cpu")
    mix = model.blocks[0].mixer
    assert mix.in_proj.shape == (256, 2 * 512 + 2 * 64 + 16)
    assert mix.in_proj.dtype == mix.out_proj.dtype == torch.bfloat16
    for name, value in (("conv_w", 0.0), ("conv_b", 0.0), ("a_log", 0.0),
                        ("dt_bias", 0.0), ("d_skip", 1.0),
                        ("norm_scale", 1.0)):
        t = getattr(mix, name)
        assert t.dtype == torch.float32 and bool((t == value).all()), name
    assert not model.blocks[0].has_ffn
    assert not hasattr(model.blocks[0], "ffn")
    assert model._tables(torch.arange(4)[None, :]) is None


def test_engine_and_scheduler_match_reference():
    """``ServingEngine`` + ``ArcusScheduler`` (bucket kernel route) on the
    same requests: logits of every prefill and decode call, tokens, the
    scheduler's statistics and clock bit for bit, the engine's lengths and
    its final caches."""
    cfg = _cfg()
    params, model = jax_and_port_model(cfg, 0, ssd_seed=5)
    mix = serving_mix(cfg.vocab)
    j_sched, j_reqs, j_logits = run_serving("jax", cfg, params, mix, True,
                                            True, "mamba2-780m", 1000)
    t_sched, t_reqs, t_logits = run_serving("torch", cfg, model, mix, True,
                                            True, "mamba2-780m", 1000)
    assert [k for k, _ in t_logits] == [k for k, _ in j_logits]
    assert sum(k == "decode" for k, _ in j_logits) >= 8
    for i, ((kind, a), (_, b)) in enumerate(zip(j_logits, t_logits)):
        np.testing.assert_allclose(b, a, **LOGIT_F32_TOL,
                                   err_msg=f"{kind} call {i}")
    assert [r.generated for r in t_reqs] == [r.generated for r in j_reqs]
    assert all(r.done for r in j_reqs)
    for tid, st in j_sched.stats.items():
        assert dataclasses.asdict(t_sched.stats[tid]) == \
            dataclasses.asdict(st), tid
    assert t_sched.now_s == j_sched.now_s
    np.testing.assert_array_equal(t_sched.engine.lengths,
                                  j_sched.engine.lengths)
    _assert_cache(j_sched.engine.cache, t_sched.engine.cache, cfg, "engine")
