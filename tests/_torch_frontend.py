"""Shared parity checks of the port's cross-attention and encoder-decoder
families against the JAX package (``tests/test_torch_cross.py``,
``tests/test_torch_encoder.py``).

``reference_run(arch)`` initialises the reduced config once (the reference's
weights, with ``CROSS_NOISE`` on the zero / one gate, bias and norm
parameters so the cross path acts), loads them into the port and runs the
reference's jitted prefill and three decode steps, keeping every result as
numpy; each test file shares one such run through a module-scoped fixture.
The checks hold the port against it in float32 within
``tests/test_torch_model.py``'s ``TOL``: logits to 1e-4, cache entries to
2e-5 (sums in another order).
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
from repro_torch.models import convert, transformer as TT
from _torch_parity import jax_and_port_model, port_arch

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=2e-5)
ACT_TOL = dict(rtol=1e-5, atol=2e-5)
B, PROMPT, MAX_LEN, STEPS = 2, 20, 48, 3


@dataclasses.dataclass
class Run:
    """The reference's run of one reduced arch, and the port's model."""
    cfg: object
    params: dict            # the reference's (jnp) parameters
    model: object           # the port's CPU model holding them
    tokens: np.ndarray      # [B, PROMPT] int32
    frontend: np.ndarray    # [B, F, frontend_dim] float32
    lengths: list           # [B] lengths before each decode step
    feeds: list             # [B, 1] tokens fed at each decode step
    logits: list            # prefill's, then each step's logits
    caches: list            # prefill's, then each step's cache (numpy)


def reference_run(arch: str, seed: int = 0) -> Run:
    cfg = get_reduced_config(arch)
    params, model = jax_and_port_model(cfg, seed, cross_seed=seed + 5)
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    fe = rng.standard_normal(
        (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    cache = JT.init_cache(cfg, B, MAX_LEN, jnp.float32)
    logits, cache, _ = jax.jit(
        lambda p, t, c, f: JT.prefill(p, cfg, t, c, f))(
            params, jnp.asarray(toks), cache, jnp.asarray(fe))
    run = Run(cfg, params, model, toks, fe, [], [], [np.asarray(logits)],
              [jax.tree.map(np.asarray, cache)])
    dec = jax.jit(lambda p, t, ln, c: JT.decode_step(p, cfg, t, ln, c))
    # rows at different lengths write different slots
    lengths = np.array([PROMPT, PROMPT - 7], np.int32)
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
        run.lengths.append(lengths.copy())
        run.feeds.append(tok)
        logits, cache = dec(params, jnp.asarray(tok), jnp.asarray(lengths),
                            cache)
        run.logits.append(np.asarray(logits))
        run.caches.append(jax.tree.map(np.asarray, cache))
        lengths += 1
    return run


def assert_cache(ref_np: dict, cache, cfg, what: str = "") -> None:
    """Every tensor of the port's ``cache`` (memory caches included)
    within CACHE_TOL of the reference's cache ``ref_np``."""
    ref = convert.cache_from_jax(ref_np, port_arch(cfg))
    assert len(ref) == len(cache) == cfg.n_layers
    for li, (r, t) in enumerate(zip(ref, cache)):
        assert len(r) == len(t), (li, len(r), len(t))
        for n, (a, b) in enumerate(zip(r, t)):
            assert a.shape == b.shape, (what, li, n, a.shape, b.shape)
            np.testing.assert_allclose(b.numpy(), a.float().numpy(),
                                       **CACHE_TOL,
                                       err_msg=f"{what} layer {li} entry {n}")


def check_prefill_and_decode(run: Run) -> None:
    """Prefill (frontend projected, encoded where the arch has an encoder)
    and three decode steps: logits and every cache tensor, the memory's
    K/V included, against the reference's."""
    model = run.model
    cache = TT.init_cache(model.cfg, B, MAX_LEN, torch.float32, device="cpu")
    logits, lengths = TT.prefill(model, torch.as_tensor(run.tokens).long(),
                                 cache, torch.as_tensor(run.frontend))
    assert lengths.tolist() == [PROMPT] * B
    np.testing.assert_allclose(logits.numpy(), run.logits[0], **LOGIT_TOL)
    assert_cache(run.caches[0], cache, run.cfg, "prefill")
    for step, (tok, ln) in enumerate(zip(run.feeds, run.lengths)):
        logits = TT.decode_step(model, torch.as_tensor(tok).long(),
                                torch.as_tensor(ln), cache)
        np.testing.assert_allclose(logits.numpy(), run.logits[step + 1],
                                   **LOGIT_TOL, err_msg=f"step {step}")
        assert_cache(run.caches[step + 1], cache, run.cfg, f"step {step}")


def check_resume(run: Run) -> None:
    """The reference's cache after prefill, carried across with
    ``cache_from_jax``, resumes decoding in the port."""
    cache = convert.cache_from_jax(run.caches[0], run.model.cfg)
    for step, (tok, ln) in enumerate(zip(run.feeds, run.lengths)):
        logits = TT.decode_step(run.model, torch.as_tensor(tok).long(),
                                torch.as_tensor(ln), cache)
        np.testing.assert_allclose(logits.numpy(), run.logits[step + 1],
                                   **LOGIT_TOL, err_msg=f"step {step}")


def check_frontend_kv(run: Run):
    """``frontend_kv`` against ``_frontend_kv``; returns both."""
    want = np.asarray(JT._frontend_kv(run.params, run.cfg,
                                      jnp.asarray(run.frontend)))
    got = run.model.frontend_kv(torch.as_tensor(run.frontend))
    np.testing.assert_allclose(got.numpy(), want, **ACT_TOL)
    return got, want


def check_attention(run: Run, port_attn, ref_p: dict, kind: str,
                    memory=None) -> None:
    """``Attention.block`` of ``kind`` (``cross`` against ``memory``
    [B, F, E], or ``encoder``) against ``JL.attention_block``, and the K/V
    it returns against the reference's projections (rotated for
    ``encoder``)."""
    cfg = run.cfg
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    S = x.shape[1] if memory is None else memory.shape[1]
    pos = jnp.arange(S)[None, :]
    mem = None if memory is None else jnp.asarray(memory)
    want = JL.attention_block(ref_p, jnp.asarray(x), cfg, kind,
                              positions=pos, frontend_kv=mem)
    _, wk, wv = JL.attention_qkv(ref_p, jnp.asarray(x), cfg, kv_src=mem)
    tables = None
    if kind == "encoder":
        wk = JL.rope(wk, pos, theta=cfg.rope_theta,
                     fraction=cfg.rope_fraction)
        tables = run.model._tables(torch.arange(S)[None, :])
    got, k, v = port_attn.block(
        torch.as_tensor(x), kind, tables,
        memory=None if memory is None else torch.as_tensor(np.array(memory)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), **ACT_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), **ACT_TOL)


def check_engine(run: Run) -> None:
    """The reference's ``ServingEngine.admit(req, frontend)`` + ``step()``
    and the port's on the same two requests (each with its own frontend,
    the second admitted after the first has decoded twice): equal tokens,
    the logits of every call within LOGIT_TOL and the final caches within
    CACHE_TOL."""
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.request import Request as JRequest
    from repro_torch.serving.engine import ServingEngine as TEngine
    from repro_torch.serving.request import Request as TRequest
    cfg = run.cfg
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 12).tolist() for _ in range(2)]
    fes = [run.frontend[i:i + 1] for i in range(2)]

    def serve(engine, request, frontend, record):
        dec, pre = engine._decode, engine._prefill

        def rec_dec(*a):
            out = dec(*a)
            record.append(np.asarray(out[0] if isinstance(out, tuple)
                                     else out, np.float32))
            return out

        def rec_pre(*a):
            out = pre(*a)
            record.append(np.asarray(out[0], np.float32))
            return out
        engine._decode, engine._prefill = rec_dec, rec_pre
        reqs = [request(i, 0, p, 5) for i, p in enumerate(prompts)]
        engine.admit(reqs[0], frontend(fes[0]))
        engine.step()
        engine.step()
        engine.admit(reqs[1], frontend(fes[1]))
        while engine.active_count:
            engine.step()
        return [r.generated for r in reqs]
    j_rec, t_rec = [], []
    j_eng = JEngine(cfg, run.params, max_batch=2, max_len=MAX_LEN)
    t_eng = TEngine(run.model.cfg, run.model, max_batch=2, max_len=MAX_LEN,
                    device="cpu")
    want = serve(j_eng, JRequest, jnp.asarray, j_rec)
    got = serve(t_eng, TRequest, torch.as_tensor, t_rec)
    assert got == want
    assert len(t_rec) == len(j_rec) >= 8
    for i, (a, b) in enumerate(zip(j_rec, t_rec)):
        np.testing.assert_allclose(b, a, **LOGIT_TOL, err_msg=f"call {i}")
    np.testing.assert_array_equal(t_eng.lengths, j_eng.lengths)
    assert_cache(jax.tree.map(np.asarray, j_eng.cache), t_eng.cache, cfg,
                 "engine")


def check_prefill_needs_frontend(run: Run) -> None:
    """Without frontend embeddings the port's prefill and ``admit`` raise
    (the reference fails there for every prompt whose length is not F);
    a frontend of the wrong length raises too."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    model = run.model
    cache = TT.init_cache(model.cfg, 1, MAX_LEN, torch.float32, device="cpu")
    toks = torch.as_tensor(run.tokens[:1]).long()
    with pytest.raises(ValueError, match="frontend"):
        TT.prefill(model, toks, cache)
    with pytest.raises(ValueError, match="frontend"):
        TT.prefill(model, toks, cache,
                   torch.as_tensor(run.frontend[:1, :-1]))
    eng = ServingEngine(model.cfg, model, max_batch=1, max_len=MAX_LEN,
                        device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        eng.admit(Request(0, 0, run.tokens[0].tolist(), 2))
