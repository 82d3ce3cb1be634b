"""The port's MoE feed-forward (``repro_torch.models.layers.MoE``) against
the JAX package's ``moe_block(dropless=True)`` (the serving form: sorted
dispatch through ``ragged_dot``), at the reduced mixtral size (d_model 256,
d_ff 512) with 4 or 8 experts and top-k 1 or 2.

Both of the port's dispatch forms run on the same inputs: ``grouped``
(prefill: expert-sorted rows, one matmul each) and ``all_experts``
(decode: every expert on every token, the unrouted outputs dropped).  The
routing is held exactly: the port's expert indices equal ``lax.top_k`` of
the reference's router probabilities, including its tie order (the lower
expert first).  Outputs: float32 within 1e-5 relative plus 1e-4 of the
output's largest magnitude (two chained matmuls of 256 and 512 terms,
summed in another order, with outputs in the hundreds: single values
cancel down to a few units); bf16 within 1e-2 relative plus one bf16 ulp at
that magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config
from repro.models import layers as JL
from repro.models import module as jnn
from repro_torch.models import convert, layers as TL
from _torch_parity import assert_serving_matches, jax_and_port_model, \
    port_arch

#: T tokens as the [B, S] the engine passes: one token, a decode step of
#: eight slots, a two-sequence prefill
TOKEN_SHAPES = {1: (1, 1), 8: (8, 1), 96: (2, 48)}


def _cfg(n_experts=4, top_k=2, dtype="float32"):
    return get_reduced_config("mixtral-8x22b", n_experts=n_experts,
                              top_k=top_k, dtype=dtype)


def _moe(cfg, seed=0, router=None):
    """The reference's ``init_moe`` parameters (``router`` replaced when
    given) and a port ``MoE`` holding the same values."""
    p, _ = JL.init_moe(jnn.KeyGen(seed), cfg)
    p = jax.tree.map(np.asarray, p)
    if router is not None:
        p["router"] = np.asarray(router, np.float32)
    moe = TL.MoE(port_arch(cfg), TL.Maker(None, "cpu"))
    for name, value in p.items():
        convert._load(getattr(moe, name), value)
    return jax.tree.map(jnp.asarray, p), moe


def _reference(p, x, cfg):
    """(output, expert indices [T, K]) of the compiled reference."""
    y, probs = jax.jit(lambda p, x: JL.moe_block(p, x, cfg,
                                                 dropless=True))(p, x)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(y.astype(jnp.float32)), np.asarray(idx)


def _check(p, moe, x, cfg):
    """Both port forms against the reference on x (numpy [B, S, E]):
    routing equal, outputs within the stated tolerance.  Returns the
    reference's expert indices."""
    jd = getattr(jnp, cfg.dtype)
    td = getattr(torch, cfg.dtype)
    want, idx = _reference(p, jnp.asarray(x, jd), cfg)
    tx = torch.as_tensor(np.array(jnp.asarray(x, jd).astype(jnp.float32))
                         ).to(td)
    _, got_idx = moe.route(tx.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    scale = float(np.abs(want).max())
    tol = dict(rtol=1e-5, atol=1e-4 * scale)
    if cfg.dtype == "bfloat16":
        tol = dict(rtol=1e-2, atol=2.0 ** (np.floor(np.log2(scale)) - 7))
    for form in (moe.grouped, moe.all_experts):
        got = form(tx)
        assert got.dtype == td and got.shape == tx.shape
        np.testing.assert_allclose(got.float().numpy(), want, **tol,
                                   err_msg=form.__name__)
    return idx


@pytest.mark.parametrize("T", sorted(TOKEN_SHAPES))
@pytest.mark.parametrize("n_experts,top_k", [(4, 1), (4, 2), (8, 1), (8, 2)])
def test_moe_forms_match_dropless_reference(n_experts, top_k, T):
    cfg = _cfg(n_experts, top_k)
    p, moe = _moe(cfg, seed=n_experts + top_k)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((*TOKEN_SHAPES[T], cfg.d_model))
    _check(p, moe, x.astype(np.float32), cfg)


def test_moe_forms_match_reference_in_bf16():
    """The full-width dtype: bf16 activations and experts, float32 router
    and gated sum, cast to bf16 once."""
    cfg = _cfg(8, 2, "bfloat16")
    p, moe = _moe(cfg, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 48, cfg.d_model))
    _check(p, moe, x.astype(np.float32), cfg)


def test_expert_without_tokens():
    """An expert no token routes to (every token's first feature is 4 and
    that expert's router weight on it -100) is skipped by the grouped form
    and dropped by the other."""
    cfg = _cfg(8, 2)
    p, _ = _moe(cfg, seed=6)
    router = np.array(p["router"])
    router[0, 5] = -100.0
    p, moe = _moe(cfg, seed=6, router=router)
    x = np.random.default_rng(6).standard_normal((2, 48, cfg.d_model))
    x[..., 0] = 4.0
    idx = _check(p, moe, x.astype(np.float32), cfg)
    counts = np.bincount(idx.ravel(), minlength=8)
    assert counts[5] == 0 and (np.delete(counts, 5) > 0).all(), counts


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_take_the_lower_expert(top_k):
    """Equal router columns give exactly equal probabilities (small
    integer activations, dyadic router: every product and sum is exact), and
    ``lax.top_k`` takes the lower expert first.  Top-1: columns 1 and 2
    tie for first; top-2: column 0 leads and columns 1 and 3 tie for
    second."""
    cfg = _cfg(4, top_k)
    E = cfg.d_model
    rng = np.random.default_rng(7)
    x = rng.integers(-2, 3, (1, 6, E)).astype(np.float32)
    x[..., 0] = rng.integers(1, 3, 6)
    lead = np.zeros(E, np.float32)
    lead[0] = 0.5
    router = np.zeros((E, 4), np.float32)
    if top_k == 1:
        router[:, 1] = router[:, 2] = lead
        router[1:, 0] = rng.integers(-2, 3, E - 1) / 1024
    else:
        router[:, 0] = 2 * lead
        router[:, 1] = router[:, 3] = lead
    p, moe = _moe(cfg, seed=7, router=router)
    idx = _check(p, moe, x, cfg)
    want = [1] if top_k == 1 else [0, 1]
    assert (idx == np.array(want)).all(), idx


def test_pinned_route_takes_this_calls_gates():
    """``route(xt, idx)`` keeps the given experts and takes their gates
    from this call's softmax: with its own indices it is ``route(xt)`` bit
    for bit; with other indices the gates are those experts' normalised
    probabilities."""
    cfg = _cfg(8, 2)
    _, moe = _moe(cfg, seed=8)
    xt = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (5, cfg.d_model)).astype(np.float32))
    gate, idx = moe.route(xt)
    g2, i2 = moe.route(xt, idx)
    assert torch.equal(g2, gate) and torch.equal(i2, idx)
    other = (idx + 3) % 8
    g3, i3 = moe.route(xt, other)
    probs = torch.softmax(xt @ moe.router, -1).gather(-1, other)
    assert torch.equal(i3, other)
    torch.testing.assert_close(g3, probs / probs.sum(-1, keepdim=True))


def test_routing_tape_pins_the_recorded_experts():
    """``RoutingTape`` (the parity checks' pin): a call replayed on the
    routing it recorded is the unpinned call bit for bit, with no moved
    decision; a router nudged between the two calls is held to the recorded
    experts, its moved decisions counted with their margin."""
    from repro_torch.models import routing, transformer as TT
    cfg = port_arch(_cfg(4, 2))
    model = TT.init_model(0, cfg, device="cpu")
    blk = model.blocks[0]
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32))
    want, want_all = blk.ffn.grouped(x), blk.ffn.all_experts(x)
    tape = routing.RoutingTape(model)
    tape.record()
    assert torch.equal(blk.ffn.grouped(x), want)
    recorded = [t.clone() for t in tape.tape]
    tape.replay()
    assert torch.equal(blk.ffn.all_experts(x), want_all)
    tape.stop()
    tape.replay()
    assert torch.equal(blk.ffn.grouped(x), want)
    tape.stop()
    assert tape.report() == dict(decisions=42, flips=0, max_flip_gap=0.0)
    blk.ffn.router.data[:, 3] += 0.05 * x.reshape(-1, cfg.d_model)[0]
    tape.replay()
    _, idx = blk.ffn.route(x.reshape(-1, cfg.d_model))
    tape.stop()
    assert torch.equal(idx, recorded[0])
    assert tape.report()["flips"] > 0 and tape.report()["max_flip_gap"] > 0
    tape.remove()
    assert "route" not in vars(blk.ffn)


def test_engine_and_scheduler_match_reference():
    """Reduced mixtral through both packages' ``ServingEngine`` +
    ``ArcusScheduler``: prefills dispatch grouped, each decode step runs
    the fixed-shape form over all four slots, inactive ones too; logits at
    every call, tokens, statistics and caches (``assert_serving_matches``).
    Mixtral's cost model clocks longer steps (more active parameters), so
    the mix ends at 0.83 s of virtual time: the run takes 1 s."""
    cfg = _cfg()
    params, model = jax_and_port_model(cfg, 0)
    assert_serving_matches(cfg, params, model, "mixtral-8x22b", duration=1.0)
