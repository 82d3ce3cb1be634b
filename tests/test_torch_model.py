"""The port's transformer (``repro_torch.models``) against the JAX package.

The reference initialises the weights; ``convert.params_from_jax`` loads
them into the port, and the same numpy token ids go through both.  On the
CPU the port's attention runs the kernels' plain versions.  Reduced
configs: the dense attention models, and the RG-LRU (recurrentgemma, with
seeded noise on its zero / one parameters) and MoE (mixtral: 4 experts,
top-2 every layer; llama4: top-1 every second layer, chunk + global
attention) families.  In float32 sums run in another order in the two
frameworks, so logits agree to 1e-4 absolute (they reach ~20) and cache
entries to 2e-5.  In bf16 (the full-width model's dtype) values also round
at other places, so they agree to about one bf16 ulp of their scale: 1e-2
relative (2^-7) plus 1/16 absolute (an ulp between 8 and 16), for logits
and cache entries.  The port's greedy token is one the reference's logits
rank first: the same token, or, where the reference's top logits tie
exactly (bf16 logits can), one of the tied.
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
from repro_torch.configs import registry as t_registry
from repro_torch.models import convert, layers as TL, transformer as TT
from _torch_parity import jax_and_port_model, one_torch_thread, port_arch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one thread: beside the other test processes a pool of
    threads spin-waits (``_torch_parity.one_torch_thread``)."""
    with one_torch_thread():
        yield


TOL = {"float32": (dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-5, atol=2e-5)),
       "bfloat16": (dict(rtol=1e-2, atol=0.0625),
                    dict(rtol=1e-2, atol=0.0625))}
LOGIT_TOL, CACHE_TOL = TOL["float32"]
B, PROMPT, MAX_LEN, STEPS = 2, 80, 128, 10


def _gemma():
    return get_reduced_config("gemma3-12b")


MODEL_CASES = {
    # 5 local (window 64, rolling cache) + 1 global; GQA 4/2; gelu-tanh,
    # embedding scale, tied head
    "gemma3": (_gemma, {}),
    # partial RoPE (fraction 0.5), QKV bias, untied head, 2 repetitions
    "chatglm3": (lambda: get_reduced_config("chatglm3-6b"),
                 dict(bias_seed=7)),
    # chunked-local layers, 2 repetitions of a period of 3
    "chunk": (lambda: dataclasses.replace(
        _gemma(), layer_pattern=("chunk", "chunk", "global")), {}),
    # the full-width dtype: bf16 activations and weights, float32 cache,
    # norms and embedding gather
    "gemma3-bf16": (lambda: get_reduced_config("gemma3-12b",
                                               dtype="bfloat16"), {}),
    # Griffin: rglru, rglru, local (MQA, window 64); noisy conv, gate
    # biases and Lambda
    "recurrentgemma": (lambda: get_reduced_config("recurrentgemma-9b"),
                       dict(rglru_seed=8)),
    "recurrentgemma-bf16": (lambda: get_reduced_config(
        "recurrentgemma-9b", dtype="bfloat16"), dict(rglru_seed=8)),
    # 4 experts, top-2, every layer; local attention, GQA 4/1, untied head
    "mixtral": (lambda: get_reduced_config("mixtral-8x22b"), {}),
    "mixtral-bf16": (lambda: get_reduced_config("mixtral-8x22b",
                                                dtype="bfloat16"), {}),
    # 4 experts, top-1, MoE every second layer; chunk, chunk, chunk, global
    "llama4": (lambda: get_reduced_config("llama4-maverick-400b-a17b"), {}),
}


def _assert_cache(j_cache, t_cache, cfg, tol=CACHE_TOL):
    ref = convert.cache_from_jax(jax.tree.map(np.asarray, j_cache),
                                 port_arch(cfg))
    assert len(ref) == len(t_cache) == cfg.n_layers
    for li, ((rk, rv), (tk, tv)) in enumerate(zip(ref, t_cache)):
        assert rk.shape == tk.shape, (li, rk.shape, tk.shape)
        # a bf16 prefill leaves the reference's rglru conv state in bf16
        np.testing.assert_allclose(tk.numpy(), rk.float().numpy(), **tol,
                                   err_msg=f"layer {li} k")
        np.testing.assert_allclose(tv.numpy(), rv.float().numpy(), **tol,
                                   err_msg=f"layer {li} v")


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and cache, then STEPS decode steps (per-row lengths,
    so rows write different slots; the local layers' rolling slots wrap),
    logits and greedy tokens at every step, and the final cache."""
    make_cfg, noise = MODEL_CASES[name]
    cfg = make_cfg()
    logit_tol, cache_tol = TOL[cfg.dtype]
    params, model = jax_and_port_model(cfg, 0, **noise)
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
    assert t_logits.dtype == TL.torch_dtype(cfg.dtype)
    np.testing.assert_allclose(t_logits.float().numpy(),
                               np.asarray(j_logits, np.float32), **logit_tol)
    assert t_len.tolist() == [PROMPT] * B
    _assert_cache(j_cache, t_cache, cfg, cache_tol)

    dec = jax.jit(lambda p, t, ln, c: JT.decode_step(p, cfg, t, ln, c))
    lengths = np.array([PROMPT, PROMPT - 23], np.int32)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    for step in range(STEPS):
        j_logits, j_cache = dec(params, jnp.asarray(tok[:, None]),
                                jnp.asarray(lengths), j_cache)
        t_logits = TT.decode_step(model, torch.as_tensor(tok[:, None]).long(),
                                  torch.as_tensor(lengths), t_cache)
        np.testing.assert_allclose(t_logits.float().numpy(),
                                   np.asarray(j_logits, np.float32),
                                   **logit_tol, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        _assert_greedy(t_logits, j_logits, step)
        lengths += 1
    _assert_cache(j_cache, t_cache, cfg, cache_tol)


def _assert_greedy(t_logits, j_logits, step) -> None:
    """The port's greedy token of each row has the reference's largest
    logit: the reference's token, or one tied with it exactly."""
    j = np.asarray(j_logits, np.float32)
    tok = t_logits.argmax(-1).numpy()
    np.testing.assert_array_equal(j[np.arange(len(tok)), tok], j.max(-1),
                                  err_msg=f"step {step}: {tok.tolist()} vs "
                                  f"{j.argmax(-1).tolist()}")


def test_cache_from_jax_resumes_decode():
    """A reference cache carried across resumes decoding in the port."""
    _resume_decode(_gemma(), {})


def test_cache_from_jax_resumes_decode_rglru():
    """The same for recurrentgemma: each ``rglru`` layer's (conv, h)
    carried across beside the local layer's (k, v)."""
    _resume_decode(get_reduced_config("recurrentgemma-9b"),
                   dict(rglru_seed=9))


def _resume_decode(cfg, noise) -> None:
    params, model = jax_and_port_model(cfg, 2, **noise)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, 70)).astype(np.int32)
    cache = JT.init_cache(cfg, 1, MAX_LEN, jnp.float32)
    _, cache, _ = JT.prefill(params, cfg, jnp.asarray(toks), cache)
    t_cache = convert.cache_from_jax(jax.tree.map(np.asarray, cache),
                                     model.cfg)
    dec = jax.jit(lambda p, t, ln, c: JT.decode_step(p, cfg, t, ln, c))
    lengths = np.array([70], np.int32)
    for step in range(3):
        tok = np.array([[5 + step]], np.int32)
        j_logits, cache = dec(params, jnp.asarray(tok), jnp.asarray(lengths),
                              cache)
        t_logits = TT.decode_step(model, torch.as_tensor(tok).long(),
                                  torch.as_tensor(lengths), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **LOGIT_TOL)
        lengths += 1


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_rope_matches_reference(fraction, dt):
    """RoPE, partial RoPE too; a bf16 input is rotated in float32 and cast
    back, as bf16 x float32 promotes in both frameworks.  float32 within
    2e-5 (cos / sin of the two libraries), bf16 within one bf16 ulp."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 37, 4, 64)), dt)
    pos = jnp.asarray(rng.integers(0, 300, (2, 37)), jnp.int32)
    want = np.asarray(JL.rope(x, pos, theta=10_000.0, fraction=fraction)
                      .astype(jnp.float32))
    tx = torch.as_tensor(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dt == jnp.bfloat16 else torch.float32)
    got = TL.rope(tx, torch.as_tensor(np.array(pos)), theta=10_000.0,
                  fraction=fraction)
    assert got.dtype == tx.dtype
    tol = dict(rtol=8e-3, atol=8e-3) if dt == jnp.bfloat16 \
        else dict(rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    rot = int(64 * fraction)
    np.testing.assert_array_equal(got[..., rot:].float().numpy(),
                                  np.asarray(x[..., rot:], np.float32))


@pytest.mark.parametrize("arch", ["gemma3-12b", "starcoder2-3b"])
def test_norm_and_mlp_match_reference(arch):
    """RMSNorm / LayerNorm (float32 scale, not 1 + scale) and the gated
    gelu-tanh / plain gelu MLP, within 1e-5."""
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(4)
    mk = TL.Maker(torch.Generator().manual_seed(0), "cpu")
    norm, mlp = TL.Norm(port_arch(cfg), mk), TL.MLP(port_arch(cfg), mk)
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    p_norm = {"scale": jnp.asarray(scale)}
    norm.scale.data.copy_(torch.as_tensor(scale))
    if cfg.norm == "layernorm":
        bias = rng.standard_normal(cfg.d_model).astype(np.float32)
        p_norm["bias"] = jnp.asarray(bias)
        norm.bias.data.copy_(torch.as_tensor(bias))
    p_mlp = {"wi": jnp.asarray(mlp.wi.numpy()), "wo": jnp.asarray(
        mlp.wo.numpy())}
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        norm(torch.as_tensor(x)).numpy(),
        np.asarray(JL.norm(p_norm, jnp.asarray(x), cfg)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        mlp(torch.as_tensor(x)).numpy(),
        np.asarray(JL.mlp_block(p_mlp, jnp.asarray(x), cfg)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_init_cache_has_reference_shapes_with_memory(arch):
    """At full size, the port's cache holds the reference's tensors, with
    their shapes and dtypes, layer for layer: (k, v) of max_len rows for a
    self-attention layer and of ``frontend_len`` rows for a ``cross`` one,
    then an encoder-decoder layer's (xk, xv) of ``frontend_len`` rows (the
    port's built on the meta device, the reference's by ``eval_shape``:
    no memory)."""
    cfg = t_registry.get_config(arch)
    ref = jax.eval_shape(lambda: JT.init_cache(cfg, 2, 256, jnp.float32))
    period, reps = cfg.period, cfg.n_layers // cfg.period
    want = []
    for li in range(cfg.n_layers):
        r, j = divmod(li, period)
        layer, lead = (ref["blocks"][f"pos{j}"], 1) if r < reps \
            else (ref["tail"][li - reps * period], 0)
        want.append([(tuple(layer[n].shape[lead:]), str(layer[n].dtype))
                     for n in ("k", "v", "xk", "xv") if n in layer])
    got = TT.init_cache(cfg, 2, 256, torch.float32, device="meta")
    assert [[(tuple(t.shape), str(t.dtype).removeprefix("torch."))
             for t in layer] for layer in got] == want
    F, KvH, Dh = cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim_
    assert [[t.shape[1] for t in layer] for layer in got] == [
        [F, F] if k == "cross" else [256, 256] + [F, F] * bool(
            cfg.encoder_layers) for k in cfg.layer_kinds()]
    assert all(t.shape[2:] == (KvH, Dh) for layer in got for t in layer)


def test_init_model_draws_reference_scales_and_storage_dtypes():
    """Seeded and repeatable; dense weights ~N(0, 1/in_dim), embeddings
    ~N(0, 1), norm scales 1; at bf16 the projections are stored in bf16
    and norm scales and the embedding in float32, and the tied head is the
    embedding cast to bf16."""
    cfg = t_registry.get_reduced_config("gemma3-12b", dtype="bfloat16")
    a = TT.init_model(5, cfg, device="cpu")
    b = TT.init_model(5, cfg, device="cpu")
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    blk = a.blocks[0]
    assert blk.mixer.wq.dtype == torch.bfloat16
    assert blk.ffn.wi.dtype == torch.bfloat16
    assert blk.ln1.scale.dtype == torch.float32
    assert a.embed.dtype == torch.float32
    assert torch.equal(a.unembed_w, a.embed.to(torch.bfloat16))
    assert torch.equal(blk.ln1.scale, torch.ones(cfg.d_model))
    std = float(blk.mixer.wq.float().std()) * cfg.d_model ** 0.5
    assert abs(std - 1.0) < 0.05, std
    assert abs(float(a.embed.std()) - 1.0) < 0.05
    assert not torch.equal(TT.init_model(6, cfg, device="cpu").embed,
                           a.embed)


def test_init_model_without_cuda_raises_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TT.init_model(0, t_registry.get_reduced_config("gemma3-12b"))
