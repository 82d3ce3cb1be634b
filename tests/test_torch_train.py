"""The port's full-sequence forward and single-card training against the
JAX package, on the CPU at reduced size in float32.

* ``transformer.forward``: logits and the MoE auxiliary loss for every
  arch, the reference's weights loaded into the port's training storage
  with seeded noise on the parameters initialised to zeros or ones (QKV
  biases, the Mamba2, RG-LRU, gate and norm parameters), within
  ``LOGIT_TOL`` (float32 sums in another order);
* the loss and every parameter's gradient against
  ``jax.value_and_grad(train.loss_fn)`` for starcoder2-3b, mixtral-8x22b
  (the capacity dispatch at a capacity factor that drops pairs, and the
  auxiliary loss), recurrentgemma-9b and seamless-m4t-medium, within
  ``GRAD_RTOL`` of the reference gradient's Frobenius norm (or
  ``GRAD_ATOL`` absolute: a key bias's gradient is zero in exact
  arithmetic, softmax being blind to a per-query constant, and both
  packages leave rounding noise of about 1e-8 there);
* the plain flash-attention backward against ``jax.vjp`` of the
  reference's ``layers.flash_attention`` under every mask;
* ``optimizer.apply`` and ``schedule`` over three steps with the clip
  active and the warmup and cosine boundaries, two ``train_step``s against
  the reference's jitted step, ``remat`` equal to no remat, checkpoints
  written by either package and restored by the other, and the launcher.

One JAX compile per arch: each arch's reference run is shared through a
module-scoped fixture (one ``value_and_grad`` that also returns the
logits for the four gradient archs, one forward for the others).  Torch
runs on one thread (``_torch_parity.one_torch_thread``).
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS, get_reduced_config
from repro.models import layers as JL, module as jnn, transformer as JT
from repro.training import checkpoint as JC, optimizer as JO, train as JTR
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.launch import train as t_train
from repro_torch.models import convert, layers as TL, transformer as TT
from repro_torch.training import checkpoint as TC, optimizer as TO, \
    train as TTR
from _torch_parity import jax_and_port_model, one_torch_thread, port_arch

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
LOSS_TOL = dict(rel=1e-5, abs=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
#: parameters after a train step at learning rate 1e-3: AdamW moves an
#: element by about lr g / (|g| + eps), so an element whose gradient is
#: within float32 rounding of eps (1e-8) moves by an amount that rounding
#: changes (8% of lr seen); each element within 10% of lr, and each
#: parameter's whole update within ``UPDATE_RTOL`` of the reference's
#: (Frobenius)
STEP_TOL = dict(rtol=1e-5, atol=1e-4)
UPDATE_RTOL = 1e-3
GRAD_ARCHS = ("starcoder2-3b", "mixtral-8x22b", "recurrentgemma-9b",
              "seamless-m4t-medium", "mamba2-780m")
B, S = 2, 24
#: mixtral's capacity factor in these tests: C = int(0.5 T K / X) + 1 = 13
#: rows an expert for T = 48 tokens, K = 2, X = 4, below the 24 an expert
#: gets on average, so the dispatch drops pairs
MOE_CAPACITY = 0.5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _cfg(arch: str):
    cfg = get_reduced_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY)
    return cfg


def _noise(cfg) -> dict:
    return dict(bias_seed=3 if cfg.qkv_bias else None, ssd_seed=4,
                rglru_seed=5, cross_seed=6)


def _batch(cfg, seed: int = 1):
    """(reference batch of jnp arrays, port batch of CPU tensors)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 17:] = 0                        # a padded tail in one row
    jb = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.as_tensor(toks).long(),
          "mask": torch.as_tensor(mask)}
    if cfg.frontend:
        fe = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
        jb["frontend"], tb["frontend"] = jnp.asarray(fe), torch.as_tensor(fe)
    return jb, tb


@dataclasses.dataclass
class Run:
    cfg: object
    params: dict             # the reference's (jnp) parameters
    model: object            # the port's training-storage CPU model
    jb: dict
    tb: dict
    logits: np.ndarray
    aux: float
    loss: float = None
    parts: dict = None
    grads: dict = None       # port parameter name -> reference gradient


_RUNS: dict = {}


def reference_run(arch: str) -> Run:
    """The reference's forward (and, for ``GRAD_ARCHS``, its loss and
    gradients from the same compile) of one reduced arch, once a module."""
    if arch in _RUNS:
        return _RUNS[arch]
    cfg = _cfg(arch)
    params, model = jax_and_port_model(cfg, 0, train=True, **_noise(cfg))
    jb, tb = _batch(cfg)
    if arch in GRAD_ARCHS:
        def f(p):
            loss, parts = JTR.loss_fn(p, cfg, jb, remat=False)
            logits, aux = JT.forward(p, cfg, jb["tokens"], jb.get("frontend"))
            return loss, (parts, logits, aux)
        (loss, (parts, logits, aux)), grads = jax.jit(
            jax.value_and_grad(f, has_aux=True))(params)
        run = Run(cfg, params, model, jb, tb, np.asarray(logits), float(aux),
                  float(loss), jax.tree.map(float, parts),
                  convert.values_from_jax(jax.tree.map(np.asarray, grads),
                                          model))
    else:
        logits, aux = jax.jit(lambda p: JT.forward(
            p, cfg, jb["tokens"], jb.get("frontend")))(params)
        run = Run(cfg, params, model, jb, tb, np.asarray(logits), float(aux))
    _RUNS[arch] = run
    return run


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    run = reference_run(arch)
    with torch.no_grad():
        logits, aux = TT.forward(run.model, run.tb["tokens"],
                                 run.tb.get("frontend"))
    np.testing.assert_allclose(logits.numpy(), run.logits, **LOGIT_TOL)
    assert float(aux) == pytest.approx(run.aux, rel=1e-5, abs=1e-6)
    if run.cfg.n_experts:
        assert run.aux > 0


def _assert_grads(model, want: dict) -> None:
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.numpy(), want[name]
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) or err <= GRAD_ATOL, \
            (name, err, np.linalg.norm(w))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    run = reference_run(arch)
    run.model.zero_grad(set_to_none=True)
    loss, parts = TTR.loss_fn(run.model, run.tb, remat=False)
    loss.backward()
    assert loss.item() == pytest.approx(run.loss, **LOSS_TOL)
    assert parts["ce"].item() == pytest.approx(run.parts["ce"], **LOSS_TOL)
    assert parts["aux"].item() == pytest.approx(run.parts["aux"],
                                                **LOSS_TOL)
    _assert_grads(run.model, run.grads)
    run.model.zero_grad(set_to_none=True)


def test_moe_capacity_drops_as_reference():
    """The training dispatch on one hidden state: the output and router
    probabilities against ``moe_block(dropless=False)``, at a capacity that
    drops pairs (checked), and ``moe_aux_loss``."""
    cfg = _cfg("mixtral-8x22b")
    run = reference_run("mixtral-8x22b")
    jp = run.params["blocks"]["pos0"]["ffn"]
    jp = jax.tree.map(lambda x: x[0], jp)
    moe = run.model.blocks[0].ffn
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    y_ref, probs_ref = jax.jit(lambda p, x: JL.moe_block(
        p, x, cfg, dropless=False))(jp, jnp.asarray(x))
    with torch.no_grad():
        y, probs = moe.capacity(torch.as_tensor(x))
        _, idx = moe.route(torch.as_tensor(x).reshape(-1, cfg.d_model))
    C = int(cfg.capacity_factor * B * S * cfg.top_k / cfg.n_experts) + 1
    assert int(torch.bincount(idx.reshape(-1)).max()) > C   # drops happen
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref),
                               rtol=1e-5, atol=1e-7)
    # float32 sums over E and F in another order: within 1e-5 of the
    # output's scale (a pair dropped in one run and kept in the other would
    # move a row by about the scale itself); fully dropped tokens are 0
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(y_ref).max())
    np.testing.assert_array_equal(y.numpy() == 0, y_ref == 0)
    assert float(TL.moe_aux_loss(probs)) == pytest.approx(
        float(JL.moe_aux_loss(probs_ref)), rel=1e-6)


@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=True, window=5),
    dict(causal=True, chunk_size=8), dict(causal=False),
    dict(causal=False, sk=13)])
def test_plain_flash_backward_matches_reference_vjp(mask):
    """``flash_backward_plain`` (the plain version the backward kernel is
    held against) against ``jax.vjp`` of the reference's jnp
    ``flash_attention`` (KV chunks of 8), GQA 4 / 2 heads of 16, float32,
    within 2e-5 (sums in another order)."""
    mask = dict(mask)
    sq, sk = 20, mask.pop("sk", 20)
    rng = np.random.default_rng(len(mask) + sk)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((1, sq, 4, 16), (1, sk, 2, 16),
                                 (1, sk, 2, 16), (1, sq, 4, 16)))
    causal = mask.pop("causal")
    kw = dict(mask_kind="causal" if causal else "full",
              window=mask.get("window", 0),
              chunk_size=mask.get("chunk_size", 0), kv_chunk=8)
    o_ref, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(q, k, v, **kw),
                         *map(jnp.asarray, (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    o, lse = fp_ops.flash_prefill_lse(tq, tk, tv, causal=causal, **mask)
    got = fp_ops.flash_backward(tq, tk, tv, o, lse, tdo, causal=causal,
                                **mask)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-5,
                               atol=2e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-5, err_msg=name)


def test_flash_attention_function_matches_autograd_of_plain():
    """The autograd ``FlashAttention`` on the CPU (the plain forward with
    its LSE, the plain backward) gives autograd's gradients of the plain
    forward, within 1e-5."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                   for s in ((2, 17, 6, 8), (2, 17, 2, 8), (2, 17, 2, 8),
                             (2, 17, 6, 8)))
    grads = []
    for fn in (fp_ops.flash_attention, fp_ops.flash_prefill_plain):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*xs, window=6).backward(do)
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_remat_equals_no_remat():
    """``forward(remat=True)`` (each period repetition checkpointed) gives
    the same loss and gradients as without, bit for bit."""
    run = reference_run("starcoder2-3b")
    out = []
    for remat in (False, True):
        run.model.zero_grad(set_to_none=True)
        loss, _ = TTR.loss_fn(run.model, run.tb, remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in
                                    run.model.parameters()]))
    run.model.zero_grad(set_to_none=True)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


OPT_CFG = dict(lr=1e-2, warmup_steps=2, total_steps=3, clip_norm=0.5)


def test_optimizer_matches_reference_over_three_steps():
    """``optimizer.apply`` against the reference's jitted ``apply`` on the
    same parameters and gradients, three steps: step 1 in the warmup, 2 at
    its end, 3 at the cosine's end (past total_steps); the gradients' norm
    is above ``clip_norm`` at every step, so the clip scales them.
    Parameters and moments within PARAM_TOL, the norm and rate within
    1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "blocks": {"pos0": {"s": (3, 4)}}}
    names = ["b", "blocks.pos0.s", "w"]            # the reference's order

    def draw(scale):
        return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
                "b": rng.standard_normal(5).astype(np.float32) * scale,
                "blocks": {"pos0": {"s": rng.standard_normal(
                    (3, 4)).astype(np.float32) * scale}}}

    def flat(tree):
        return {"w": tree["w"], "b": tree["b"],
                "blocks.pos0.s": tree["blocks"]["pos0"]["s"]}
    del shapes
    cfg_j, cfg_t = JO.AdamWConfig(**OPT_CFG), TO.AdamWConfig(**OPT_CFG)
    p_np = draw(1.0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = JO.init(jp)
    tp = {n: torch.as_tensor(np.array(v)) for n, v in flat(p_np).items()}
    tp = {n: tp[n] for n in names}
    tst = TO.init(tp)
    japply = jax.jit(lambda p, g, s: JO.apply(cfg_j, p, g, s))
    for step in range(3):
        g_np = draw(3.0)
        jp, jst, jm = japply(jp, jax.tree.map(jnp.asarray, g_np), jst)
        tg = {n: torch.as_tensor(np.array(v)) for n, v in flat(g_np).items()}
        _, tst, tm = TO.apply(cfg_t, tp, tg, tst)
        assert float(jm["grad_norm"]) > cfg_t.clip_norm
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(tst.step) == int(jst.step) == step + 1
        for tree, got in ((jp, tp), (jst.m, tst.m), (jst.v, tst.v)):
            for n, want in flat(jax.tree.map(np.asarray, tree)).items():
                np.testing.assert_allclose(got[n].numpy(), want, **PARAM_TOL,
                                           err_msg=f"step {step + 1} {n}")


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (2, 3), (0, 1),
                                          (10, 5)])
def test_schedule_matches_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, total - 1,
                    total, total + 7})
    for s in steps:
        want = float(JO.schedule(JO.AdamWConfig(**cfg), jnp.int32(s)))
        got = float(TO.schedule(TO.AdamWConfig(**cfg),
                                torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def test_two_train_steps_match_reference_jitted_step():
    """Two ``train_step``s (remat, the reference's AdamW defaults with a
    short warmup) against the reference's jitted ``make_train_step``: the
    metrics within 1e-5 and every parameter after each step within
    ``STEP_TOL``, its update within ``UPDATE_RTOL`` (the gradients differ
    by float32 sums in another order)."""
    # without QKV biases: the key bias's gradient is zero in exact
    # arithmetic, so AdamW's update of it, lr g / (|g| + eps), is the
    # rounding noise's sign in either package (the gradient test holds it)
    cfg = dataclasses.replace(_cfg("starcoder2-3b"), qkv_bias=False)
    params, model = jax_and_port_model(cfg, 2, train=True, **_noise(cfg))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstep = jax.jit(JTR.make_train_step(cfg, JO.AdamWConfig(**ocfg),
                                        remat=True))
    tstep = TTR.make_train_step(port_arch(cfg), TO.AdamWConfig(**ocfg),
                                remat=True)
    jst = JO.init(params)
    tst = TO.init(dict(model.named_parameters()))
    for i in range(2):
        jb, tb = _batch(cfg, seed=10 + i)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        params, jst, jm = jstep(params, jst, jb)
        model, tst, tm = tstep(model, tst, tb)
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                   abs=1e-6), (i, key)
        want = convert.values_from_jax(jax.tree.map(np.asarray, params),
                                       model)
        for name, p in model.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[name], **STEP_TOL,
                                       err_msg=f"{i} {name}")
            upd, upd_ref = got - before[name].numpy(), want[name] - \
                before[name].numpy()
            assert np.linalg.norm(upd - upd_ref) <= UPDATE_RTOL * \
                np.linalg.norm(upd_ref), (i, name)


def _ckpt_cfg(arch: str):
    """recurrentgemma with a remainder layer (period 3, 4 layers: one in
    ``tail``), or seamless with its stacked encoder."""
    cfg = get_reduced_config(arch)
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, n_layers=4)
    return cfg


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_checkpoints_restore_across_packages(arch, tmp_path):
    """A checkpoint the reference saves restores into the port, and one the
    port saves restores into the reference, with the reference's keys,
    shapes and dtypes: parameters, AdamW moments and step bit for bit."""
    cfg = _ckpt_cfg(arch)
    params, model = jax_and_port_model(cfg, 1, train=True, **_noise(cfg))
    rng = np.random.default_rng(4)
    jst = JO.OptState(jnp.int32(7), *(
        jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32)), params) for _ in range(2)))
    JC.save(str(tmp_path / "ref"), params, jst, step=7,
            metadata={"arch": arch})
    ref_files = {k: dict(np.load(tmp_path / "ref" / f"{k}.npz"))
                 for k in ("params", "opt_state")}
    # the reference's checkpoint into a freshly drawn port model
    fresh = TT.init_model(9, port_arch(cfg), device="cpu", train=True)
    ost = TO.init(dict(fresh.named_parameters()))
    _, ost, meta = TC.restore(str(tmp_path / "ref"), fresh, ost)
    assert meta == {"step": 7, "arch": arch}
    assert int(ost.step) == 7
    want = convert.values_from_jax(jax.tree.map(np.asarray, params), fresh)
    m_want = convert.values_from_jax(jax.tree.map(np.asarray, jst.m), fresh)
    for name, p in fresh.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
        np.testing.assert_array_equal(ost.m[name].numpy(), m_want[name])
    # the port's checkpoint: the reference's files, restored by the
    # reference
    TC.save(str(tmp_path / "port"), fresh, ost, step=7,
            metadata={"arch": arch})
    for k, ref in ref_files.items():
        got = dict(np.load(tmp_path / "port" / f"{k}.npz"))
        assert sorted(got) == sorted(ref), k
        for key, arr in ref.items():
            assert got[key].dtype == arr.dtype, key
            np.testing.assert_array_equal(got[key], arr, err_msg=key)
    like = jax.tree.map(jnp.zeros_like, params)
    p2, s2, meta2 = JC.restore(str(tmp_path / "port"), like, JO.init(like))
    assert meta2 == meta
    for a, b in zip(jax.tree.leaves((params, jst)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_to_jax_tree_is_the_reference_tree():
    cfg = _ckpt_cfg("recurrentgemma-9b")
    params, model = jax_and_port_model(cfg, 1, train=True, **_noise(cfg))
    got = convert.to_jax_tree(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_launcher_trains_on_cpu_and_prints_reference_count(tmp_path):
    """``python -m repro_torch.launch.train --arch starcoder2-3b --steps 3``
    on the CPU (a smaller batch and sequence): the reference's parameter
    line, a finite loss printed at steps 0 and 2, and a checkpoint the
    reference restores."""
    argv = ["--arch", "starcoder2-3b", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt", str(tmp_path / "ck")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = t_train.train(t_train.parser().parse_args(argv), device="cpu")
    lines = buf.getvalue().splitlines()
    cfg = get_reduced_config("starcoder2-3b")
    shapes = jax.eval_shape(lambda: JT.init_model(0, cfg)[0])
    n = jnn.param_count(shapes)
    assert lines[0] == (f"{cfg.name}: {n/1e6:.1f}M params, "
                        "mesh={'data': 1, 'model': 1}")
    assert [ln.split(" loss=")[0] for ln in lines[1:3]] == \
        ["step    0", "step    2"]
    assert lines[3] == f"saved {tmp_path / 'ck'}"
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    like = jax.tree.map(jnp.zeros_like, shapes)
    _, meta = JC.restore(str(tmp_path / "ck"), like)
    assert meta == {"step": 3}


def test_launcher_refuses_multi_pod(monkeypatch):
    def built(*_, **__):
        raise AssertionError("a model was built")
    monkeypatch.setattr(t_train.T, "init_model", built)
    args = t_train.parser().parse_args(["--arch", "starcoder2-3b",
                                        "--multi-pod"])
    with pytest.raises(ValueError, match="multi-pod"):
        t_train.train(args, device="cpu")
