"""The port's sequence-sharded decode collectives and activation-sharding
hooks (``repro_torch.distributed.collectives`` / ``actsharding``) against
the JAX package's, on the CPU through gloo.

On a 1x1 mesh in this process (a one-rank gloo group): every case of
``tests/test_collectives.py`` (the attention at window 0 and 64, the
``d_axis`` form, the one-slot cache update, actsharding's identity,
``decode_step`` with the hooks), the same numpy inputs through the
reference's functions on its dev mesh and through the port's.  Across
ranks: one spawned 2x2 gloo job (``_torch_dist_job.py``, four processes,
a module fixture) runs each case of ``_torch_dist_job.CASES`` on its
shards; each rank's result is held against the reference's 1x1 result and
against its oracle ``da_ref.decode_attention`` on the whole inputs, and
``decode_step`` with the hooks (the reduced gemma3, the cache's rows over
two ranks) against the unhooked step.  Attention within 2e-5, as
``tests/test_collectives.py``; the cache update exactly.  The plain
version of the kernel's partial form (``ref.decode_attention_partial``)
is held against the oracle by rebuilding the whole result from two
slices' (out, m, l).
"""
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro.kernels.decode_attention import ref as da_ref
from repro.launch.mesh import make_dev_mesh as j_dev_mesh
from repro_torch.distributed import actsharding, collectives as TC
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.decode_attention import ref as t_da_ref
from repro_torch.launch.mesh import make_dev_mesh
import _torch_dist_job as job
from _torch_parity import jax_and_port_model, one_torch_thread

TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _ref_attn(x, window=0, batch_axis="model", d_axis=None):
    """The reference's seq-sharded attention on its 1x1 dev mesh."""
    mesh = j_dev_mesh(1, 1)
    with mesh:
        fn = JC.make_seq_sharded_decode_attn(mesh, "data", batch_axis,
                                             d_axis)
        return np.asarray(jax.jit(lambda *a: fn(*a, window=window))(
            *(jnp.asarray(x[k]) for k in ("q", "k", "v", "lengths"))))


def _oracle(x, window=0):
    return np.asarray(da_ref.decode_attention(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "lengths")),
        window=window))


def _inputs(B, H, KvH, D, S, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((B, H, D)).astype(np.float32),
                k=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
                v=rng.standard_normal((B, S, KvH, D)).astype(np.float32),
                lengths=np.asarray(lengths, np.int32))


@pytest.mark.parametrize("window", [0, 64])
def test_seq_sharded_attention_matches_reference(window):
    x = _inputs(2, 8, 4, 64, 256, [100, 220])
    fn = TC.make_seq_sharded_decode_attn(make_dev_mesh(1, 1, device="cpu"),
                                         "data", "model")
    got = fn(*(_t(x[k]) for k in ("q", "k", "v", "lengths")),
             window=window).numpy()
    np.testing.assert_allclose(got, _ref_attn(x, window), **TOL)
    np.testing.assert_allclose(got, _oracle(x, window), **TOL)


def test_seq_sharded_attention_d_axis_matches_reference():
    x = _inputs(1, 4, 2, 32, 128, [128], seed=1)
    fn = TC.make_seq_sharded_decode_attn(make_dev_mesh(1, 1, device="cpu"),
                                         "data", None, "model")
    got = fn(*(_t(x[k]) for k in ("q", "k", "v", "lengths"))).numpy()
    np.testing.assert_allclose(
        got, _ref_attn(x, batch_axis=None, d_axis="model"), **TOL)
    np.testing.assert_allclose(got, _oracle(x), **TOL)


def test_seq_sharded_cache_update_and_partial_plain():
    """The one-slot update equals the reference's exactly; the plain
    partial form, over two slices of a sequence and on the edge lengths
    (none, in the first slice, on the boundary, past S, negative after the
    shift), rebuilds the oracle's result from (out, m, l)."""
    u = job.update_inputs()
    mesh = j_dev_mesh(1, 1)
    with mesh:
        jfn = JC.make_seq_sharded_cache_update(mesh, "data", "model")
        want = jax.jit(jfn)(*(jnp.asarray(u[k]) for k in (
            "ck", "cv", "k_new", "v_new", "slot")))
    ck, cv = _t(u["ck"]).clone(), _t(u["cv"]).clone()
    upd = TC.make_seq_sharded_cache_update(
        make_dev_mesh(1, 1, device="cpu"), "data", "model")
    upd(ck, cv, _t(u["k_new"]), _t(u["v_new"]), _t(u["slot"]))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(want[1]))

    x = _inputs(5, 8, 2, 64, 96, [0, 30, 48, 49, 96], seed=2)
    for window in (0, 20):
        halves = []
        for lo, hi in ((0, 48), (48, 96)):
            out, ml = t_da_ref.decode_attention_partial(
                _t(x["q"]), _t(x["k"][:, lo:hi]), _t(x["v"][:, lo:hi]),
                _t(x["lengths"] - lo), window=window)
            halves.append((out.numpy().astype(np.float64), ml.numpy()))
        m = np.maximum(halves[0][1][..., 0], halves[1][1][..., 0])
        acc = sum(o * (h[..., 1] * np.exp(h[..., 0] - m))[..., None]
                  for o, h in halves)
        den = sum(h[..., 1] * np.exp(h[..., 0] - m) for _, h in halves)
        got = acc / np.maximum(den, 1e-30)[..., None]
        np.testing.assert_allclose(got, _oracle(x, window), **TOL)
        empty = halves[1][1][0]           # sequence 0: no row anywhere
        np.testing.assert_array_equal(empty[:, 1], 0.0)
        np.testing.assert_array_equal(empty[:, 0], np.float32(-1e30))
        np.testing.assert_array_equal(halves[1][0][0], 0.0)


def test_actsharding_identity_and_placements():
    """Disabled (the default), both hooks return their argument itself and
    the reduced MLP is bitwise what it computes without them; enabled on
    a 1x1 ``DTensor`` they lay it out as the reference's ``PartitionSpec``
    through ``sharding.placements``."""
    from jax.sharding import PartitionSpec as P
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro.configs.registry import get_reduced_config
    from repro.distributed import actsharding as jact
    from repro_torch.models import layers as TL
    from _torch_parity import port_arch
    actsharding.disable()
    x = torch.ones(2, 3, 4)
    assert actsharding.constrain_hidden(x) is x
    assert actsharding.gathered_weight(x) is x
    cfg = port_arch(get_reduced_config("gemma3-12b"))
    mlp = TL.MLP(cfg, TL.Maker(torch.Generator().manual_seed(0), "cpu"))
    h = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    E, g, Fd = mlp.wi.shape
    hid = (h @ mlp.wi.view(E, g * Fd)).view(2, 5, g, Fd)
    plain = (TL.act(hid[..., 0, :], cfg.act) * hid[..., 1, :]) @ mlp.wo
    assert torch.equal(mlp(h), plain)

    dm = make_dev_mesh(1, 1, device="cpu")
    captured = {}

    def spec(p):       # the reference's constraint, captured
        captured["spec"] = p
        return None
    jact.enable(("data",))
    actsharding.enable(("data",))
    try:
        orig = jax.lax.with_sharding_constraint
        jax.lax.with_sharding_constraint = lambda v, p: (spec(p), v)[1]
        try:
            jact.constrain_hidden(jnp.ones((2, 3, 2, 4)))
            hspec = captured["spec"]
            jact.gathered_weight(jnp.ones((4, 2, 8)), model_dim=-1)
            wspec = captured["spec"]
        finally:
            jax.lax.with_sharding_constraint = orig
        for t, fn, want in (
                (torch.ones(2, 3, 2, 4), actsharding.constrain_hidden, hspec),
                (torch.ones(4, 2, 8), actsharding.gathered_weight, wspec)):
            dt = distribute_tensor(t, dm, [Replicate(), Replicate()])
            got = fn(dt)
            assert list(got.placements) == SH.placements(
                SH._spec(*want) + (None,) * (t.ndim - len(want)), dm)
            assert torch.equal(got.full_tensor(), t)
            assert fn(t) is t             # a plain tensor has no layout
    finally:
        jact.disable()
        actsharding.disable()
    assert P("data", None, None, "model") == hspec


def test_decode_step_with_hooks_matches_default():
    """``decode_step`` with the seq-sharded hooks on a 1x1 mesh equals the
    unhooked step (2e-4, as the reference's test), and the reference's
    hooked step on the same weights and prompt."""
    from repro.configs.registry import get_reduced_config
    from repro.models import transformer as JT
    from repro_torch.models import convert, transformer as T
    cfg = get_reduced_config("gemma3-12b")
    params, model = jax_and_port_model(cfg)
    B, S = 2, 40
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    cache = JT.init_cache(cfg, B, max_len=S + 8, dtype=jnp.float32)
    _, cache, lengths = JT.prefill(params, cfg,
                                   jnp.asarray(tokens[:, :S - 1]), cache)
    jmesh = j_dev_mesh(1, 1)
    with jmesh:
        lg_ref, _ = JT.decode_step(
            params, cfg, jnp.asarray(tokens[:, S - 1:]), lengths, cache,
            decode_attn_fn=JC.make_seq_sharded_decode_attn(jmesh, "data",
                                                           "model"),
            decode_update_fn=JC.make_seq_sharded_cache_update(
                jmesh, "data", "model"))
    pc = convert.cache_from_jax(jax.tree.map(np.asarray, cache), model.cfg)
    pc2 = [tuple(t.clone() for t in layer) for layer in pc]
    tok, ln = torch.as_tensor(tokens[:, S - 1:]), _t(lengths)
    lg_a = T.decode_step(model, tok, ln, pc)
    mesh = make_dev_mesh(1, 1, device="cpu")
    lg_b = T.decode_step(
        model, tok, ln, pc2,
        decode_attn_fn=TC.make_seq_sharded_decode_attn(mesh, "data",
                                                       "model"),
        decode_update_fn=TC.make_seq_sharded_cache_update(mesh, "data",
                                                          "model"))
    np.testing.assert_allclose(lg_b.numpy(), lg_a.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(lg_ref), rtol=2e-4,
                               atol=2e-4)
    for la, lb in zip(pc, pc2):
        for a, b in zip(la, lb):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4)


# --- across ranks: one spawned 2x2 gloo job ---------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of the 2x2 job (four processes)."""
    out = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_job.py"),
         str(r), "4", str(port), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", list(job.CASES))
def test_seq_sharded_attention_across_ranks(ranks, name):
    """Each rank's output (its batch rows, and its D slice with
    ``d_axis``) equals the reference's 1x1 result and the oracle on the
    whole inputs."""
    c = job.CASES[name]
    x = job.case_inputs(name)
    ref = _ref_attn(x, c["window"], c.get("batch_axis"), c.get("d_axis"))
    oracle = _oracle(x, c["window"])
    for res in ranks:
        at = dict(zip(("data", "model"), res["coords"]))
        b = job.part(c["B"], 2, at[c["batch_axis"]]) \
            if c.get("batch_axis") else slice(None)
        d = job.part(c["D"], 2, at[c["d_axis"]]) if c.get("d_axis") \
            else slice(None)
        np.testing.assert_allclose(res[name], ref[b, :, d], **TOL)
        np.testing.assert_allclose(res[name], oracle[b, :, d], **TOL)


def test_cache_update_and_decode_step_across_ranks(ranks):
    """The cache update writes its slot on the owning rank only (each
    rank's slice equals the reference's 1x1 update's, exactly); the hooked
    ``decode_step`` (reduced gemma3, rows over two ranks, batch over two)
    gives each rank's logits within 2e-4 of the unhooked step, every cache
    row but the written one bitwise unchanged and the written one within
    2e-4; the production mesh and the training launcher refuse the world
    of 4 ranks."""
    u = job.update_inputs()
    mesh = j_dev_mesh(1, 1)
    with mesh:
        want = jax.jit(JC.make_seq_sharded_cache_update(mesh, "data",
                                                        "model"))(
            *(jnp.asarray(u[k]) for k in ("ck", "cv", "k_new", "v_new",
                                          "slot")))
    wk, wv = np.asarray(want[0]), np.asarray(want[1])
    B, S = job.UPDATE["B"], job.UPDATE["S"]
    written = 0
    for res in ranks:
        d, m = res["coords"]
        b, s = job.part(B, 2, m), job.part(S, 2, d)
        np.testing.assert_array_equal(res["update_k"], wk[b, s])
        np.testing.assert_array_equal(res["update_v"], wv[b, s])
        written += int((res["update_k"] != u["ck"][b, s]).any(-1).any(-1)
                       .sum())
        np.testing.assert_allclose(res["logits_hooked"],
                                   res["logits_plain"], rtol=2e-4,
                                   atol=2e-4)
        slot = job.DECODE["S"] - 1
        for key in res:
            if not key.startswith("cache_plain_"):
                continue
            a, h = res[key], res[key.replace("plain", "hooked")]
            rows = a.shape[1]
            own = slot % (2 * rows) - d * rows
            keep = np.ones(rows, bool)
            if 0 <= own < rows:
                keep[own] = False
            np.testing.assert_array_equal(h[:, keep], a[:, keep])
            np.testing.assert_allclose(h, a, rtol=2e-4, atol=2e-4)
    assert written == B                  # one slot a sequence, once
    for res in ranks:    # a world of 4: no production mesh, and the
        # launcher trains on it only on a given mesh
        assert "needs a process group of 256 ranks" in str(res["mesh_error"])
        assert "a world of 4 ranks needs a mesh to train on" in str(
            res["launcher_error"])
