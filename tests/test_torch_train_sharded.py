"""The port's train step sharded across ranks (``distributed.sharding.
shard_model``, ``distributed.fsdp``, ``training.train`` with a ``split``,
``launch.train.train(mesh=...)``) against the JAX package's jitted step and
the port's unsharded step, on the CPU through gloo.

One spawned 2x2 gloo job (``_torch_train_job.py``, four processes, a
module fixture) trains every case of ``_torch_train_job.CASES`` two steps
on its ("data", "model") = (2, 2) mesh from the reference's weights (with
seeded noise on the parameters initialised to zeros or ones); meanwhile
this process runs the reference's ``jax.jit(make_train_step)`` on its 1x1
mesh and the port's unsharded step on the same weights and batches.  Each
case holds, on every rank:

* ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` against the
  reference within ``test_torch_train.py``'s tolerances (rel 1e-5, abs
  1e-6), with the clip active (``grad_norm`` > ``clip_norm``), and the
  gathered parameters within its ``STEP_TOL`` / ``UPDATE_RTOL``;
* the same against the port's unsharded step within ``PORT_TOL`` /
  ``PORT_UPDATE_RTOL`` (``PORT_TOL`` below says why they are tighter);
* every local block of a parameter and of both AdamW moments of its spec's
  shape, and each rank's bytes the dry run's per-device training bytes.

The MoE case's dispatch is shown to need the global batch (one rank's rows
alone dispatch other pairs), and the batch of one on data = 2 replicates
the batch (a gradient summed over "data" would double ``grad_norm``).  The
launcher on the mesh prints the reference's lines on rank 0 alone and its
2x2 checkpoint restores in both packages and into a sharded model.  With
no spawn: a one-rank 1x1 mesh trains bitwise as the unsharded launcher.
"""
import contextlib
import dataclasses
import io
import json
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

from repro.configs.registry import get_reduced_config
from repro.launch.mesh import make_dev_mesh as j_dev_mesh
from repro.models import module as jnn, transformer as JT
from repro.training import checkpoint as JC, optimizer as JO, train as JTR
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import fsdp, sharding as SH
from repro_torch.launch import dryrun, train as t_train
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import convert, transformer as TT
from repro_torch.training import checkpoint as TC, optimizer as TO, \
    train as TTR
import _torch_train_job as job
from _torch_parity import jax_and_port_model, one_torch_thread, port_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = SH.MeshShape({"data": 2, "model": 2})
#: ``test_torch_train.py``'s tolerances against the reference
METRIC_TOL = dict(rel=1e-5, abs=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-4)
UPDATE_RTOL = 1e-3
#: against the port's unsharded step: the same ops on the same float32
#: values, but GEMMs over each rank's rows and gradients summed across
#: ranks (float32 sums in another order); measured on the CPU: metrics
#: within 2.4e-7 relative, elements within 1.3e-6, each parameter's update
#: within 2.5e-5 of the unsharded update (Frobenius), against 8e-6 and
#: 6.2e-5 from the reference: a quarter of each bound
PORT_METRIC_TOL = dict(rel=1e-6, abs=1e-7)
PORT_TOL = dict(rtol=1e-6, atol=5e-6)
PORT_UPDATE_RTOL = 1e-4
CASES = list(job.CASES)
JOB_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _noise() -> dict:
    return dict(ssd_seed=4, rglru_seed=5, cross_seed=6)


def _port_batch(b: dict) -> dict:
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tb["tokens"] = tb["tokens"].long()
    return tb


def _reference(cfg, params, batches) -> tuple:
    """The reference's jitted step, two steps on its 1x1 dev mesh: (metrics
    a step, the final parameters)."""
    mesh = j_dev_mesh(1, 1)
    with mesh:
        jstep = jax.jit(JTR.make_train_step(cfg, JO.AdamWConfig(**job.OPT),
                                            remat=True))
        st = JO.init(params)
        metrics = []
        for b in batches:
            params, st, m = jstep(params, st, {k: jnp.asarray(v)
                                              for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, params)


def _unsharded(cfg, model, batches) -> tuple:
    step = TTR.make_train_step(port_arch(cfg), TO.AdamWConfig(**job.OPT),
                               remat=True)
    st = TO.init(dict(model.named_parameters()))
    metrics = []
    for b in batches:
        model, st, m = step(model, st, _port_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}


def _spawn(out: pathlib.Path) -> list:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_train_job.py"),
         str(r), "4", str(port), str(out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the job, compute the reference's and the unsharded port's
    runs while it trains, then read every rank's results."""
    out = tmp_path_factory.mktemp("train_job")
    cases = {}
    for name in CASES:
        cfg = job.case_config(name)
        params, model = jax_and_port_model(cfg, 1, train=True, **_noise())
        fe = (cfg.frontend_len, cfg.frontend_dim) if cfg.frontend else None
        batches = job.batches(name, cfg.vocab, fe)
        np.savez(out / f"{name}_init.npz", **{
            n: p.detach().numpy() for n, p in model.named_parameters()})
        np.savez(out / f"{name}_batches.npz", **{
            f"{i}/{k}": v for i, b in enumerate(batches)
            for k, v in b.items()})
        before = {n: p.detach().numpy().copy()
                  for n, p in model.named_parameters()}
        cases[name] = dict(cfg=cfg, params=params, model=model,
                           batches=batches, before=before)
    procs = _spawn(out)
    try:
        for c in cases.values():
            c["ref_metrics"], ref = _reference(c["cfg"], c["params"],
                                               c["batches"])
            c["ref"] = convert.values_from_jax(ref, c["model"])
            c["port_metrics"], c["port"] = _unsharded(c["cfg"], c["model"],
                                                      c["batches"])
        logs = [p.communicate(timeout=JOB_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            log[-4000:] for log in logs))
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)]
    for name, c in cases.items():
        with np.load(out / f"{name}_final.npz") as f:
            c["sharded"] = dict(f)
    return dict(out=out, cases=cases, ranks=ranks)


def _assert_metrics(got: dict, want: dict, tol: dict, what: str) -> None:
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert got[key] == pytest.approx(want[key], **tol), (what, key,
                                                             got, want)


def _assert_params(got: dict, want: dict, before: dict, tol: dict,
                   update_rtol: float, what: str) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, **tol,
                                   err_msg=f"{what} {name}")
        upd, upd_want = got[name] - before[name], w - before[name]
        assert np.linalg.norm(upd - upd_want) <= update_rtol * \
            np.linalg.norm(upd_want), (what, name)
        assert np.linalg.norm(upd_want) > 0, (what, name)


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_reference(runs, name):
    c = runs["cases"][name]
    clip = TO.AdamWConfig(**job.OPT).clip_norm
    for res in runs["ranks"]:
        for got, want in zip(res[name]["metrics"], c["ref_metrics"]):
            assert want["grad_norm"] > clip          # the clip is active
            _assert_metrics(got, want, METRIC_TOL, name)
    _assert_params(c["sharded"], c["ref"], c["before"], STEP_TOL,
                   UPDATE_RTOL, name)


@pytest.mark.parametrize("name", CASES)
def test_sharded_step_matches_unsharded_port(runs, name):
    c = runs["cases"][name]
    first = runs["ranks"][0][name]["metrics"]
    for res in runs["ranks"]:
        assert res[name]["metrics"] == first           # every rank agrees
        for got, want in zip(res[name]["metrics"], c["port_metrics"]):
            _assert_metrics(got, want, PORT_METRIC_TOL, name)
    _assert_params(c["sharded"], c["port"], c["before"], PORT_TOL,
                   PORT_UPDATE_RTOL, name)


@pytest.mark.parametrize("name", CASES)
def test_local_blocks_follow_the_specs(runs, name):
    """Each rank's block of every parameter and of both moments has its
    spec's shape (each dimension over the product of its mesh axes'
    sizes), and the rank holds exactly the dry run's per-device parameter
    and optimizer bytes for the mesh."""
    cfg = runs["cases"][name]["cfg"]
    meta = TT.Transformer(port_arch(cfg), device="meta", train=True)
    specs = SH.param_shardings(meta, MESH, SH.rules_for_config(cfg))
    sizes = SH.mesh_sizes(MESH)
    want = {n: [int(d) // SH._axis_size(sizes, ax)
                for d, ax in zip(p.shape, specs[n])]
            for n, p in meta.named_parameters()}
    plan = dryrun.argument_bytes(cfg, "train", job.CASES[name]["B"],
                                 job.SEQ, MESH)
    assert any(ax is not None for s in specs.values() for ax in s)
    for res in runs["ranks"]:
        assert sorted(res[name]["shapes"]) == sorted(want)
        for n, shapes in res[name]["shapes"].items():
            assert shapes == [want[n]] * 3, (n, specs[n])
        assert res[name]["bytes"] == plan["port_params"] + plan["optimizer"]


def test_kv_projections_replicate_over_model(runs):
    """starcoder2's reduced config has one KV head: on the 2-way "model"
    axis its KV projections fall back to replication there (sharded over
    "data" alone), as the reference's divisibility fallback."""
    for res in runs["ranks"]:
        shapes = res["starcoder2"]["shapes"]
        wk = shapes["blocks.0.mixer.wk"][0]
        wq = shapes["blocks.0.mixer.wq"][0]
        cfg = runs["cases"]["starcoder2"]["cfg"]
        assert wk == [cfg.d_model // 2, 1, cfg.head_dim_]
        assert wq == [cfg.d_model // 2, cfg.n_heads // 2, cfg.head_dim_]


def test_moe_dispatch_needs_the_global_batch(runs):
    """At this capacity one rank's rows alone (C from its own T) dispatch
    another set of pairs than the global batch does: the first MoE layer's
    output differs for some token, so the match with the reference rests on
    the global dispatch."""
    c = runs["cases"]["mixtral"]
    model = TT.Transformer(port_arch(c["cfg"]), device="cpu", train=True)
    SH.load_full(dict(model.named_parameters()), c["before"])
    moe, seen = model.blocks[0].ffn, []
    run_capacity = moe.capacity

    def capture(x, split=None):
        seen.append(x.detach())
        return run_capacity(x, split)
    moe.capacity = capture
    with torch.no_grad():
        TT.forward(model, _port_batch(c["batches"][0])["tokens"])
        x = seen[0]
        y_global = run_capacity(x)[0]
        half = x.shape[0] // 2
        y_ranks = torch.cat([run_capacity(x[:half])[0],
                             run_capacity(x[half:])[0]])
    diff = (y_global - y_ranks).abs().amax(-1)
    assert int((diff > 1e-3 * y_global.abs().max()).sum()) > 0


def test_batch_of_one_is_replicated_over_data(runs):
    """One sequence on data = 2: no batch axis, every rank holds the row,
    and the gradient norm is the reference's, not twice it (a gradient
    summed over "data" would double it)."""
    c = runs["cases"]["batch1"]
    for res in runs["ranks"]:
        assert res["batch1"]["split"] == [] and res["batch1"]["rows"] == 1
        assert res["starcoder2"]["split"] == ["data"]
        assert res["starcoder2"]["rows"] == 2
        for got, want in zip(res["batch1"]["metrics"], c["ref_metrics"]):
            assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                     rel=1e-5)


def _launcher_reference(argv: list) -> tuple:
    """The unsharded launcher in this process, and the reference's jitted
    step from the launcher's initial weights on its batches."""
    args = t_train.parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = t_train.train(args, device="cpu")
    cfg = get_reduced_config(args.arch)
    init = TT.init_model(0, port_arch(cfg), device="cpu", train=True)
    params = jax.tree.map(jnp.asarray, convert.to_jax_tree(init))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    ocfg = JO.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    jstep = jax.jit(JTR.make_train_step(cfg, ocfg, remat=False))
    st, ref = JO.init(params), []
    for _, b in zip(range(args.steps), data.batches()):
        params, st, m = jstep(params, st, {"tokens": jnp.asarray(b["tokens"]),
                                           "mask": jnp.asarray(b["mask"])})
        ref.append({k: float(v) for k, v in m.items()})
    return out, buf.getvalue().splitlines(), ref, cfg, \
        convert.values_from_jax(jax.tree.map(np.asarray, params), init)


def test_launcher_trains_on_the_mesh(runs):
    """``train(args, device="cpu", mesh=...)`` on the 2x2 mesh: rank 0
    prints the reference's lines (its parameter count, the mesh, a loss a
    step, the checkpoint), the other ranks nothing; every step's metrics
    match the reference's jitted step and the unsharded launcher, and the
    gathered parameters the reference's."""
    out, lines, ref, cfg, ref_params = _launcher_reference(
        job.LAUNCHER_ARGV)
    n = jnn.param_count(jax.eval_shape(lambda: JT.init_model(0, cfg)[0]))
    ranks = runs["ranks"]
    got = ranks[0]["launcher"]["lines"]
    assert got[0] == (f"{cfg.name}: {n/1e6:.1f}M params, "
                      "mesh={'data': 2, 'model': 2}")
    assert [ln.split(" (")[0] for ln in got[1:3]] == \
        [ln.split(" (")[0] for ln in lines[1:3]]
    assert got[3] == f"saved {runs['out'] / 'ck'}"
    assert all(r["launcher"]["lines"] == [] for r in ranks[1:])
    for r in ranks:
        for m, w, u in zip(r["launcher"]["metrics"], ref, out["metrics"]):
            _assert_metrics(m, w, METRIC_TOL, "launcher")
            _assert_metrics(m, u, PORT_METRIC_TOL, "launcher")
    with np.load(runs["out"] / "launcher_final.npz") as f:
        sharded = dict(f)
    for name, w in ref_params.items():
        np.testing.assert_allclose(sharded[name], w, **STEP_TOL,
                                   err_msg=name)


def test_sharded_checkpoint_restores_in_both_packages(runs):
    """The launcher's checkpoint saved on the 2x2 mesh holds the gathered
    parameters in the reference's files: the reference restores it, the
    unsharded port restores it, and a model sharded from another seed
    restored from it holds the saved blocks and moments on every rank."""
    ck = runs["out"] / "ck"
    with np.load(runs["out"] / "launcher_final.npz") as f:
        final = dict(f)
    cfg = get_reduced_config("starcoder2-3b")
    like = jax.tree.map(jnp.zeros_like,
                        jax.eval_shape(lambda: JT.init_model(0, cfg)[0]))
    params, st, meta = JC.restore(str(ck), like, JO.init(like))
    assert meta == {"step": 2} and int(st.step) == 2
    model = TT.init_model(3, port_arch(cfg), device="cpu", train=True)
    ost = TO.init(dict(model.named_parameters()))
    _, ost, _ = TC.restore(str(ck), model, ost)
    want = convert.values_from_jax(jax.tree.map(np.asarray, params), model)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(want[name], final[name])
        np.testing.assert_array_equal(p.detach().numpy(), final[name])
    m_ref = convert.values_from_jax(jax.tree.map(np.asarray, st.m), model)
    for name, m in ost.m.items():
        np.testing.assert_array_equal(m.numpy(), m_ref[name])
    for r in runs["ranks"]:
        assert r["launcher"]["restored_blocks_equal"]
        assert r["launcher"]["restored_step"] == 2


def test_one_rank_mesh_trains_bitwise_as_unsharded():
    """``train`` on a one-rank 1x1 mesh (a gloo group in this process):
    the same metrics, parameters and moments as the unsharded launcher, bit
    for bit (no collective runs on a mesh of size-1 dimensions)."""
    argv = ["--arch", "mixtral-8x22b", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    args = t_train.parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        plain = t_train.train(args, device="cpu")
        sharded = t_train.train(args, device="cpu",
                                mesh=make_dev_mesh(1, 1, device="cpu"))
    assert sharded["metrics"] == plain["metrics"]
    assert sharded["model"].mesh is not None
    full = SH.full_values(sharded["model"])
    moments = SH.full_values(sharded["model"], sharded["opt_state"].v)
    for name, p in plain["model"].named_parameters():
        assert torch.equal(full[name], p.detach()), name
        assert torch.equal(moments[name], plain["opt_state"].v[name]), name


@pytest.mark.parametrize("name", ["starcoder2-3b", "mixtral-8x22b"])
def test_shard_model_on_one_rank_keeps_every_value(name):
    """``shard_model`` on a 1x1 mesh keeps every value, and ``full_values``
    gives them back."""
    model = TT.init_model(2, port_arch(get_reduced_config(name)),
                          device="cpu", train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    SH.shard_model(model, make_dev_mesh(1, 1, device="cpu"))
    full = SH.full_values(model)
    for n, v in before.items():
        assert torch.equal(full[n], v), n


class _Coords:
    """A mesh's sizes and one rank's coordinates, as ``local_block`` reads
    them."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, i):
        return self.coords[i]


def test_local_block_splits_major_to_minor():
    """On a ("pod", "data", "model") = (2, 2, 2) mesh, a dimension split
    over ("pod", "data") gives rank (p, d) block 2 p + d, as a
    ``PartitionSpec`` splits it, and the other dimension its "model" block:
    the eight ranks' blocks tile the array once.  A split that does not
    divide raises."""
    from torch.distributed.tensor import Replicate, Shard
    x = np.arange(8 * 6 * 3).reshape(8, 6, 3)
    seen = np.zeros(x.shape, int)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                block = fsdp.local_block(x, _Coords((2, 2, 2), (p, d, m)),
                                         [Shard(0), Shard(0), Shard(1)])
                rows = slice((2 * p + d) * 2, (2 * p + d + 1) * 2)
                cols = slice(m * 3, (m + 1) * 3)
                np.testing.assert_array_equal(block, x[rows, cols])
                seen[rows, cols] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="does not split"):
        fsdp.local_block(x, _Coords((2, 2, 2), (0, 0, 0)),
                         [Replicate(), Shard(2), Replicate()])
