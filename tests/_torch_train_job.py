"""One rank of the 2x2 gloo job behind ``tests/test_torch_train_sharded.py``.

    PYTHONPATH=src python tests/_torch_train_job.py RANK WORLD PORT DIR

Joins a CPU process group of WORLD (4) ranks through gloo at
tcp://localhost:PORT and builds the port's ("data", "model") = (2, 2) dev
mesh.  For each case of ``CASES`` it loads the full initial parameters the
test process wrote (DIR/<case>_init.npz, the reference's weights in the
port's names) and the global batches (DIR/<case>_batches.npz), lays the
model out on the mesh (``sharding.shard_model``), and runs ``STEPS``
sharded train steps on this rank's rows of each batch (``data_spec``).
Then the launcher: ``launch.train.train(args, device="cpu", mesh=...)``
with ``LAUNCHER_ARGV`` and a checkpoint, restored afterwards into a model
sharded from another seed.  Writes each rank's metrics, local shapes and
bytes (DIR/rank{RANK}.json) and rank 0's gathered parameters
(DIR/<case>_final.npz).  Imports torch and the port only (the test process
computes the JAX package's results).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np

#: the sharded cases: arch, global batch B (S = SEQ tokens) and the config
#: changes; every QKV bias off (the key bias's gradient is zero in exact
#: arithmetic, so AdamW moves it by the sign of rounding noise, which
#: differs from run to run: ``test_torch_train.py`` does the same)
CASES = {
    # KvH = 1 on the 2-way "model" axis: wk / wv replicate over it
    "starcoder2": dict(arch="starcoder2-3b", B=4),
    "mamba2": dict(arch="mamba2-780m", B=4),
    # C = int(0.5 T K / X) + 1: 25 rows an expert for the global T = 96,
    # 13 for one rank's 48; the dispatch drops pairs
    "mixtral": dict(arch="mixtral-8x22b", B=4, capacity_factor=0.5),
    "seamless": dict(arch="seamless-m4t-medium", B=4),
    # one sequence on data = 2: data_spec replicates the batch
    "batch1": dict(arch="starcoder2-3b", B=1),
}
SEQ, STEPS = 24, 2
#: AdamW with eps 1e-6 (the reference's default is 1e-8): AdamW moves an
#: element by about lr g / (|g| + eps), so float32 rounding of a gradient
#: near eps moves it by a share of lr that rounding decides; at eps 1e-8
#: the port's unsharded step already differs from the reference's by up to
#: 1.6e-4 (16% of lr) on these batches, past ``test_torch_train.py``'s
#: ``STEP_TOL``, and the sharded step by as much.  At 1e-6 rounding moves
#: an element by about 1e-3 lr, so the element-wise checks see the steps
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
LAUNCHER_ARGV = ["--arch", "starcoder2-3b", "--steps", "2", "--batch", "4",
                 "--seq", "16"]


def case_config(name: str):
    from repro_torch.configs.registry import get_reduced_config
    c = CASES[name]
    cfg = get_reduced_config(c["arch"])
    return dataclasses.replace(cfg, qkv_bias=False, **{
        k: v for k, v in c.items() if k not in ("arch", "B")})


def batches(name: str, vocab: int, frontend=None) -> list[dict]:
    """STEPS global batches of a case: seeded tokens, a mask with padded
    tails of different lengths (so the ranks' token counts differ) and,
    for a frontend config (frontend_len, frontend_dim), its embeddings."""
    B = CASES[name]["B"]
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(100 + i)
        mask = np.ones((B, SEQ), np.int32)
        mask[-1, 17 - 4 * i:] = 0
        if B > 2:
            mask[1, 9:] = 0
        b = {"tokens": rng.integers(0, vocab, (B, SEQ)).astype(np.int32),
             "mask": mask}
        if frontend is not None:
            b["frontend"] = rng.standard_normal(
                (B, *frontend)).astype(np.float32)
        out.append(b)
    return out


def _sizes(t) -> list:
    return list(t.to_local().shape)


def main(rank: int, world: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as C, optimizer as O, \
        train as TR
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    mesh = make_dev_mesh(2, 2, device="cpu")
    res = {"coords": [mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")]}
    for name, c in CASES.items():
        cfg = case_config(name)
        model = T.Transformer(cfg, device="cpu", train=True)
        with np.load(f"{out}/{name}_init.npz") as f:
            SH.load_full(dict(model.named_parameters()), dict(f))
        SH.shard_model(model, mesh)
        split = SH.batch_split(mesh, c["B"])
        step = TR.make_train_step(cfg, O.AdamWConfig(**OPT), remat=True,
                                  split=split)
        ost = O.init(dict(model.named_parameters()))
        with np.load(f"{out}/{name}_batches.npz") as f:
            flat = dict(f)
        metrics = []
        for i in range(STEPS):
            batch = {}
            for key in ("tokens", "mask", "frontend"):
                if f"{i}/{key}" in flat:
                    x = flat[f"{i}/{key}"]
                    x = SH.shard_of(x, SH.data_spec(mesh, x.ndim,
                                                    batch=c["B"]), mesh)
                    batch[key] = torch.as_tensor(np.ascontiguousarray(x))
            batch["tokens"] = batch["tokens"].long()
            model, ost, m = step(model, ost, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        params = dict(model.named_parameters())
        full = SH.full_values(model)
        if rank == 0:
            np.savez(f"{out}/{name}_final.npz",
                     **{n: v.numpy() for n, v in full.items()})
        res[name] = dict(
            metrics=metrics, split=list(split.axes),
            rows=int(batch["tokens"].shape[0]),
            shapes={n: [_sizes(p), _sizes(ost.m[n]), _sizes(ost.v[n])]
                    for n, p in params.items()},
            bytes=sum(t.to_local().numel() * t.to_local().element_size()
                      for n, p in params.items()
                      for t in (p, ost.m[n], ost.v[n]))
            + ost.step.numel() * ost.step.element_size())
    # the launcher on the mesh, with a checkpoint
    buf = io.StringIO()
    args = LT.parser().parse_args(LAUNCHER_ARGV + ["--ckpt", f"{out}/ck"])
    with contextlib.redirect_stdout(buf):
        run = LT.train(args, device="cpu", mesh=mesh)
    full = SH.full_values(run["model"])
    if rank == 0:
        np.savez(f"{out}/launcher_final.npz",
                 **{n: v.numpy() for n, v in full.items()})
    fresh = T.init_model(5, run["cfg"], device="cpu", train=True)
    SH.shard_model(fresh, mesh)
    fost = O.init(dict(fresh.named_parameters()))
    C.restore(f"{out}/ck", fresh, fost)
    got = dict(fresh.named_parameters())
    res["launcher"] = dict(
        lines=buf.getvalue().splitlines(), metrics=run["metrics"],
        restored_blocks_equal=all(
            torch.equal(p.to_local(), got[n].to_local())
            and torch.equal(run["opt_state"].m[n].to_local(),
                            fost.m[n].to_local())
            and torch.equal(run["opt_state"].v[n].to_local(),
                            fost.v[n].to_local())
            for n, p in run["model"].named_parameters()),
        restored_step=int(fost.step))
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
