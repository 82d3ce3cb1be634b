"""Training launcher.

Port of ``src/repro/launch/train.py``, with the same flags.  It runs on the
CUDA card (the port's default device; the flash-prefill kernel and its
backward kernel are built at first use).

Dev mode (default) trains a reduced variant of the selected arch on the
synthetic pipeline.  ``--production`` trains the full config with
``remat``, as the reference's production mode does: on one card with no
mesh (the reference's 1x1 dev mesh) in a world of one rank, on the
reference's 16x16 production mesh (``launch/mesh.py``) in a world of 256.
``--multi-pod`` builds the 2x16x16 mesh, which raises a ``ValueError``
unless the process group holds its 512 ranks.  ``train(args, mesh=...)``
trains on a given ``DeviceMesh`` (tests, the smoke).  A world of more than
one rank with no mesh raises.  An arch with ``ssd`` layers trains through
the SSD-scan kernel and its backward kernel.

On a mesh, as the reference's production mode: the parameters and AdamW
moments laid out by ``sharding.rules_for_config`` (``sharding.shard_model``:
each rank holds its blocks, built from the same seed on every rank), each
step's global batch built the same on every rank and cut to this rank's
rows by ``data_spec`` (``sharding.shard_of``; a frontend stub's rows with
its tokens), the sharded train step (``training.train``); rank 0 alone
prints.  As there, no activation sharding (``distributed.actsharding``).
A world of more than one rank is a process group the caller starts
(``python -m`` under ``torchrun`` joins the one its environment names).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --production --batch 1 --seq 4096 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --production --batch 1 --seq 4096 --steps 5
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)
from repro_torch.data.pipeline import DataConfig, SyntheticLM, frontend_stub
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import PRODUCTION_WORLDS, make_production_mesh
from repro_torch.models import module as nn, transformer as T
from repro_torch.training import checkpoint as ckpt, optimizer as opt, \
    train as TR

#: the reference's dev mesh, (1, 1): one card, nothing sharded (the
#: launcher builds no process group for it)
MESH = {"data": 1, "model": 1}
#: metrics of a step the launcher returns (as floats)
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-14b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--production", action="store_true",
                    help="full config (one card, remat)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default="")
    return ap


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(args, dev, mesh):
    """The mesh to train on: ``mesh`` as given; the production mesh for
    ``--multi-pod`` (raising unless the world holds its 512 ranks) or for
    ``--production`` in a world of 256; None (one card, nothing sharded) in
    a world of one rank; else a ``ValueError``."""
    if mesh is not None:
        return mesh
    if args.multi_pod:
        return make_production_mesh(multi_pod=True, device=dev)
    if args.production and _world() == PRODUCTION_WORLDS[0]:
        return make_production_mesh(device=dev)
    if _world() > 1:
        raise ValueError(
            f"a world of {_world()} ranks needs a mesh to train on: pass "
            "mesh= (a DeviceMesh of its ranks, e.g. launch.mesh."
            "make_dev_mesh), or --production on a world of "
            f"{PRODUCTION_WORLDS[0]} ranks, or --multi-pod on "
            f"{PRODUCTION_WORLDS[1]}")
    return None


def train(args, *, device=None, mesh=None, on_start=None,
          cfg=None) -> dict:
    """Train as ``main`` does on ``device`` (default the card): build the
    model (seed 0, training storage) and AdamW state, run ``args.steps``
    steps on the synthetic batches, print the reference's lines and save
    with ``--ckpt``.  On a mesh (``mesh``, or the production mesh the
    flags and world call for: ``_mesh``) the model is sharded and each
    rank trains on its rows (module docstring).  ``cfg`` replaces the
    arch's config (a cut of it: the smoke trains two layers at full
    width).  ``on_start(model)``, when given, runs before the first step.
    Returns {"cfg", "model", "opt_state", "mesh", "losses" (float, one a
    step), "metrics" (a dict of floats a step, ``METRICS``), "step_s"
    (synchronised wall seconds a step)}."""
    dev = resolve_device(device)
    mesh = _mesh(args, dev, mesh)
    if cfg is None:
        cfg = get_config(args.arch) if args.production \
            else get_reduced_config(args.arch)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    split = None if mesh is None else SH.batch_split(mesh, args.batch)
    step = TR.make_train_step(cfg, ocfg, remat=args.production, split=split)
    model = T.init_model(0, cfg, device=dev, train=True)
    if mesh is not None:
        SH.shard_model(model, mesh)
    lead = mesh is None or dist.get_rank() == 0
    sizes = MESH if mesh is None else SH.mesh_sizes(mesh)
    if lead:
        print(f"{cfg.name}: {nn.param_count(model)/1e6:.1f}M params, "
              f"mesh={sizes}", flush=True)
    ost = opt.init(dict(model.named_parameters()))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))

    def rows(x):
        """This rank's rows of a global [B, ...] array, on the device."""
        x = torch.as_tensor(x).to(dev)
        if mesh is None:
            return x
        return SH.shard_of(x, SH.data_spec(mesh, x.ndim, batch=args.batch),
                           mesh).contiguous()
    frontend = None
    if cfg.frontend:
        frontend = torch.as_tensor(frontend_stub(
            cfg.frontend, args.batch, cfg.frontend_len,
            cfg.frontend_dim)).to(dev)
        if mesh is not None:
            # the stub's seed is a str hash, salted per process: rank 0's
            dist.broadcast(frontend, src=0)
        frontend = rows(frontend)
    if on_start is not None:
        on_start(model)
    losses, metrics, step_s = [], [], []
    t0 = time.time()
    for i, b in zip(range(args.steps), data.batches()):
        t1 = time.perf_counter()
        batch = {"tokens": rows(b["tokens"]), "mask": rows(b["mask"])}
        if frontend is not None:
            batch["frontend"] = frontend
        model, ost, m = step(model, ost, batch)
        metrics.append({k: float(m[k]) for k in METRICS})   # synchronises
        losses.append(metrics[-1]["loss"])
        step_s.append(time.perf_counter() - t1)
        if lead and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt, model, ost, step=args.steps)
        if lead:
            print("saved", args.ckpt)
    return dict(cfg=cfg, model=model, opt_state=ost, mesh=mesh,
                losses=losses, metrics=metrics, step_s=step_s)


def main() -> None:
    args = parser().parse_args()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # under torchrun: join the process group its environment names
        dist.init_process_group(
            "nccl" if resolve_device(None).type == "cuda" else "gloo")
    train(args)


if __name__ == "__main__":
    main()
