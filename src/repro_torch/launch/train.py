"""Training launcher.

Port of ``src/repro/launch/train.py``, with the same flags.  It runs on the
CUDA card (the port's default device; the flash-prefill kernel and its
backward kernel are built at first use).

Dev mode (default) trains a reduced variant of the selected arch on the
synthetic pipeline.  ``--production`` trains the full config with
``remat``, as the reference's production mode does, on one card under the
1x1 dev mesh.  ``--multi-pod`` builds the reference's 2x16x16 production
mesh (``launch/mesh.py``), which raises a ``ValueError`` unless the
process group holds its 512 ranks; a world of more than one rank raises
too, as the train step sharded across ranks is not ported yet (ROADMAP.md
section 1, "The train step sharded across more than one rank").  An arch
with ``ssd`` layers trains through the SSD-scan kernel and its backward
kernel.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --production --batch 1 --seq 4096 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --production --batch 1 --seq 4096 --steps 5
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)
from repro_torch.data.pipeline import DataConfig, SyntheticLM, frontend_stub
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import module as nn, transformer as T
from repro_torch.training import checkpoint as ckpt, optimizer as opt, \
    train as TR

#: the reference's dev mesh, (1, 1): one card, nothing sharded (the
#: launcher builds no process group for it)
MESH = {"data": 1, "model": 1}


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


def train(args, *, device=None, on_start=None) -> dict:
    """Train as ``main`` does on ``device`` (default the card): build the
    model (seed 0, training storage) and AdamW state, run ``args.steps``
    steps on the synthetic batches, print the reference's lines and save
    with ``--ckpt``.  ``on_start(model)``, when given, runs before the
    first step.  Returns {"cfg", "model", "opt_state", "losses" (float, one
    a step), "step_s" (synchronised wall seconds a step)}."""
    dev = resolve_device(device)
    if args.multi_pod:
        # raises unless the world holds the mesh's 512 ranks
        make_production_mesh(multi_pod=True, device=dev)
    if args.multi_pod or (dist.is_initialized()
                          and dist.get_world_size() > 1):
        raise ValueError(
            "--multi-pod / a world of more than one rank: the train step "
            "sharded across more than one rank is not ported yet "
            "(ROADMAP.md section 1, \"The train step sharded across more "
            "than one rank\"); the launcher trains on one card")
    cfg = get_config(args.arch) if args.production \
        else get_reduced_config(args.arch)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    step = TR.make_train_step(cfg, ocfg, remat=args.production)
    model = T.init_model(0, cfg, device=dev, train=True)
    print(f"{cfg.name}: {nn.param_count(model)/1e6:.1f}M params, "
          f"mesh={MESH}", flush=True)
    ost = opt.init(dict(model.named_parameters()))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    frontend = None
    if cfg.frontend:
        frontend = torch.as_tensor(frontend_stub(
            cfg.frontend, args.batch, cfg.frontend_len,
            cfg.frontend_dim)).to(dev)
    if on_start is not None:
        on_start(model)
    losses, step_s = [], []
    t0 = time.time()
    for i, b in zip(range(args.steps), data.batches()):
        t1 = time.perf_counter()
        batch = {"tokens": torch.as_tensor(b["tokens"]).to(dev),
                 "mask": torch.as_tensor(b["mask"]).to(dev)}
        if frontend is not None:
            batch["frontend"] = frontend
        model, ost, m = step(model, ost, batch)
        losses.append(float(m["loss"]))        # synchronises
        step_s.append(time.perf_counter() - t1)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt, model, ost, step=args.steps)
        print("saved", args.ckpt)
    return dict(cfg=cfg, model=model, opt_state=ost, losses=losses,
                step_s=step_s)


def main() -> None:
    train(parser().parse_args())


if __name__ == "__main__":
    main()
