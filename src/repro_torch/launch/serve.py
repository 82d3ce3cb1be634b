"""Serving launcher: multi-tenant Arcus-shaped model serving.

Port of ``src/repro/launch/serve.py``, with the same flags and the same
request mix.  Like the reference it serves the reduced variant of the
selected arch (real token generation through the continuous-batching
engine), virtual-clocked by the FULL config's roofline cost model, with
per-tenant SLOs enforced by the Arcus token buckets.  It runs on the CUDA
card (the port's default device; the attention, SSD-scan and token-bucket
kernels are built at first use).  It serves every decoder-only config (the
dense attention models, recurrentgemma-9b, mixtral-8x22b,
llama4-maverick-400b-a17b and mamba2-780m).  It refuses a config with a
frontend (llama-3.2-vision-11b, seamless-m4t-medium) with a ``ValueError``
before building anything: its scheduler admits requests with no frontend
embeddings, as the reference's launcher does, and the reference fails
there.  The port's ``ServingEngine.admit(req, frontend)`` serves those
configs (``chip_smoke.py`` drives it).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
        --tenants 1200,800 --duration 3
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b

The cost model's target is ``--chips`` cards of the port's default
``HardwareSpec`` (H100 SXM data-sheet peaks).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_reduced_config)
from repro_torch.core.flow import SLO
from repro_torch.models import transformer as T
from repro_torch.serving.costmodel import HardwareSpec, StepCostModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request, Tenant
from repro_torch.serving.scheduler import ArcusScheduler, FCFSScheduler


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-12b")
    ap.add_argument("--tenants", default="1200,800",
                    help="comma-separated tokens/s SLOs")
    ap.add_argument("--background", action="store_true", default=True,
                    help="add an opportunistic background tenant")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--unshaped", action="store_true",
                    help="FCFS baseline instead of Arcus shaping")
    return ap


def make_tenants(slos: list[float], background: bool) -> list[Tenant]:
    tenants = [Tenant(i, SLO.iops(s), "reserved")
               for i, s in enumerate(slos)]
    if background:
        tenants.append(Tenant(len(tenants), SLO.iops(1e9), "opportunistic"))
    return tenants


def submit_mix(sched: ArcusScheduler, vocab: int, n_slos: int,
               duration: float, background: bool) -> int:
    """The launcher's request mix: 24 background 64-token prompts (16 new
    tokens each), then 16 rounds of one 12-token prompt per reserved tenant
    (6 new tokens each) arriving every duration / 32 s.  Returns the number
    of requests."""
    rng = np.random.default_rng(0)
    rid = 0
    if background:
        for _ in range(24):
            sched.submit(Request(rid, n_slos,
                                 list(rng.integers(0, vocab, 64)), 16))
            rid += 1
    for k in range(16):
        for tid in range(n_slos):
            sched.submit(Request(rid, tid,
                                 list(rng.integers(0, vocab, 12)), 6,
                                 arrive_s=k * duration / 32))
            rid += 1
    return rid


def serve(args: argparse.Namespace, *, device=None,
          hw: HardwareSpec | None = None):
    """Build the reduced model, engine and scheduler, submit the mix and
    run it.  Returns (scheduler, tenants, cfg).  ``hw`` replaces the cost
    model's target (default: ``--chips`` cards of ``HardwareSpec()``).
    Raises ``ValueError`` for an arch with a frontend (module docstring)."""
    frontend = get_config(args.arch).frontend
    if frontend:
        raise ValueError(
            f"{args.arch}: the launcher's scheduler admits requests with no "
            f"frontend embeddings, as the reference's launcher does, and "
            f"the reference fails there; this arch needs its {frontend} "
            f"frontend's (ServingEngine.admit(req, frontend))")
    cfg = get_reduced_config(args.arch)
    model = T.init_model(0, cfg, device=device)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           max_len=256, device=device)
    cost = StepCostModel(get_config(args.arch),
                         hw or HardwareSpec(chips=args.chips))
    slos = [float(x) for x in args.tenants.split(",")]
    tenants = make_tenants(slos, args.background)
    cls = FCFSScheduler if args.unshaped else ArcusScheduler
    sched = cls(engine, tenants, cost)
    submit_mix(sched, cfg.vocab, len(slos), args.duration, args.background)
    sched.run(args.duration, max_rounds=2000)
    return sched, tenants, cfg


def report(sched, tenants, cfg, args) -> str:
    mode = "FCFS (unshaped)" if args.unshaped else "Arcus"
    lines = [f"{mode} on {cfg.name} family, {args.chips} chips, "
             f"virtual time {sched.now_s:.2f}s"]
    for tid, st in sorted(sched.stats.items()):
        ttft = (f"{np.percentile(st.ttft, 99)*1e3:8.1f}ms p99"
                if st.ttft else "     n/a")
        lines.append(f"  tenant{tid} [{tenants[tid].policy:13s}] "
                     f"tokens={st.served_tokens:5d} "
                     f"finished={st.finished:3d} ttft={ttft}")
    return "\n".join(lines)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    sched, tenants, cfg = serve(args)
    print(report(sched, tenants, cfg, args))


if __name__ == "__main__":
    main()
