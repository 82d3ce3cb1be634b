"""Readings for the limits of ``correct``: the program's ``gap_share`` and
``gap_max`` on many seeds and the float8 control's on some of them, at the
cell's own size and load.

    python3 bench/control.py --workload <cell> --seeds 2001-2012 \\
        --control 3 --seconds <s> [--out <dir>]

Each seed is one whole run (``run.measure``: set-up, a window of
``--seconds``, the sample, the reference) in this process; the first
``--control`` seeds also run the reference in float8 e4m3 over the same
sample and read the gap of the tokens it puts first (``control_max``,
``control_share``), and hold those to the cell's limits in the program's
place (``check.control_checks``: ``control_correct`` has to read false).
Each seed prints a line: the checks, both readings of the program and of
the control, the spread of the per-position gaps (99th percentile, the
share over 0.1 and 0.5 of the logits' spread), and for a mixture of
experts the reference's routing margin at the positions where the
program's gap is widest.  ``--out`` keeps the
per-position arrays (``.npz``).  Run it on the card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

if not __package__:
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
from bench.run import _paths  # noqa: E402


def summary(a) -> dict:
    import numpy as np
    if a is None or not len(a):
        return {}
    return {"p99": float(np.percentile(a, 99)),
            "share_0.1": float((a > 0.1).mean()),
            "share_0.5": float((a > 0.5).mean())}


def seeds(spec_: str) -> list[int]:
    out = []
    for part in spec_.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _paths()
    import numpy as np
    import torch
    from bench import check, serve, spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs need the card", file=sys.stderr)
        return 2
    out = pathlib.Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    for k, seed in enumerate(seeds(args.seeds)):
        t = time.perf_counter()
        r, drv = serve.run(cell, seed, args.seconds, trace=False,
                           device="cuda:0", t_start=t)
        sample = check.sample(r)
        drv.free()
        g = check.logit_gaps(r, sample, drv.device,
                             control=k < args.control, detail=True)
        d = g.pop("detail")
        line = dict(workload=args.workload, seed=seed,
                    checks=check.checks(r, g), requests=len(sample),
                    readings=g, gap=summary(d["gap"]),
                    control=summary(d.get("control")),
                    seconds=time.perf_counter() - t)
        if k < args.control:
            line["control_checks"] = check.control_checks(r, g)
            line["control_correct"] = check.passed(line["control_checks"])
        line["cache"] = r.cache_use()
        if "margin" in d:
            top = np.argsort(-d["gap"])[:5]
            line["widest_gaps"] = [[float(d["gap"][i]), float(d["margin"][i])]
                                   for i in top]
            line["margin_p1"] = float(np.percentile(d["margin"], 1))
        print(json.dumps(line), flush=True)
        if out:
            np.savez(out / f"{args.workload}.{seed}.npz", **d)
        del r, drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
