"""The knee sweep of a cell: the highest reserved request rate at which the
reserved queues do not grow, in the cell's own traffic (the background
tenant on).

    python3 bench/knee.py --workload <cell> --seed <n> --seconds <s> \\
        --rates 4,5,6 [--out <file>]

One process builds the model once; each rate gets a fresh engine and
scheduler, fills the background's share of the slots as a run's set-up
does, runs ``--seconds`` on the wall clock, and reports the reserved
backlog (requests due and not yet admitted) over the run's middle and
last thirds, the requests admitted against those due, the time to first
token, the slots in use and the tokens a second.  A rate is sustained
where the last third's mean backlog is at most the middle third's times
1.25 plus 2, and at least 95% of the requests due were admitted.  Run it
on the card; the cell's rate is then 4/5 of the highest sustained rate.
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


def sweep_rate(drv, rate: float, seconds: float) -> dict:
    import numpy as np
    from bench.stats import percentile
    drv.schedule(rate)
    drv.fill()
    t0 = time.perf_counter()
    samples, used = [], []
    while time.perf_counter() < t0 + seconds:
        drv.round(t0)
        samples.append((time.perf_counter() - t0, len(drv.waiting)))
        used.append(drv.engine.active_count)
    t = np.array([s for s, _ in samples])
    q = np.array([b for _, b in samples])
    mid = q[(t >= seconds / 3) & (t < 2 * seconds / 3)]
    last = q[t >= 2 * seconds / 3]
    recs = [r for r in drv.log.recs.values()
            if r.reserved and r.due <= t0 + seconds]
    tokens = sum(1 for r in drv.log.recs.values() for x in r.times
                 if t0 <= x <= t0 + seconds)
    admitted = sum(1 for r in recs if r.times)
    ttft = [(r.first - r.due) * 1e3 for r in recs if r.times]
    out = dict(rate=rate, due=len(recs), admitted=admitted,
               backlog_mid=float(mid.mean()) if mid.size else 0.0,
               backlog_last=float(last.mean()) if last.size else 0.0,
               backlog_end=int(q[-1]) if q.size else 0,
               ttft_p50_ms=percentile(ttft, 50),
               ttft_p95_ms=percentile(ttft, 95),
               slots_used_mean=float(np.mean(used)) if used else 0.0,
               tokens_per_s=tokens / seconds, rounds=len(samples))
    out["sustained"] = bool(out["backlog_last"]
                            <= 1.25 * out["backlog_mid"] + 2
                            and admitted >= 0.95 * len(recs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _paths()
    import torch
    from bench import serve, spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the knee sweep needs the card", file=sys.stderr)
        return 2
    drv = serve.Driver(cell, args.seed, "cuda:0")
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        rows.append(sweep_rate(drv, rate, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    knee = max((r["rate"] for r in rows if r["sustained"]), default=None)
    res = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
               device=torch.cuda.get_device_name(0), rows=rows, knee=knee,
               rate=None if knee is None else 0.8 * knee)
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
