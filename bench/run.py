"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``).  With ``--trace 0`` the last line of standard output
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, the traced stretch's device busy and window seconds and its
breakdown.  Every run checks its outputs (``bench/check.py``) and prints
each number compared beside its limit as the last lines of standard error
and under ``checks``, the line's last key.  The program's kernel libraries
are built into ``build/`` inside the checkout on its first run.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    # run as a script, bench/ itself leads sys.path: its modules are
    # imported as bench.*, never by their bare names
    if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "bench":
        sys.path.pop(0)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every compile cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def measure(cell, seed: int, seconds: float, trace: bool, device, *,
            t_start: float, patch=None, control: bool = False,
            **serve_kw) -> dict:
    """One run: the window, then the checks.  Returns the result line (a
    dict) with ``metrics`` for ``trace``, ``checks`` last; with
    ``control`` the float8 control's gaps on the same sample besides, and
    the checks with the control's in the place of the program's
    (``control_checks``)."""
    import torch

    from bench import check, serve, spec
    bench = spec.benchmark()
    run, drv = serve.run(cell, seed, seconds, trace=trace, device=device,
                         t_start=t_start, patch=patch, **serve_kw)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(cell.name, kind, bench):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    due = run.reserved_due()
    sample = check.sample(run)
    drv.free()
    gaps = check.logit_gaps(run, sample, drv.device, control=control)
    cks = check.checks(run, gaps)
    dev = torch.device(device)
    out = {
        "correct": check.passed(cks),
        "attempted": len(due),
        "failed": sum(1 for r in due if not r.times),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["sample"] = {"requests": len(sample), **gaps,
                     "drained_s": run.drained_s}
    out["cache"] = run.cache_use()
    if control:
        out["control_checks"] = check.control_checks(run, gaps)
    out["checks"] = cks
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    _paths()
    import torch

    from bench import spec
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace),
                  "cuda:0", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: the process loaded {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
