"""The serial dataplane tick of one or more checkouts, on the card, in turns.

    python3 src/repro_torch/launch/serial_tick.py CHECKOUT [CHECKOUT ...]

For each checkout given (a directory holding ``src/repro_torch``, e.g. this
repository and an unpacked ``git archive`` of an earlier commit), in the
order given and each in a fresh process that imports that checkout's
port: two windows of the quickstart's two admitted tenants (one
``ipsec32``, 1500 B at load 0.9, SLOs 10 / 20 Gbps) through ``simulate``
on the card, i.e. through the window's CUDA graph; then a window of
``PROFILED`` ticks under ``torch.profiler``.  Prints one JSON line a
checkout: wall µs a tick of each unprofiled window of ``TICKS`` ticks,
and device kernels, device µs and the token bucket's device µs a tick of
the profiled one, with the card's name and power limit.  Comparing two
commits needs both in one call, in turns (A, B, B, A): a card's power
limit and its host's load differ between calls.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

TICKS = 2_000
PROFILED = 100


def _measure(checkout: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(checkout), "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import token_bucket as tb
    from repro_torch.core.accelerator import CATALOG, AccelTable
    from repro_torch.core.flow import (SLO, FlowSet, FlowSpec, Path,
                                       TrafficPattern)
    from repro_torch.core.interconnect import LinkSpec
    from repro_torch.core.sim import SimConfig, gen_arrivals, simulate
    dev = torch.device("cuda", 0)
    flows = FlowSet.build([
        FlowSpec(i, vm_id=i, path=Path.FUNCTION_CALL, accel_id=0,
                 pattern=TrafficPattern(1500, load=0.9), slo=SLO.gbps(g))
        for i, g in enumerate((10.0, 20.0))])
    atab = AccelTable.build([CATALOG["ipsec32"]])
    tbs = tb.pack([tb.params_for_gbps(10.0), tb.params_for_gbps(20.0)])

    def window(n: int) -> None:
        cfg = SimConfig(n_ticks=n)
        arr = gen_arrivals(flows, cfg, load_ref_gbps={0: 32.0, 1: 32.0})
        simulate(flows, atab, LinkSpec(), cfg, tbs, *arr, device=dev)

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(TICKS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / TICKS * 1e6)
    window(PROFILED)                      # captures the profiled signature
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window(PROFILED)
        torch.cuda.synchronize()
    dev_us = kernels = tb_us = tb_n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()
            kernels += 1
            if "tb_grant_tick" in e.name:
                tb_us += e.time_range.elapsed_us()
                tb_n += 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return dict(checkout=checkout, card=smi, wall_us_per_tick=walls,
                device_kernels_per_tick=kernels / PROFILED,
                device_us_per_tick=dev_us / PROFILED,
                grant_tick_device_us_per_launch=tb_us / max(tb_n, 1),
                grant_tick_launches=tb_n)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(_measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for checkout in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", checkout]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
