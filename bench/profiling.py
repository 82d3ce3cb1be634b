"""The traced stretch: ``torch.profiler`` over ``serve.TRACE_S`` seconds
of a ``--trace 1`` run's serving after its window and drain, reduced to
the device's busy time, each kernel's device time and count, and the
device's idle gaps by what the host was doing (the harness's spans
``sched.round``, ``engine.prefill`` and ``engine.decode``, recorded with
``record_function``)."""
from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

#: the harness's host spans, innermost first
SPANS = ("engine.prefill", "engine.decode", "sched.round")


@dataclasses.dataclass
class Reading:
    window_s: float
    busy_s: float
    kernels: dict          # name -> [launches, device seconds]
    idle_by_host: dict     # host span (or "between rounds") -> idle seconds

    def kernel(self, part: str) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds
        ``part``."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if part in name:
                n, s = n + k, s + sec
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v[1]] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps]}


def reduce(device: list, host: list) -> Reading:
    """``device``: (name, start_ns, end_ns) of every device operation;
    ``host``: (span name, start_ns, end_ns) of the harness's spans.  The
    stretch runs from the first ``sched.round`` span's start to the last
    one's end."""
    rounds = [(s, e) for n, s, e in host if n == "sched.round"]
    if not rounds:
        raise RuntimeError("the traced stretch holds no scheduler round")
    w0, w1 = min(s for s, _ in rounds), max(e for _, e in rounds)
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for name, s, e in device:
        # every operation the profiler saw belongs to the traced rounds (it
        # starts between two rounds, and each round ends in a host read);
        # only the busy time is cut to the rounds' span, whose host clock
        # may sit a few microseconds off the device's
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-9
        s, e = max(s, w0), min(e, w1)
        if e > s:
            spans.append((s, e))
    if not spans:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the traced stretch")
    spans.sort()
    busy, gaps = 0, []
    cur_s, cur_e = spans[0]
    if cur_s > w0:
        gaps.append((w0, cur_s))
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    idle: dict = collections.defaultdict(float)
    # spans of one name follow one another: the last to start at or before
    # a gap's midpoint is the only one that can hold it
    by_name = {n: sorted((s, e) for m, s, e in host if m == n) for n in SPANS}
    starts = {n: [s for s, _ in v] for n, v in by_name.items()}

    def holds(n, t):
        i = bisect.bisect_right(starts[n], t) - 1
        return i >= 0 and t < by_name[n][i][1]

    for s, e in gaps:
        mid = (s + e) // 2
        label = next((n for n in SPANS if holds(n, mid)), "between rounds")
        idle[label] += (e - s) * 1e-9
    return Reading(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   kernels=dict(kernels), idle_by_host=dict(idle))


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self, fn) -> None:
        """One profiled call of ``fn`` in set-up, so that the profiler's
        one-time start-up is paid there."""
        p = self._profile()
        p.start()
        fn()
        p.stop()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    def stop(self) -> Reading:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.stop()
        dev_type = torch.autograd.DeviceType.CUDA if \
            self.device.type == "cuda" else torch.autograd.DeviceType.CPU
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns()
            end = s + e.duration_ns()
            if name in SPANS:
                if e.device_type() == torch.autograd.DeviceType.CPU:
                    host.append((name, s, end))
            elif e.device_type() == dev_type and \
                    (dev_type == torch.autograd.DeviceType.CUDA
                     or name.startswith("aten::")):
                device.append((name, s, end))
        self.prof = None
        return reduce(device, host)
