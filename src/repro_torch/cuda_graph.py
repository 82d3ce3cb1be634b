"""CUDA graphs of the port's compiled entries, with the kernels' launch
counters kept true.

The reference compiles its hot calls with ``jax.jit``: the dataplane's
window (``core/engine.py`` ``_run_core``) and the serving decode step
(``serving/engine.py``).  The port captures the same calls on the card as
CUDA graphs: ``Captured(body, warmup)`` runs ``warmup`` once on a side
stream (it must touch only throwaway state), records one call of ``body``
on the current CUDA device, and ``replay()`` runs the recording.  The
graph holds every kernel ``body`` launched, at the addresses it used, so
``body`` reads and writes fixed buffers and reads every per-call value
from the device.

A capture launches nothing on the card, so the counts that the kernel
wrappers raise while ``body`` is recorded and while ``warmup`` runs are
taken back out, and each replay adds the launches the graph holds: a
wrapper's ``LAUNCHES`` (and ``LAUNCHES_BY_PATH``) then counts the kernels
the card ran for the caller.  A capture or replay that fails raises;
nothing falls back to the eager body.
"""
from __future__ import annotations

import importlib

import torch

#: the kernel wrappers (``repro_torch.kernels.<name>.ops``) whose launch
#: counters a graph keeps
COUNTED = ("token_bucket", "decode_attention", "flash_prefill", "ssd_scan")


def _modules() -> list:
    return [importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in COUNTED]


def _counts(mods) -> list:
    return [(m.LAUNCHES, dict(getattr(m, "LAUNCHES_BY_PATH", {})))
            for m in mods]


def _set(mods, counts) -> None:
    for m, (n, paths) in zip(mods, counts):
        m.LAUNCHES = n
        getattr(m, "LAUNCHES_BY_PATH", {}).update(paths)


class Captured:
    """One call of ``body`` recorded as a CUDA graph; ``out`` is what that
    call returned (tensors in the graph's memory, rewritten by every
    replay)."""

    def __init__(self, body, warmup=None):
        mods = _modules()
        before = _counts(mods)
        if warmup is not None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warmup()
            torch.cuda.current_stream().wait_stream(side)
        start = _counts(mods)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = body()
        end = _counts(mods)
        self._mods = mods
        self.launches = [
            (n1 - n0, {p: v - p0[p] for p, v in p1.items()})
            for (n0, p0), (n1, p1) in zip(start, end)]
        _set(mods, before)

    def replay(self) -> None:
        self.graph.replay()
        for m, (n, paths) in zip(self._mods, self.launches):
            if n:
                m.LAUNCHES += n
                for p, v in paths.items():
                    m.LAUNCHES_BY_PATH[p] += v
