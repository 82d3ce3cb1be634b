"""Pinned MoE routing for parity checks of the port's kernels.

The attention kernels and their plain versions round differently.  Where a
token's router has its k-th and (k+1)-th experts within that rounding of a
tie, the two runs can pick different experts, and that token's output then
differs by far more than one ulp: a fact about the router's margin, not
about the kernels.  ``RoutingTape`` lets a check hold a call through the
kernels against the plain versions on the same routing: ``record`` keeps
the expert indices each MoE layer chose in the kernels' call, ``replay``
hands them, layer by layer, to the plain call (``MoE.route(xt, idx)``; the
gates stay the plain call's own), and counts the routing decisions where
the plain call's own top k differs, with the largest gap between its k-th
and (k+1)-th probabilities at such a decision.  Nothing in the serving
path uses it.
"""
from __future__ import annotations

import torch


class RoutingTape:
    """Installed on every MoE layer of ``model`` (an instance ``route``
    over ``MoE.route``) until ``remove``."""

    def __init__(self, model):
        self.moes = [b.ffn for b in model.blocks if b.moe]
        self.mode, self.tape, self.pos = None, [], 0
        self.decisions = self.flips = 0
        self.max_flip_gap = 0.0
        for moe in self.moes:
            moe.route = self._wrap(moe)

    def _wrap(self, moe):
        route = type(moe).route

        def wrapped(xt, idx=None):
            if self.mode == "replay":
                idx = self.tape[self.pos]
                self.pos += 1
                self._count(moe, xt, idx)
            out = route(moe, xt, idx)
            if self.mode == "record":
                self.tape.append(out[1])
            return out
        return wrapped

    def _count(self, moe, xt, pinned) -> None:
        """Decisions, and those where this call's own top k differs."""
        probs = torch.softmax(xt.float() @ moe.router, -1)
        top = torch.sort(probs, stable=True, dim=-1, descending=True)
        K = pinned.shape[-1]
        moved = (top.indices[:, :K].sort(-1).values
                 != pinned.sort(-1).values).any(-1)
        self.decisions += int(moved.numel())
        n = int(moved.sum())
        self.flips += n
        if n and K < probs.shape[-1]:
            gap = top.values[:, K - 1] - top.values[:, K]
            self.max_flip_gap = max(self.max_flip_gap,
                                    float(gap[moved].max()))

    def record(self) -> None:
        """The next call's routing is kept."""
        self.mode, self.tape, self.pos = "record", [], 0

    def replay(self) -> None:
        """The next call takes the kept routing."""
        self.mode, self.pos = "replay", 0

    def stop(self) -> None:
        if self.pos != len(self.tape):
            raise AssertionError(f"routing tape: {len(self.tape)} layer "
                                 f"calls recorded, {self.pos} replayed")
        self.mode = None

    def remove(self) -> None:
        for moe in self.moes:
            del moe.route

    def report(self) -> dict:
        return dict(decisions=self.decisions, flips=self.flips,
                    max_flip_gap=self.max_flip_gap)
