"""Traffic: the requests of one run, drawn from a mix file and the seed.

A mix file (``bench/mixes/<name>.json``) gives the prompt and output
length distributions (lognormal by median and sigma, clipped), the reserved
tenants' shares of the reserved rate, the factor between a reserved
tenant's SLO and its mean offered prompt-token rate, and the background
tenant's backlog; the cell file gives the reserved rate.  The arrivals are
open-loop: each reserved tenant's requests are due on a Poisson schedule
whatever the system does.

Lengths and inter-arrival gaps come in blocks of ``block`` values taken at
the distribution's quantiles (i + 1/2) / block, each block permuted by the
mix's own ``trace_seed``: every run replays one arrival trace with the same
sizes, as a recorded trace would be replayed, so that a tail latency over a
window moves with the program and not with the queue's luck.  The prompts'
token ids (and so the served tokens, and a mixture of experts' routing)
come from the run's seed.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

#: numpy streams a run draws from, one a purpose
STREAMS = {"reserved": 1, "background": 2, "tokens": 3, "fill": 4,
           "sample": 5}


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, STREAMS[stream], index])


def length_block(dist: dict, block: int) -> np.ndarray:
    """``block`` lengths at the quantiles (i + 1/2) / block of the clipped
    lognormal ``dist`` ({median, sigma, min, max}), ascending."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / block)
                  for i in range(block)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def gap_block(block: int) -> np.ndarray:
    """``block`` unit-mean exponential gaps at the quantiles (i + 1/2) /
    block, scaled so that their mean is exactly 1."""
    g = -np.log1p(-(np.arange(block) + 0.5) / block)
    return g / g.mean()


@dataclasses.dataclass
class Draw:
    tenant: int
    due: float          # seconds after the window opens (reserved); 0 else
    prompt: list
    max_new: int


class Stream:
    """An endless stream of requests of one tenant: lengths from the mix's
    blocks, each block permuted by the seed; ``rate`` > 0 gives due times
    on the Poisson schedule of that many requests a second."""

    def __init__(self, mix: dict, vocab: int, seed: int, tenant: int,
                 kind: str, rate: float = 0.0):
        self.block = mix["block"]
        self.prompts = length_block(mix["prompt"], self.block)
        self.outputs = length_block(mix["output"], self.block)
        self.gaps = gap_block(self.block)
        self.vocab, self.seed, self.tenant = vocab, seed, tenant
        self.trace_seed = mix["trace_seed"]
        self.kind, self.rate = kind, rate
        self.k, self.t = 0, 0.0
        self._tok = rng(seed, "tokens", 2 * tenant + (kind == "background"))
        self._buf: list = []

    def _refill(self) -> None:
        r = rng(self.trace_seed, self.kind, 1000 * self.tenant + self.k)
        self.k += 1
        P = r.permutation(self.prompts)
        O = r.permutation(self.outputs)
        G = r.permutation(self.gaps)
        for p, o, g in zip(P, O, G):
            if self.rate > 0:
                self.t += g / self.rate
            prompt = self._tok.integers(0, self.vocab, int(p)).tolist()
            self._buf.append(Draw(self.tenant, self.t if self.rate else 0.0,
                                  prompt, int(o)))
        self._buf.reverse()

    def next(self) -> Draw:
        if not self._buf:
            self._refill()
        return self._buf.pop()


def mean_prompt(mix: dict) -> float:
    return float(length_block(mix["prompt"], mix["block"]).mean())


def reserved_rates(mix: dict, rate: float) -> list[float]:
    """Requests a second of each reserved tenant."""
    return [rate * s for s in mix["reserved_shares"]]


def slos(mix: dict, rate: float) -> list[float]:
    """Each reserved tenant's SLO in prompt tokens a second:
    ``slo_factor`` times its mean offered prompt-token rate."""
    m = mean_prompt(mix)
    return [mix["slo_factor"] * r * m for r in reserved_rates(mix, rate)]


def initial_fill(mix: dict, vocab: int, seed: int, tenant: int,
                 slots: int) -> list[Draw]:
    """The background requests that fill every slot before the window: a
    request met at a random moment in a busy slot has, on average, part of
    its output still to come, so each takes a stratified fraction (k +
    1/2) / slots of an output length, permuted by the seed; the window then
    opens with slots freeing at a steady rate.  Each asks for two tokens
    at least: the program gives a request that asks for one a second token
    (its prefill's token does not free the slot; the reference package's
    engine does the same), and the mixes ask for eight or more."""
    r = rng(mix["trace_seed"], "fill")
    outs = length_block(mix["output"], slots)
    prompts = length_block(mix["prompt"], slots)
    frac = r.permutation((np.arange(slots) + 0.5) / slots)
    P, O = r.permutation(prompts), r.permutation(outs)
    tok = rng(seed, "tokens", 999)
    return [Draw(tenant, 0.0, tok.integers(0, vocab, int(p)).tolist(),
                 max(2, int(math.ceil(f * o))))
            for p, o, f in zip(P, O, frac)]
