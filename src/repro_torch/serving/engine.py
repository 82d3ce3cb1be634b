"""Batched serving engine: slot-managed KV cache + prefill/decode steps.

Port of ``src/repro/serving/engine.py``.  The engine is the "accelerator"
of the serving adaptation: tenants' request streams are the flows, and the
Arcus scheduler (``scheduler.py``) shapes what enters each engine step.
Continuous batching: prefill one request at a time into a free slot,
decode all slots together.

It mirrors the reference step for step, so that its cache holds the same
values: ``admit`` zeroes the slot and prefills B=1 straight into it (the
reference prefills into a fresh zeroed B=1 cache and copies the whole of it
into the slot), and ``step`` decodes all ``max_batch`` slots, inactive ones
with token 0 and their stale length, as the reference does.  The cache is
updated in place.  The engine runs on the card unless ``device="cpu"`` is
passed; ``plain_kernels=True`` runs the model kernels' plain versions
(attention and the SSD scan) on the card too, for parity checks only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serving.request import Request


@dataclasses.dataclass
class ServingEngine:
    cfg: ArchConfig
    params: T.Transformer
    max_batch: int
    max_len: int
    cache_dtype: Any = torch.float32
    device: Any = None
    greedy: bool = True
    plain_kernels: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.params.device != self.device:
            raise ValueError(f"model on {self.params.device}, engine on "
                             f"{self.device}")
        self.cache = T.init_cache(self.cfg, self.max_batch, self.max_len,
                                  self.cache_dtype, device=self.device)
        self.lengths = np.zeros(self.max_batch, np.int32)
        self.active = np.zeros(self.max_batch, bool)
        self.requests: dict[int, Request] = {}
        plain = self.plain_kernels
        self._decode = lambda tok, ln, cache: T.decode_step(
            self.params, tok, ln, cache, plain=plain)
        self._prefill = lambda tok, cache: T.prefill(
            self.params, tok, cache, plain=plain)

    # ------------------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def admit(self, req: Request) -> int:
        """Prefill one request into a free slot. Returns the slot."""
        slot = self.free_slots()[0]
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.device)
        one = [tuple(t[slot:slot + 1] for t in layer) for layer in self.cache]
        for layer in one:
            for t in layer:
                t.zero_()
        logits, _ = self._prefill(tokens, one)
        tok = int(torch.argmax(logits[0]))
        self.lengths[slot] = len(req.prompt)
        self.active[slot] = True
        req.slot = slot
        req.generated.append(tok)
        self.requests[req.req_id] = req
        # account the first generated token's cache entry on next decode
        return slot

    def step(self) -> dict[int, int]:
        """One decode step over all slots (inactive ones too, as the
        reference).  Returns {req_id: new_token}."""
        if not self.active.any():
            return {}
        last = np.zeros((self.max_batch, 1), np.int64)
        for r in self.requests.values():
            if r.slot >= 0 and r.generated:
                last[r.slot, 0] = r.generated[-1]
        logits = self._decode(torch.as_tensor(last, device=self.device),
                              torch.as_tensor(self.lengths,
                                              device=self.device),
                              self.cache)
        toks = torch.argmax(logits, -1).cpu().numpy()
        out = {}
        for rid, r in list(self.requests.items()):
            if r.slot < 0:
                continue
            self.lengths[r.slot] += 1
            tok = int(toks[r.slot])
            r.generated.append(tok)
            out[rid] = tok
            if r.done:
                self.active[r.slot] = False
                r.slot = -1
                del self.requests[rid]
        return out

    @property
    def active_count(self) -> int:
        return int(self.active.sum())
