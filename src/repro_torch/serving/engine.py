"""Batched serving engine: slot-managed KV cache + prefill/decode steps.

Port of ``src/repro/serving/engine.py``.  The engine is the "accelerator"
of the serving adaptation: tenants' request streams are the flows, and the
Arcus scheduler (``scheduler.py``) shapes what enters each engine step.
Continuous batching: prefill one request at a time into a free slot,
decode all slots together.  It serves every config the port's model runs:
decoder-only, cross-attention (``admit(req, frontend)`` with the request's
frontend embeddings, e.g. llama-3.2-vision-11b's image patches) and
encoder-decoder (seamless-m4t-medium's audio frames, encoded at admission).

It mirrors the reference step for step, so that its cache holds the same
values: ``admit`` zeroes the slot, the memory caches included, and
prefills B=1 straight into it (the reference prefills into a fresh zeroed
B=1 cache and copies the whole of it into the slot), and ``step`` decodes
all ``max_batch`` slots, inactive ones with token 0 and their stale length,
as the reference does.  The cache is updated in place.  The engine runs on
the card unless ``device="cpu"`` is passed; ``plain_kernels=True`` runs the
model kernels' plain versions (attention and the SSD scan) on the card
too, for parity checks only.

The reference jits the decode step; on the card the port captures it as a
CUDA graph once per engine (``_DecodeGraph``, over the engine's own cache,
the memory caches too: their addresses are the engine's, so one capture
holds for every request) and every ``step`` replays it.  The CPU runs the
eager body, ``_decode_eager``; prefill stays eager on both (``admit``
prefills into a per-slot view of the cache, whose addresses change with
the slot).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.cuda_graph import Captured
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
        self._prefill = lambda tok, cache, frontend=None: T.prefill(
            self.params, tok, cache, frontend, plain=plain)
        self._decode = _DecodeGraph(self) if self.device.type == "cuda" \
            else self._decode_eager

    def _decode_eager(self, tokens, lengths, cache):
        """The decode step's eager body: ``_decode`` on the CPU; on the card
        for the tests' and the smoke's comparisons only."""
        return T.decode_step(self.params, tokens, lengths, cache,
                             plain=self.plain_kernels)

    # ------------------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def admit(self, req: Request, frontend=None) -> int:
        """Prefill one request into a free slot. Returns the slot.
        ``frontend``: the request's frontend embeddings [1, F,
        frontend_dim] (an array or a tensor), which a config with a
        frontend needs."""
        slot = self.free_slots()[0]
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.device)
        if frontend is not None and not isinstance(frontend, torch.Tensor):
            frontend = torch.as_tensor(np.asarray(frontend, np.float32))
        if frontend is not None:
            frontend = frontend.to(self.device)
        one = [tuple(t[slot:slot + 1] for t in layer) for layer in self.cache]
        for layer in one:
            for t in layer:
                t.zero_()
        logits, _ = self._prefill(tokens, one, frontend)
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


class _DecodeGraph:
    """``T.decode_step`` over an engine's cache as a CUDA graph, captured
    when the engine is made: a call copies its tokens [B, 1] and lengths
    [B] into static buffers, replays the graph (which writes the cache in
    place) and returns a copy of the logits.  The warm-up before the
    capture runs one step on the engine's still empty cache and zeroes it
    again, so the first request meets the cache ``init_cache`` made."""

    def __init__(self, engine: ServingEngine):
        dev, B = engine.device, engine.max_batch
        self.cache = engine.cache
        self.tokens = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        params, plain, cache = engine.params, engine.plain_kernels, self.cache

        def body():
            return T.decode_step(params, self.tokens, self.lengths, cache,
                                 plain=plain)

        def warmup():
            body()
            for layer in cache:
                for t in layer:
                    t.zero_()
        self.graph = Captured(body, warmup)

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 cache) -> torch.Tensor:
        if cache is not self.cache:
            raise ValueError("the decode graph steps its engine's own cache")
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        self.graph.replay()
        return self.graph.out.clone()
