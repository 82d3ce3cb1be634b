"""Decoder-only transformer of the port: init, serving cache, prefill and
decode.

Port of ``src/repro/models/transformer.py`` for the dense attention
kinds, the recurrent ``rglru`` and ``ssd`` kinds and MoE feed-forwards
(``cfg.is_moe_layer``).  The reference stacks each period position's
parameters across repetitions and scans over them; here every layer is its
own ``Block`` module, layer ``li = rep * period + j`` of kind
``cfg.layer_kinds()[li]``, and the model loops over them in Python.  The
cache is a list with one pair of tensors per layer, updated in place (the
reference returns new arrays with the same values): (k, v) of
[B, W, KvH, Dh] for an attention layer, (conv [B, 3, W], h [B, W] float32)
for an ``rglru`` layer, (conv [B, K-1, Din + 2 G N], state [B, H, P, N]
float32) for an ``ssd`` layer.

Decode attention goes through the decode-attention kernel on CUDA
(``repro_torch.kernels.decode_attention``), where the reference calls the
kernel's oracle ``da_ref.decode_attention`` inline
(``_decode_self_attention``); prefill attention goes through the
flash-prefill kernel (``layers.Attention.block``) and the Mamba2 prefill
through the SSD-scan kernel (``layers.Mamba2.prefill``).  ``plain=True``
runs the plain versions on a CUDA tensor too, for parity checks only.  A
MoE layer dispatches a prefill's tokens grouped by expert
(``layers.MoE.grouped``, one host read) and a decode step's through every
expert at fixed shapes (``layers.MoE.all_experts``, capturable).

Out of this slice, and refused with ``NotImplementedError``: the ``cross``
layer kind, encoder layers, frontends, and the full-sequence ``forward``
(training and scoring, with the MoE auxiliary loss).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

ATTN_KINDS = ("global", "local", "chunk")
RECURRENT_KINDS = ("rglru", "ssd")
KINDS = ATTN_KINDS + RECURRENT_KINDS

Cache = list   # one (k, v), (conv, h) or (conv, state) pair per layer


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    cfg.validate()
    other = sorted(set(cfg.layer_pattern) - set(KINDS))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {other} are not ported (the port runs "
            f"{list(KINDS)} only)")
    if cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: encoder layers are not "
                                  "ported")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  "is not ported")


MIXERS = {"rglru": L.RGLRU, "ssd": L.Mamba2}


class Block(nn.Module):
    """One pre-norm layer: attention of ``kind``, the RG-LRU block
    (``rglru``) or the Mamba2 mixer (``ssd``), then, where
    ``cfg.d_ff > 0``, the MLP or (``moe``) the MoE feed-forward."""

    def __init__(self, cfg: ArchConfig, kind: str, mk: L.Maker, *,
                 moe: bool = False):
        super().__init__()
        self.kind = kind
        self.ln1 = L.Norm(cfg, mk)
        self.mixer = MIXERS.get(kind, L.Attention)(cfg, mk)
        self.has_ffn = cfg.d_ff > 0
        self.moe = moe and self.has_ffn
        if self.has_ffn:
            self.ln2 = L.Norm(cfg, mk)
            self.ffn = L.MoE(cfg, mk) if self.moe else L.MLP(cfg, mk)

    def _ffn(self, x: torch.Tensor, decode: bool) -> torch.Tensor:
        if not self.has_ffn:
            return x
        h = self.ln2(x)
        if not self.moe:
            return x + self.ffn(h)
        return x + (self.ffn.all_experts(h) if decode
                    else self.ffn.grouped(h))

    def prefill(self, x, tables, cache_kv, *, plain: bool = False):
        """Full sequence at positions 0..S-1; writes the (rolling) cache,
        or a recurrent layer's (conv, state)."""
        if self.kind in RECURRENT_KINDS:
            return self._ffn(x + self.mixer.prefill(self.ln1(x), cache_kv,
                                                    plain=plain), False)
        y, k, v = self.mixer.block(self.ln1(x), self.kind, tables,
                                   plain=plain)
        _build_attn_cache(self.kind, k, v, cache_kv)
        return self._ffn(x + y, False)

    def decode(self, x, tables, cache_kv, slot, valid, *,
               plain: bool = False):
        """One token per sequence: writes its K/V at ``slot`` [B] (int64)
        and attends the first ``valid`` [B] (int32) cache rows; a recurrent
        layer steps its (conv, state) instead."""
        if self.kind in RECURRENT_KINDS:
            return self._ffn(x + self.mixer.decode(self.ln1(x), cache_kv),
                             True)
        q, k, v = self.mixer.qkv(self.ln1(x))
        q = L.apply_rope(q, tables)
        k = L.apply_rope(k, tables)
        ck, cv = cache_kv
        B, W, KvH, Dh = ck.shape
        idx = slot.view(B, 1, 1).expand(B, 1, KvH * Dh)
        ck.view(B, W, KvH * Dh).scatter_(
            1, idx, k.reshape(B, 1, KvH * Dh).to(ck.dtype))
        cv.view(B, W, KvH * Dh).scatter_(
            1, idx, v.reshape(B, 1, KvH * Dh).to(cv.dtype))
        attn = da_ops.decode_attention_plain if plain \
            else da_ops.decode_attention
        o = attn(q[:, 0], ck, cv, valid, window=0)
        return self._ffn(x + self.mixer.out(o[:, None]), True)


def _build_attn_cache(kind: str, k, v, cache_kv) -> None:
    """Write prefilled K/V [B, S, KvH, Dh] into the (possibly rolling)
    cache: position p goes to slot p % W, and a local or chunk layer keeps
    only the last W positions of a longer prompt."""
    ck, cv = cache_kv
    S, W = k.shape[1], ck.shape[1]
    if S > W:
        if kind == "global":
            raise ValueError(f"prompt of {S} tokens exceeds the cache's "
                             f"{W} positions")
        k, v = k[:, -W:], v[:, -W:]
        pos = torch.arange(S - W, S, device=k.device)
    else:
        pos = torch.arange(S, device=k.device)
    slots = pos % W
    ck.index_copy_(1, slots, k.to(ck.dtype))
    cv.index_copy_(1, slots, v.to(cv.dtype))


def cache_window(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind in ("local", "chunk"):
        return min(cfg.window, max_len)
    return max_len


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks, final norm and (un)tied head.

    ``gen=None`` leaves the weights uninitialised, to be loaded (see
    ``repro_torch.models.convert``); then call ``tie()``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        mk = L.Maker(gen, dev)
        self.embed = mk.embed(cfg.vocab, cfg.d_model)
        kinds = cfg.layer_kinds()
        period, reps = cfg.period, cfg.n_layers // cfg.period
        blocks: dict[int, Block] = {}
        # the reference's draw order: period position-major, then the tail
        for j in range(period):
            for r in range(reps):
                li = r * period + j
                blocks[li] = Block(cfg, kinds[li], mk,
                                   moe=cfg.is_moe_layer(li))
        for li in range(reps * period, cfg.n_layers):
            blocks[li] = Block(cfg, kinds[li], mk, moe=cfg.is_moe_layer(li))
        self.blocks = nn.ModuleList(blocks[li] for li in range(cfg.n_layers))
        self.final_norm = L.Norm(cfg, mk)
        if not cfg.tie_embeddings:
            self.lm_head = mk.dense(cfg.d_model, cfg.vocab,
                                    dtype=L.torch_dtype(cfg.dtype))
        self.tie()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def first_layers(self, n: int) -> "Transformer":
        """The model cut to its first ``n`` layers, sharing every weight
        (a run at full width and reduced depth)."""
        cut = copy.copy(self)
        cut._modules = dict(self._modules)
        cut.blocks = nn.ModuleList(list(self.blocks)[:n])
        cut.cfg = dataclasses.replace(self.cfg, n_layers=n)
        return cut

    def tie(self) -> None:
        """The tied head's weight as the reference computes with it:
        ``embed`` cast to ``cfg.dtype`` (kept once, not cast every step)."""
        if self.cfg.tie_embeddings:
            dt = L.torch_dtype(self.cfg.dtype)
            self.unembed_w = self.embed.detach() if dt == torch.float32 \
                else self.embed.detach().to(dt)

    # ------------------------------------------------------------------
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.embed_scale:
            x = x * torch.full((), self.cfg.d_model ** 0.5, dtype=x.dtype,
                               device=x.device)
        return x.to(L.torch_dtype(self.cfg.dtype))

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.cfg.tie_embeddings:
            # T5-style 1/sqrt(d) scaling of the tied logits, as the reference
            return (x @ self.unembed_w.t()) * (self.cfg.d_model ** -0.5)
        return x @ self.lm_head

    def _tables(self, positions: torch.Tensor):
        """RoPE tables for the attention layers; None without any."""
        if not any(b.kind in ATTN_KINDS for b in self.blocks):
            return None
        return L.rope_tables(positions, self.cfg.head_dim_,
                             theta=self.cfg.rope_theta,
                             fraction=self.cfg.rope_fraction)


def init_model(seed: int, cfg: ArchConfig, *, device=None) -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the reference's distributions and scales (not its bits)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, gen=gen)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Cache:
    """Zeroed per-layer (k, v) [batch, W, KvH, Dh] in ``dtype``, W being
    ``max_len`` for a global layer and ``min(window, max_len)`` for a local
    or chunk one; for an ``rglru`` layer (conv [batch, 3, W] in ``dtype``,
    h [batch, W] float32, W = ``lru_width or d_model``); for an ``ssd`` layer
    (conv [batch, K-1, Din + 2 G N] in ``dtype``, state [batch, H, P, N]
    float32), as the reference."""
    check_supported(cfg)
    dev = resolve_device(device)
    KvH, Dh = cfg.n_kv_heads, cfg.head_dim_
    cache = []
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            W = cfg.lru_width or cfg.d_model
            cache.append((
                torch.zeros((batch, L.RGLRU.CONV - 1, W), dtype=dtype,
                            device=dev),
                torch.zeros((batch, W), dtype=torch.float32, device=dev)))
            continue
        if kind == "ssd":
            Din, H, G, N = L.mamba2_split(cfg)
            cache.append((
                torch.zeros((batch, cfg.conv_kernel - 1, Din + 2 * G * N),
                            dtype=dtype, device=dev),
                torch.zeros((batch, H, cfg.ssm_head_dim, N),
                            dtype=torch.float32, device=dev)))
            continue
        W = cache_window(cfg, kind, max_len)
        cache.append(tuple(torch.zeros((batch, W, KvH, Dh), dtype=dtype,
                                       device=dev) for _ in range(2)))
    return cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: Cache, *,
            plain: bool = False):
    """Equal-length batched prefill of tokens [B, S]: runs the full
    sequence and fills ``cache`` in place.  Returns (last-token logits
    [B, V], lengths [B] int32)."""
    B, S = tokens.shape
    x = model.embed_tokens(tokens)
    tables = model._tables(torch.arange(S, device=tokens.device)[None, :])
    for blk, kv in zip(model.blocks, cache):
        x = blk.prefill(x, tables, kv, plain=plain)
    logits = model.unembed(x[:, -1:])[:, 0]
    return logits, torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                lengths: torch.Tensor, cache: Cache, *,
                plain: bool = False) -> torch.Tensor:
    """One decode step: tokens [B, 1]; lengths [B] int32 = current cache
    length.  Writes each layer's new K/V into ``cache`` in place and returns
    logits [B, V].  The valid rows a layer attends are ``lengths + 1``
    (global), ``min(lengths + 1, W)`` (local, rolling) or
    ``lengths % window + 1`` (chunk), always with window 0, as the
    reference's ``_decode_self_attention``.  A recurrent layer steps its
    recurrence (``layers.RGLRU.decode``, ``layers.Mamba2.decode``)."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    tables = model._tables(lengths[:, None])
    ln = lengths.to(torch.int64)
    where: dict = {}     # (kind, W) -> (slot, valid) of an attention layer
    for blk, kv in zip(model.blocks, cache):
        key = (blk.kind, kv[0].shape[1])
        if blk.kind in ATTN_KINDS and key not in where:
            W = key[1]
            if blk.kind == "chunk":
                n = ln % cfg.window + 1
            elif blk.kind == "local":
                n = torch.clamp(ln + 1, max=W)
            else:
                n = ln + 1
            where[key] = (ln % W, n.to(torch.int32))
        slot, valid = where.get(key, (None, None))
        x = blk.decode(x, tables, kv, slot, valid, plain=plain)
    return model.unembed(x)[:, 0]
