"""The port's transformer: init, the full-sequence forward (training and
scoring), serving cache, prefill and decode, for decoder-only,
cross-attention (VLM) and encoder-decoder models.

Port of ``src/repro/models/transformer.py`` for every layer kind (the
self-attention kinds ``global``, ``local``, ``chunk``; ``cross``; the
recurrent ``rglru`` and ``ssd``), MoE feed-forwards
(``cfg.is_moe_layer``), the bidirectional encoder (``cfg.encoder_layers``)
and the frontend projection (``cfg.frontend``).  The reference stacks each
period position's parameters across repetitions and scans over them; here
every layer is its own ``Block`` module, layer ``li = rep * period + j`` of
kind ``cfg.layer_kinds()[li]``, every encoder layer its own
``EncoderBlock``, and the model loops over them in Python.

The cache is a list with one tuple of tensors per decoder layer, updated in
place (the reference returns new arrays with the same values):

* a self-attention layer: (k, v) of [B, W, KvH, Dh];
* a ``cross`` layer: (k, v) of [B, F, KvH, Dh], the memory's K/V, F being
  ``cfg.frontend_len``;
* with encoder layers, an attention or ``cross`` layer appends the
  encoder-decoder cross-attention's memory K/V: (k, v, xk, xv), xk and xv
  [B, F, KvH, Dh];
* an ``rglru`` layer: (conv [B, 3, W], h [B, W] float32);
* an ``ssd`` layer: (conv [B, K-1, Din + 2 G N], state [B, H, P, N]
  float32).

Prefill projects the frontend embeddings (``frontend_kv``, a float32
product cast to ``cfg.dtype``), runs the encoder over them where the config
has one (``encode``), and writes each layer's memory K/V once; decode
attends those rows and never writes them.

Decode attention goes through the decode-attention kernel on CUDA
(``repro_torch.kernels.decode_attention``), where the reference calls the
kernel's oracle ``da_ref.decode_attention`` inline: against the
self-attention cache (``_decode_self_attention``) and against the memory
with every one of its F rows valid (``_apply_block``'s ``cross`` and
``xattn`` branches).  Prefill attention goes through the flash-prefill
kernel (``layers.Attention.block``): causal for the decoder's
self-attention, non-causal for the encoder and for cross-attention (Sq the
prompt, Sk = F).  The Mamba2 prefill goes through the SSD-scan kernel
(``layers.Mamba2.prefill``).  ``plain=True`` runs the plain versions on a
CUDA tensor too, for parity checks only.  A MoE layer dispatches a
prefill's tokens grouped by expert (``layers.MoE.grouped``, one host read)
and a decode step's through every expert at fixed shapes
(``layers.MoE.all_experts``, capturable).

``forward`` is the reference's full-sequence pass with no cache (training
and scoring): every layer kind from a zero state, MoE layers in their
training form (``layers.MoE.capacity``, the auxiliary loss summed over
them), attention through ``flash_attention`` when grad is enabled (the
flash-prefill kernel and its backward kernel).  Training needs the
training storage (``init_model(..., train=True)``: float32 parameters that
require grad, cast at each use, the tied head too).

A model laid out on a mesh (``distributed.sharding.shard_model``: its
parameters ``DTensor`` blocks, ``model.mesh`` set) runs ``forward`` on
gathered weights (``distributed.fsdp``): the embedding, frontend
projection, norms and head once for the pass, each decoder and encoder
block's own inside its call, so that under ``remat`` a block's gathered
weights are freed after it and gathered again in the recompute.  ``split``
names the mesh axes the batch's rows are split over: the gradients are
summed over those axes alone, and a MoE layer dispatches the global batch
(``layers.MoE.capacity``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

ATTN_KINDS = ("global", "local", "chunk")      # decoder self-attention
RECURRENT_KINDS = ("rglru", "ssd")

Cache = list   # one tuple of tensors per decoder layer (module docstring)


def has_xattn(cfg: ArchConfig, kind: str) -> bool:
    """Whether a decoder layer of ``kind`` carries the encoder-decoder
    cross-attention (``xattn``, ``lnx``), as the reference's
    ``_init_block``."""
    return bool(cfg.encoder_layers) and kind in ATTN_KINDS + ("cross",)


MIXERS = {"rglru": L.RGLRU, "ssd": L.Mamba2}


class Block(nn.Module):
    """One pre-norm decoder layer: attention of ``kind`` (a gated
    cross-attention to the memory for ``cross``), the RG-LRU block
    (``rglru``) or the Mamba2 mixer (``ssd``); then, with encoder layers,
    the cross-attention to the encoder's output (``lnx``, ``xattn``); then,
    where ``cfg.d_ff > 0``, the MLP or (``moe``) the MoE feed-forward."""

    def __init__(self, cfg: ArchConfig, kind: str, mk: L.Maker, *,
                 moe: bool = False):
        super().__init__()
        self.kind = kind
        self.ln1 = L.Norm(cfg, mk)
        self.mixer = MIXERS.get(kind, L.Attention)(cfg, mk)
        if kind == "cross":
            # float32 scalar, zero at init: the layer starts silent
            self.xgate = mk.zeros((), ())
        self.has_xattn = has_xattn(cfg, kind)
        if self.has_xattn:
            self.xattn = L.Attention(cfg, mk)
            self.lnx = L.Norm(cfg, mk)
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

    def _gate(self, y: torch.Tensor) -> torch.Tensor:
        """A ``cross`` layer's output scaled by tanh(xgate), cast to y's
        dtype first, as the reference."""
        return torch.tanh(self.xgate).to(y.dtype) * y

    def _mixers(self, x, tables, cache_kv, memory, plain: bool):
        """The full-sequence mixers (and ``xattn``) at positions 0..S-1,
        before the feed-forward; writes ``cache_kv`` where given (a
        prefill), nothing where it is None (``forward``)."""
        if self.kind in RECURRENT_KINDS:
            h = self.ln1(x)
            y = self.mixer(h, plain=plain) if cache_kv is None \
                else self.mixer.prefill(h, cache_kv, plain=plain)
            x = x + y
        elif self.kind == "cross":
            y, k, v = self.mixer.block(self.ln1(x), "cross", None,
                                       memory=memory, plain=plain)
            if cache_kv is not None:
                _write_memory(k, v, cache_kv[:2])
            x = x + self._gate(y)
        else:
            y, k, v = self.mixer.block(self.ln1(x), self.kind, tables,
                                       plain=plain)
            if cache_kv is not None:
                _build_attn_cache(self.kind, k, v, cache_kv[:2])
            x = x + y
        if self.has_xattn:
            y, k, v = self.xattn.block(self.lnx(x), "cross", None,
                                       memory=memory, plain=plain)
            if cache_kv is not None:
                _write_memory(k, v, cache_kv[2:])
            x = x + y
        return x

    def prefill(self, x, tables, cache_kv, *, memory=None,
                plain: bool = False):
        """Full sequence at positions 0..S-1; writes the (rolling) cache,
        a recurrent layer's (conv, state), or the memory's K/V (``memory``
        [B, F, E]: the projected frontend, or the encoder's output)."""
        return self._ffn(self._mixers(x, tables, cache_kv, memory, plain),
                         False)

    def forward(self, x, tables, *, memory=None, plain: bool = False,
                split: fsdp.Split | None = None):
        """Full sequence at positions 0..S-1 with no cache (training): (x,
        aux), aux the MoE load-balance loss of a MoE layer (its training
        dispatch, ``layers.MoE.capacity``, over the global batch of
        ``split``'s rows) and None otherwise."""
        x = self._mixers(x, tables, None, memory, plain)
        if not self.moe:
            return self._ffn(x, False), None
        y, probs = self.ffn.capacity(self.ln2(x), split)
        return x + y, L.moe_aux_loss(probs)

    def decode(self, x, tables, cache_kv, slot, valid, mem_valid, *,
               plain: bool = False, decode_attn_fn=None,
               decode_update_fn=None):
        """One token per sequence: writes its K/V at ``slot`` [B] (int64)
        and attends the first ``valid`` [B] (int32) cache rows; a recurrent
        layer steps its (conv, state) instead; a ``cross`` layer and an
        ``xattn`` attend the memory's first ``mem_valid`` [B] rows (all F)
        with an unrotated q and write nothing.  ``decode_update_fn(ck, cv,
        k, v, slot)`` and ``decode_attn_fn(q, ck, cv, valid, window=0)``
        replace the self-attention's write and attention (``decode_step``)."""
        if self.kind in RECURRENT_KINDS:
            x = x + self.mixer.decode(self.ln1(x), cache_kv)
        elif self.kind == "cross":
            x = x + self._gate(_attend_memory(
                self.mixer, self.ln1(x), cache_kv[:2], mem_valid, plain))
        else:
            q, k, v = self.mixer.qkv(self.ln1(x))
            q = L.apply_rope(q, tables)
            k = L.apply_rope(k, tables)
            ck, cv = cache_kv[:2]
            if decode_update_fn is not None:
                decode_update_fn(ck, cv, k[:, 0], v[:, 0], slot)
            else:
                B, W, KvH, Dh = ck.shape
                idx = slot.view(B, 1, 1).expand(B, 1, KvH * Dh)
                ck.view(B, W, KvH * Dh).scatter_(
                    1, idx, k.reshape(B, 1, KvH * Dh).to(ck.dtype))
                cv.view(B, W, KvH * Dh).scatter_(
                    1, idx, v.reshape(B, 1, KvH * Dh).to(cv.dtype))
            attn = decode_attn_fn or (da_ops.decode_attention_plain if plain
                                      else da_ops.decode_attention)
            o = attn(q[:, 0], ck, cv, valid, window=0)
            x = x + self.mixer.out(o[:, None])
        if self.has_xattn:
            x = x + _attend_memory(self.xattn, self.lnx(x), cache_kv[2:],
                                   mem_valid, plain)
        return self._ffn(x, True)


class EncoderBlock(nn.Module):
    """One pre-norm bidirectional encoder layer: ``ln1``, attention with
    RoPE and no mask, ``ln2``, the MLP (``_init_encoder_block``)."""

    def __init__(self, cfg: ArchConfig, mk: L.Maker):
        super().__init__()
        self.ln1 = L.Norm(cfg, mk)
        self.mixer = L.Attention(cfg, mk)
        self.ln2 = L.Norm(cfg, mk)
        self.ffn = L.MLP(cfg, mk)

    def forward(self, x, tables, *, plain: bool = False) -> torch.Tensor:
        y, _, _ = self.mixer.block(self.ln1(x), "encoder", tables,
                                   plain=plain)
        x = x + y
        return x + self.ffn(self.ln2(x))


def _attend_memory(attn: L.Attention, h, kv, valid, plain: bool):
    """One query token a sequence, q = h's projection without RoPE,
    against the memory's cached K/V ``kv`` (every row valid)."""
    ck, cv = kv
    fn = da_ops.decode_attention_plain if plain else da_ops.decode_attention
    return attn.out(fn(attn.q(h)[:, 0], ck, cv, valid)[:, None])


def _write_memory(k, v, cache_kv) -> None:
    """The memory's K/V [B, F, KvH, Dh] into its cache slots, whole."""
    ck, cv = cache_kv
    if k.shape != ck.shape:
        raise ValueError(f"memory K/V {list(k.shape)} do not fit the cache "
                         f"{list(ck.shape)}")
    ck.copy_(k)
    cv.copy_(v)


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
    """Embedding, the frontend projection (``cfg.frontend``),
    ``cfg.n_layers`` decoder blocks, the encoder (``cfg.encoder_layers``
    blocks and ``enc_norm``), final norm and (un)tied head.

    ``gen=None`` leaves the weights uninitialised, to be loaded (see
    ``repro_torch.models.convert``); then call ``tie()``.  With
    ``device="meta"`` (and no ``gen``) it holds shapes and dtypes alone and
    allocates nothing, as the dry run plans a model of any size.  ``train``
    builds the training storage (``layers`` module docstring)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 gen: torch.Generator | None = None, train: bool = False):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.train_storage = train
        dev = resolve_device(device)
        mk = L.Maker(gen, dev, train=train)
        # the reference's draw order: embedding, frontend projection, the
        # blocks period position-major, the tail, the encoder, the head
        self.embed = mk.embed(cfg.vocab, cfg.d_model)
        if cfg.frontend:
            # the reference computes with it in float32 (``_frontend_kv``)
            self.frontend_proj = mk.dense(cfg.frontend_dim, cfg.d_model,
                                          ("frontend", "embed"),
                                          dtype=torch.float32)
        kinds = cfg.layer_kinds()
        period, reps = cfg.period, cfg.n_layers // cfg.period
        blocks: dict[int, Block] = {}
        for j in range(period):
            for r in range(reps):
                li = r * period + j
                blocks[li] = Block(cfg, kinds[li], mk,
                                   moe=cfg.is_moe_layer(li))
        for li in range(reps * period, cfg.n_layers):
            blocks[li] = Block(cfg, kinds[li], mk, moe=cfg.is_moe_layer(li))
        self.blocks = nn.ModuleList(blocks[li] for li in range(cfg.n_layers))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(EncoderBlock(cfg, mk)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = L.Norm(cfg, mk)
        self.final_norm = L.Norm(cfg, mk)
        if not cfg.tie_embeddings:
            self.lm_head = mk.dense(cfg.d_model, cfg.vocab, ("embed", "vocab"),
                                    dtype=L.torch_dtype(cfg.dtype))
        #: {parameter name: the reference's logical axes} (``param_axes``)
        self.logical_axes = {name: mk.axes[id(p)]
                             for name, p in self.named_parameters()}
        #: the ``DeviceMesh`` the parameters are laid out on
        #: (``distributed.sharding.shard_model``); None: plain tensors
        self.mesh = None
        self.unembed_w = None
        self.tie()

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def first_layers(self, n: int, encoder_layers: int | None = None
                     ) -> "Transformer":
        """The model cut to its first ``n`` decoder layers (and its first
        ``encoder_layers`` encoder layers, where given), sharing every
        weight (a run at full width and reduced depth)."""
        cut = copy.copy(self)
        cut._modules = dict(self._modules)
        cut.blocks = nn.ModuleList(list(self.blocks)[:n])
        depth = dict(n_layers=n)
        if encoder_layers is not None:
            cut.encoder = nn.ModuleList(list(self.encoder)[:encoder_layers])
            depth["encoder_layers"] = encoder_layers
        cut.cfg = dataclasses.replace(self.cfg, **depth)
        return cut

    def tie(self) -> None:
        """The tied head's weight as the reference computes with it:
        ``embed`` cast to ``cfg.dtype`` (kept once, not cast every step).
        The training storage keeps none: ``unembed`` casts ``embed`` inside
        the graph at every call, so the head's gradient reaches it."""
        if self.cfg.tie_embeddings and not self.train_storage:
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

    def frontend_kv(self, emb: torch.Tensor) -> torch.Tensor:
        """Frontend embeddings [B, F, frontend_dim] projected to
        [B, F, d_model]: a float32 product cast to ``cfg.dtype``, as the
        reference's ``_frontend_kv`` (a plain matmul: the reference runs it
        outside any kernel; on the card it relies on PyTorch's default of
        no TF32 in float32 matmuls)."""
        cfg = self.cfg
        if tuple(emb.shape[1:]) != (cfg.frontend_len, cfg.frontend_dim):
            raise ValueError(
                f"{cfg.name}: frontend embeddings must be [B, "
                f"{cfg.frontend_len}, {cfg.frontend_dim}] (got "
                f"{list(emb.shape)})")
        return (emb.float() @ self.frontend_proj).to(
            L.torch_dtype(cfg.dtype))

    def encode(self, x: torch.Tensor, *, plain: bool = False,
               split: fsdp.Split | None = None) -> torch.Tensor:
        """The bidirectional encoder over the projected frontend x
        [B, F, d_model] (RoPE at positions 0..F-1, no mask), then
        ``enc_norm``, as the reference's ``_encode``; each block on its
        gathered weights under ``split`` (a sharded model)."""
        tables = L.rope_tables(
            torch.arange(x.shape[1], device=x.device)[None, :],
            self.cfg.head_dim_, theta=self.cfg.rope_theta,
            fraction=self.cfg.rope_fraction)
        for blk in self.encoder:
            with fsdp.gathered(blk.modules(), split):
                x = blk(x, tables, plain=plain)
        return self.enc_norm(x)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.cfg.tie_embeddings:
            w = self.embed.to(x.dtype) if self.unembed_w is None \
                else self.unembed_w
            # T5-style 1/sqrt(d) scaling of the tied logits, as the reference
            return (x @ w.t()) * (self.cfg.d_model ** -0.5)
        return x @ self.lm_head.to(x.dtype)

    def _tables(self, positions: torch.Tensor):
        """RoPE tables for the self-attention layers; None without any."""
        if not any(b.kind in ATTN_KINDS for b in self.blocks):
            return None
        return L.rope_tables(positions, self.cfg.head_dim_,
                             theta=self.cfg.rope_theta,
                             fraction=self.cfg.rope_fraction)


def param_axes(model: Transformer) -> dict[str, tuple]:
    """{parameter name: logical axes tuple}: the reference's axes of the
    leaf the parameter comes from (``init_model_axes``), without the
    leading ``"layers"`` axis of a stacked ``blocks/pos{j}`` or
    ``encoder`` leaf (the port keeps one tensor a layer)."""
    return {name: model.logical_axes[name]
            for name, _ in model.named_parameters()}


def init_model(seed: int, cfg: ArchConfig, *, device=None,
               train: bool = False) -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the reference's distributions and scales (not its bits); ``train``
    builds the training storage."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, gen=gen, train=train)


def _memory(model: Transformer, frontend_emb, plain: bool,
            split: fsdp.Split | None = None):
    """The memory the ``cross`` and ``xattn`` layers attend: the projected
    frontend embeddings, through the encoder where the config has one; None
    without a frontend.  A config with a frontend needs the embeddings, one
    without takes none."""
    cfg = model.cfg
    if (frontend_emb is None) != (cfg.frontend is None):
        raise ValueError(
            f"{cfg.name}: " + (f"the model needs the {cfg.frontend} "
                               "frontend's embeddings" if cfg.frontend else
                               "the config has no frontend"))
    if frontend_emb is None:
        return None
    memory = model.frontend_kv(frontend_emb)
    if cfg.encoder_layers:
        memory = model.encode(memory, plain=plain, split=split)
    return memory


def _outer_modules(model: Transformer) -> list:
    """The model's modules outside its blocks: the embedding (and tied
    head), frontend projection, ``enc_norm``, ``final_norm``, the head."""
    return [m for name, m in model.named_modules()
            if not name.startswith(("blocks", "encoder"))]


def forward(model: Transformer, tokens: torch.Tensor,
            frontend_emb: torch.Tensor | None = None, *, remat: bool = False,
            plain: bool = False, split: fsdp.Split | None = None):
    """Full-sequence forward of tokens [B, S] with no cache -> (logits
    [B, S, V], aux), aux the float32 sum of the MoE layers' load-balance
    losses (0 without MoE layers): the reference's ``forward``.  A config
    with a frontend takes its embeddings [B, F, frontend_dim] (projected,
    and encoded where the config has an encoder).  ``remat`` recomputes
    each repetition of the layer period in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference wraps its
    scan body in ``jax.checkpoint``; the remainder (``tail``) layers are
    not, as there.  The reference's ``kv_chunk`` (its jnp attention's KV
    chunk) and ``unroll`` change no value beyond summation order and have
    no counterpart.  ``plain`` runs the plain versions on a CUDA tensor too
    (parity checks only).  A sharded model (``model.mesh``) computes on
    gathered weights (module docstring), its batch's rows split over
    ``split``'s axes (default: replicated, split over none)."""
    cfg = model.cfg
    if model.mesh is not None and split is None:
        split = fsdp.Split(model.mesh)
    tables = model._tables(torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :])
    period, reps = cfg.period, cfg.n_layers // cfg.period
    blocks = list(model.blocks)

    def body(x, aux, blks):
        for blk in blks:
            with fsdp.gathered(blk.modules(), split):
                x, a = blk(x, tables, memory=memory, plain=plain,
                           split=split)
            if a is not None:
                aux = aux + a
        return x, aux

    with fsdp.gathered(_outer_modules(model), split):
        memory = _memory(model, frontend_emb, plain, split)
        x = model.embed_tokens(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for r in range(reps):
            blks = blocks[r * period:(r + 1) * period]
            if remat:
                x, aux = checkpoint(body, x, aux, blks, use_reentrant=False)
            else:
                x, aux = body(x, aux, blks)
        x, aux = body(x, aux, blocks[reps * period:])
        return model.unembed(x), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Cache:
    """Zeroed per-layer cache tensors, as the reference's ``init_cache``
    (layout in the module docstring): (k, v) [batch, W, KvH, Dh] in
    ``dtype``, W being ``max_len`` for a global layer,
    ``min(window, max_len)`` for a local or chunk one and
    ``cfg.frontend_len`` for a ``cross`` one, with (xk, xv)
    [batch, frontend_len, KvH, Dh] after them for an encoder-decoder
    layer; for an ``rglru`` layer (conv [batch, 3, W] in ``dtype``, h
    [batch, W] float32, W = ``lru_width or d_model``); for an ``ssd``
    layer (conv [batch, K-1, Din + 2 G N] in ``dtype``, state
    [batch, H, P, N] float32)."""
    cfg.validate()
    dev = resolve_device(device)
    KvH, Dh = cfg.n_kv_heads, cfg.head_dim_

    def kv(rows: int) -> tuple:
        return tuple(torch.zeros((batch, rows, KvH, Dh), dtype=dtype,
                                 device=dev) for _ in range(2))
    cache = []
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            W = cfg.lru_width or cfg.d_model
            cache.append((
                torch.zeros((batch, L.RGLRU.CONV - 1, W), dtype=dtype,
                            device=dev),
                torch.zeros((batch, W), dtype=torch.float32, device=dev)))
        elif kind == "ssd":
            Din, H, G, N = L.mamba2_split(cfg)
            cache.append((
                torch.zeros((batch, cfg.conv_kernel - 1, Din + 2 * G * N),
                            dtype=dtype, device=dev),
                torch.zeros((batch, H, cfg.ssm_head_dim, N),
                            dtype=torch.float32, device=dev)))
        else:
            layer = kv(cfg.frontend_len if kind == "cross"
                       else cache_window(cfg, kind, max_len))
            if has_xattn(cfg, kind):
                layer += kv(cfg.frontend_len)
            cache.append(layer)
    return cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: Cache,
            frontend_emb: torch.Tensor | None = None, *,
            plain: bool = False):
    """Equal-length batched prefill of tokens [B, S]: projects the
    frontend embeddings [B, F, frontend_dim] (and runs the encoder over
    them), runs the full sequence and fills ``cache`` in place, the
    memory's K/V included.  Returns (last-token logits [B, V], lengths [B]
    int32).  A config with a frontend needs ``frontend_emb`` (the
    reference, given none, fails for every prompt whose length is not
    F); one without takes none."""
    B, S = tokens.shape
    memory = _memory(model, frontend_emb, plain)
    x = model.embed_tokens(tokens)
    tables = model._tables(torch.arange(S, device=tokens.device)[None, :])
    for blk, kv in zip(model.blocks, cache):
        x = blk.prefill(x, tables, kv, memory=memory, plain=plain)
    logits = model.unembed(x[:, -1:])[:, 0]
    return logits, torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                lengths: torch.Tensor, cache: Cache, *,
                plain: bool = False, decode_attn_fn=None,
                decode_update_fn=None) -> torch.Tensor:
    """One decode step: tokens [B, 1]; lengths [B] int32 = current cache
    length.  Writes each layer's new K/V into ``cache`` in place and returns
    logits [B, V].  The valid rows a self-attention layer attends are
    ``lengths + 1`` (global), ``min(lengths + 1, W)`` (local, rolling) or
    ``lengths % window + 1`` (chunk), always with window 0, as the
    reference's ``_decode_self_attention``; a ``cross`` layer and an
    ``xattn`` attend all F memory rows.  A recurrent layer steps its
    recurrence (``layers.RGLRU.decode``, ``layers.Mamba2.decode``).

    The reference's hooks: ``decode_update_fn(ck, cv, k, v, slot)`` writes
    a self-attention layer's new K/V (k, v [B, KvH, Dh]) into its cache in
    place, and ``decode_attn_fn(q, ck, cv, valid, window=0)`` attends it;
    with neither the step is unchanged.  A hook carrying ``seq_shards``
    (``repro_torch.distributed.collectives``) takes this rank's slice of a
    cache whose rows are split over that many ranks: a layer's slot and
    valid rows are computed from its global rows, the local rows times
    ``seq_shards``."""
    cfg = model.cfg
    x = model.embed_tokens(tokens)
    tables = model._tables(lengths[:, None])
    ln = lengths.to(torch.int64)
    mem_valid = None
    if cfg.frontend:
        mem_valid = torch.full(lengths.shape, cfg.frontend_len,
                               dtype=torch.int32, device=lengths.device)
    shards = getattr(decode_update_fn or decode_attn_fn, "seq_shards", 1)
    where: dict = {}     # (kind, W) -> (slot, valid) of an attention layer
    for blk, kv in zip(model.blocks, cache):
        key = (blk.kind, kv[0].shape[1] * shards)
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
        x = blk.decode(x, tables, kv, slot, valid, mem_valid, plain=plain,
                       decode_attn_fn=decode_attn_fn,
                       decode_update_fn=decode_update_fn)
    return model.unembed(x)[:, 0]
