"""Carry the JAX package's weights and serving cache across into the port.

Torch cannot reproduce ``jax.random`` bits, so a parity test initialises
the reference model (``repro.models.transformer.init_model``), hands its
parameter tree across as numpy arrays (``jax.tree.map(np.asarray, ...)``)
and loads it here.  The reference stacks period position ``j``'s
parameters over the repetitions (``blocks/pos{j}`` with a leading [reps]
axis) and keeps the remainder layers in ``tail``; layer
``li = r * period + j`` of the port is ``blocks/pos{j}[r]``.  The serving
cache is stacked the same way.  This module imports no JAX: it reads
nested dicts and lists of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


def _layer_trees(tree: dict, cfg: ArchConfig) -> list:
    """The per-layer subtrees of a stacked ``{"blocks", "tail"}`` tree."""
    period, reps = cfg.period, cfg.n_layers // cfg.period
    out = []
    for li in range(cfg.n_layers):
        r, j = divmod(li, period)
        if r < reps:
            out.append(_index(tree["blocks"][f"pos{j}"], r))
        else:
            out.append(tree["tail"][li - reps * period])
    return out


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _load(param: torch.nn.Parameter, value) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {value.shape} does not fit "
                         f"{tuple(param.shape)}")
    param.data.copy_(torch.as_tensor(value.astype(np.float32)))


def _load_norm(norm, p: dict) -> None:
    _load(norm.scale, p["scale"])
    if hasattr(norm, "bias"):
        _load(norm.bias, p["bias"])


def _load_by_name(module, p: dict) -> None:
    for name, value in p.items():
        _load(getattr(module, name), value)


def params_from_jax(params_np: dict, cfg: ArchConfig, device=None
                    ) -> T.Transformer:
    """A ``Transformer`` holding the reference's parameters (nested dicts
    of numpy arrays, as ``init_model`` builds them).  Each weight is stored
    in the port's storage dtype (``cfg.dtype`` for the projections, float32
    for norm scales and biases, the embedding, the frontend projection,
    ``xgate``, the MoE router, the RG-LRU gates and the conv, decay and
    skip parameters).  Every mixer parameter (attention, RG-LRU or Mamba2),
    every ``xattn`` parameter and every feed-forward parameter (the MLP's
    ``wi``, ``wo``; the MoE's ``router``, ``wi``, ``wo``) loads by its
    reference name; a block without an MLP (``d_ff`` 0) has no ``ln2`` or
    ``ffn``.  The stacked ``encoder`` [n_enc, ...] loads one layer at a
    time."""
    model = T.Transformer(cfg, device=device)
    _load(model.embed, params_np["embed"])
    if cfg.frontend:
        _load(model.frontend_proj, params_np["frontend_proj"])
    for blk, p in zip(model.blocks, _layer_trees(params_np, cfg)):
        _load_norm(blk.ln1, p["ln1"])
        _load_by_name(blk.mixer, p["mixer"])
        if blk.kind == "cross":
            _load(blk.xgate, p["xgate"])
        if blk.has_xattn:
            _load_norm(blk.lnx, p["lnx"])
            _load_by_name(blk.xattn, p["xattn"])
        if blk.has_ffn:
            _load_norm(blk.ln2, p["ln2"])
            _load_by_name(blk.ffn, p["ffn"])
    for i, blk in enumerate(getattr(model, "encoder", ())):
        p = _index(params_np["encoder"], i)
        for name in ("ln1", "ln2"):
            _load_norm(getattr(blk, name), p[name])
        _load_by_name(blk.mixer, p["mixer"])
        _load_by_name(blk.ffn, p["ffn"])
    if cfg.encoder_layers:
        _load_norm(model.enc_norm, params_np["enc_norm"])
    _load_norm(model.final_norm, params_np["final_norm"])
    if not cfg.tie_embeddings:
        _load(model.lm_head, params_np["lm_head"])
    model.tie()
    return model


#: the reference's cache entries of each recurrent kind (attention and
#: ``cross``: k, v)
CACHE_NAMES = {"rglru": ("conv", "h"), "ssd": ("conv", "state")}


def cache_from_jax(cache_np: dict, cfg: ArchConfig, device=None) -> T.Cache:
    """The port's per-layer cache from the reference's stacked serving
    cache (``init_cache`` / ``prefill`` / ``decode_step``), in the reference
    cache's dtypes: (k, v) of an attention or ``cross`` layer, followed by
    (xk, xv) for an encoder-decoder layer, (conv, h) of an ``rglru`` layer,
    (conv, state) of an ``ssd`` layer."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    out = []
    for kind, c in zip(cfg.layer_kinds(), _layer_trees(cache_np, cfg)):
        names = CACHE_NAMES.get(kind, ("k", "v"))
        if T.has_xattn(cfg, kind):
            names += ("xk", "xv")
        out.append(tuple(_tensor(c[n]).to(dev) for n in names))
    return out


def _tensor(value) -> torch.Tensor:
    """A copy of a numpy array as a tensor of its dtype; numpy's bfloat16
    (``ml_dtypes``, which a bf16 prefill's conv state is) goes through
    float32, exactly."""
    value = np.array(value)
    if value.dtype.name == "bfloat16":
        return torch.as_tensor(value.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(value)
