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

Every parameter of the port maps to one place in the reference's tree
(``reference_path``: its key path and, for a stacked leaf, the repetition
or encoder layer it indexes), by its module name: ``blocks.{li}.mixer.wq``
is ``blocks/pos{j}/mixer/wq`` [r], ``encoder.{i}.ffn.wi`` is
``encoder/ffn/wi`` [i].  ``params_from_jax`` loads through it (``train``:
the training storage), ``values_from_jax`` maps any tree of the
reference's shape (a gradient or AdamW moment tree) onto the port's
parameter names, and ``to_jax_tree`` writes the port's values back as the
reference's nested, period-stacked tree (the checkpoint's layout).
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


def reference_path(name: str, cfg: ArchConfig) -> tuple[tuple, int | None]:
    """(key path in the reference's tree, index into its stacked leading
    axis or None) of the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        li = int(parts[1])
        period, reps = cfg.period, cfg.n_layers // cfg.period
        r, j = divmod(li, period)
        if r < reps:
            return ("blocks", f"pos{j}", *parts[2:]), r
        return ("tail", li - reps * period, *parts[2:]), None
    if parts[0] == "encoder":
        return ("encoder", *parts[2:]), int(parts[1])
    return tuple(parts), None


def leaf_groups(model: T.Transformer) -> list[list[str]]:
    """The port's parameter names grouped by the reference leaf they come
    from (a stacked leaf groups its repetitions or encoder layers, in
    order), the groups in the reference's leaf order (``jax.tree.leaves``:
    dict keys sorted, list items in order)."""
    groups: dict = {}
    for name, _ in model.named_parameters():
        path, idx = reference_path(name, model.cfg)
        groups.setdefault(path, []).append((idx or 0, name))
    return [[n for _, n in sorted(groups[path])] for path in sorted(groups)]


def _lookup(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def values_from_jax(tree: dict, model: T.Transformer) -> dict:
    """{port parameter name: numpy array} of a tree of the reference's
    parameter shape (its parameters, gradients or AdamW moments)."""
    out = {}
    for name, _ in model.named_parameters():
        path, idx = reference_path(name, model.cfg)
        value = np.asarray(_lookup(tree, path))
        out[name] = value if idx is None else value[idx]
    return out


def to_jax_tree(model: T.Transformer, values: dict | None = None) -> dict:
    """The reference's nested tree (``blocks/pos{j}`` stacked over the
    repetitions, ``tail`` a list, ``encoder`` stacked) of ``values`` ({port
    parameter name: array-like}; default the model's parameters), as
    float32 numpy arrays unless a value has another dtype."""
    tree: dict = {}
    stacked: dict = {}
    if values is None:
        values = {n: p for n, p in model.named_parameters()}
    for name, _ in model.named_parameters():
        path, idx = reference_path(name, model.cfg)
        value = values[name]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            value = value.float() if value.is_floating_point() else value
            value = value.numpy()
        if idx is not None:
            stacked.setdefault(path, {})[idx] = np.asarray(value)
            continue
        _put(tree, path, np.asarray(value))
    for path, rows in stacked.items():
        _put(tree, path, np.stack([rows[i] for i in range(len(rows))]))
    if model.cfg.n_layers % model.cfg.period == 0:
        tree["tail"] = []
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def _load(param: torch.nn.Parameter, value) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape {value.shape} does not fit "
                         f"{tuple(param.shape)}")
    param.data.copy_(torch.as_tensor(value.astype(np.float32)))


def params_from_jax(params_np: dict, cfg: ArchConfig, device=None, *,
                    train: bool = False) -> T.Transformer:
    """A ``Transformer`` holding the reference's parameters (nested dicts
    of numpy arrays, as ``init_model`` builds them), every parameter loaded
    from its ``reference_path``.  Each weight is stored in the port's
    storage dtype: serving (``cfg.dtype`` for the projections, float32 for
    norm scales and biases, the embedding, the frontend projection,
    ``xgate``, the MoE router, the RG-LRU gates and the conv, decay and
    skip parameters), or with ``train`` the training storage (all float32,
    requiring grad)."""
    model = T.Transformer(cfg, device=device, train=train)
    values = values_from_jax(params_np, model)
    n_ref = sum(int(np.size(x)) for x in _leaves(params_np))
    n_port = sum(int(np.size(x)) for x in values.values())
    if n_ref != n_port:
        raise ValueError(f"{cfg.name}: the reference tree holds {n_ref} "
                         f"values, the port's parameters {n_port}")
    with torch.no_grad():
        for name, value in values.items():
            _load(model.get_parameter(name), value)
    model.tie()
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


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
