"""Checkpointing: flattened-key npz for arrays + JSON metadata.

Port of ``src/repro/training/checkpoint.py``, writing and reading the
reference's exact files: ``params.npz`` (the parameters as the reference's
nested, period-stacked tree, ``convert.to_jax_tree``, flattened to keys
such as ``blocks/pos0/mixer/wq`` and ``tail/0/ln1/scale``),
``opt_state.npz`` (``.step``, ``.m/<key>``, ``.v/<key>``: the key paths
``jax.tree_util`` gives an ``OptState``) and ``meta.json``.  Either
package restores the other's checkpoint.  Arrays are copied to the host
before writing.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.training.optimizer import OptState


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{"a/b/0/c": leaf} of a nested dict / list tree, as the reference's
    ``_flatten`` names its leaves."""
    flat = {}
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for key, value in items:
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, (dict, list)):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def save(path: str, model, opt_state: OptState | None = None, *,
         step: int = 0, metadata: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(convert.to_jax_tree(model)))
    if opt_state is not None:
        flat = {".step": np.asarray(int(opt_state.step), np.int32)}
        for field in ("m", "v"):
            tree = convert.to_jax_tree(model, getattr(opt_state, field))
            flat.update({f".{field}/{k}": v
                         for k, v in _flatten(tree).items()})
        np.savez(os.path.join(path, "opt_state.npz"), **flat)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)


def _load_values(model, flat: dict, prefix: str) -> dict:
    """{parameter name: array} from a flattened tree under ``prefix``."""
    out = {}
    for name, p in model.named_parameters():
        path, idx = convert.reference_path(name, model.cfg)
        key = prefix + "/".join(str(k) for k in path)
        arr = flat[key] if idx is None else flat[key][idx]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"checkpoint {key}: shape {arr.shape} does not "
                             f"fit {tuple(p.shape)}")
        out[name] = arr
    return out


def restore(path: str, model, opt_state: OptState | None = None):
    """Restore into ``model``'s parameters (and ``opt_state``'s step and
    moments) in place, each cast to its dtype; returns (model, meta) or
    (model, opt_state, meta)."""
    with np.load(os.path.join(path, "params.npz")) as f:
        values = _load_values(model, dict(f), "")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(values[name]).to(p.dtype))
    model.tie()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if opt_state is None:
        return model, meta
    with np.load(os.path.join(path, "opt_state.npz")) as f:
        flat = dict(f)
    with torch.no_grad():
        for field in ("m", "v"):
            for name, arr in _load_values(model, flat, f".{field}/").items():
                getattr(opt_state, field)[name].copy_(torch.as_tensor(arr))
        opt_state.step.copy_(torch.as_tensor(flat[".step"]))
    return model, opt_state, meta
