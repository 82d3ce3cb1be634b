"""Checkpointing: flattened-key npz for arrays + JSON metadata.

Port of ``src/repro/training/checkpoint.py``, writing and reading the
reference's exact files: ``params.npz`` (the parameters as the reference's
nested, period-stacked tree, ``convert.to_jax_tree``, flattened to keys
such as ``blocks/pos0/mixer/wq`` and ``tail/0/ln1/scale``),
``opt_state.npz`` (``.step``, ``.m/<key>``, ``.v/<key>``: the key paths
``jax.tree_util`` gives an ``OptState``) and ``meta.json``.  Either
package restores the other's checkpoint.  Arrays are copied to the host
before writing.

A sharded model (``distributed.sharding.shard_model``) writes the same
files: every rank of its mesh calls ``save``, which gathers the full
parameters and moments, rank 0 writes them and the ranks wait for it;
``restore`` into a sharded model copies each rank's block of the full
arrays.  So a checkpoint saved on any mesh restores on any other, in the
reference and in the unsharded port.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as SH
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
    """Write ``model``'s parameters (and ``opt_state``) as the reference's
    files; a sharded model's ranks all call it (module docstring)."""
    sharded = model.mesh is not None
    params = SH.full_values(model)
    moments = {} if opt_state is None else {
        field: SH.full_values(model, getattr(opt_state, field))
        for field in ("m", "v")}
    if not sharded or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "params.npz"),
                 **_flatten(convert.to_jax_tree(model, params)))
        if opt_state is not None:
            flat = {".step": np.asarray(int(opt_state.step), np.int32)}
            for field, values in moments.items():
                tree = convert.to_jax_tree(model, values)
                flat.update({f".{field}/{k}": v
                             for k, v in _flatten(tree).items()})
            np.savez(os.path.join(path, "opt_state.npz"), **flat)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": step, **(metadata or {})}, f)
    if sharded:
        dist.barrier()


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
    moments) in place, each cast to its dtype (a sharded model's each
    rank's blocks); returns (model, meta) or (model, opt_state, meta)."""
    with np.load(os.path.join(path, "params.npz")) as f:
        values = _load_values(model, dict(f), "")
    SH.load_full(dict(model.named_parameters()), values)
    model.tie()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if opt_state is None:
        return model, meta
    with np.load(os.path.join(path, "opt_state.npz")) as f:
        flat = dict(f)
    for field in ("m", "v"):
        SH.load_full(getattr(opt_state, field),
                     _load_values(model, flat, f".{field}/"))
    with torch.no_grad():
        opt_state.step.copy_(torch.as_tensor(flat[".step"]))
    return model, opt_state, meta
