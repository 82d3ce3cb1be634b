"""Optional activation-sharding constraints.

Port of ``src/repro/distributed/actsharding.py``.  The reference pins its
MLP hiddens to P(batch_axes, ..., "model") and its MLP weights to their
gathered form so that XLA's SPMD partitioner gathers a few-MB weight
rather than all-reducing a multi-GB activation.  Here the same hooks act
on ``DTensor`` arguments: enabled, they ``redistribute`` a ``DTensor`` to
the reference's placements (``sharding.placements`` of its spec on the
tensor's own mesh); a plain tensor has no layout to constrain and is
returned as it is.

Disabled by default (and always on one device): both return their
argument itself, the same object, so a model that calls them computes
bitwise what it did without them.  ``models.layers.MLP`` calls them where
the reference's ``mlp_block`` does.
"""
from __future__ import annotations

_STATE = {"enabled": False, "dp": ("data",)}


def enable(dp=("data",)) -> None:
    _STATE["enabled"] = True
    _STATE["dp"] = tuple(dp)


def disable() -> None:
    _STATE["enabled"] = False


def _constrain(x, spec: list):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(tuple(spec),
                                                     x.device_mesh))


def constrain_hidden(h, *, batch_dims: int = 2, model_dim: bool = True):
    """h [B, S, ..., F]: pin batch to dp axes and the trailing (FFN/head)
    dim to "model"; middle dims replicated."""
    if not _STATE["enabled"]:
        return h
    spec = [None] * h.ndim
    spec[0] = _STATE["dp"]
    if model_dim:
        spec[-1] = "model"
    return _constrain(h, spec)


def gathered_weight(w, *, model_dim: int | None = -1):
    """Pin a weight to its all-gathered form (FSDP dims replicated, TP dim
    kept on "model") at the use site."""
    if not _STATE["enabled"]:
        return w
    spec = [None] * w.ndim
    if model_dim is not None:
        spec[model_dim] = "model"
    return _constrain(w, spec)
