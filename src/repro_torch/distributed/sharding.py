"""Sharding rules: logical parameter axes -> mesh axes.

Port of ``src/repro/distributed/sharding.py``.  Every parameter carries a
tuple of logical axis names (``models.layers.Maker``,
``models.transformer.param_axes``).  ``spec_for`` resolves them to mesh
axes under a rules dict, *dropping* any assignment whose dimension does not
divide the mesh axis size (seamless-m4t's vocab 256206 on a 16-way model
axis falls back to replication), so mixed-divisibility architectures always
lay out.

A spec is the port's counterpart of a ``PartitionSpec``: a tuple with one
entry a tensor dimension, each a mesh-axis name, a tuple of names (split
major to minor) or None (replicated).  Every function here reads only the
mesh's axis names and sizes, from anything "mesh-like": an object with
``.shape`` (name -> size) and ``.axis_names``, such as ``MeshShape`` (a plan
with no processes: the dry run lays out 256 or 512 devices), or a real
``torch.distributed.DeviceMesh`` with named dimensions.  ``placements``
turns a spec into ``DTensor`` placements on a ``DeviceMesh``.

``shard_model`` lays a model's parameters out on a ``DeviceMesh`` by these
rules (each a ``DTensor`` holding this rank's block), ``full_values`` and
``load_full`` gather and scatter them (checkpoints, tests), ``shard_of``
takes a rank's block of any array under a spec (the batch's rows under
``data_spec``) and ``batch_split`` says which mesh axes a batch's rows are
split over (``distributed.fsdp``: the train step computes on gathered
weights).

Default placement (single-pod mesh ("data", "model")):
  * "embed" (d_model dims of weights)          -> "data"   (FSDP-style)
  * "vocab" / "heads" / "mlp" / "head_dim"     -> "model"  (megatron TP)
  * experts: llama4 (128) shards experts on "model"; mixtral (8 < 16)
    shards the expert FFN dim instead (see rules_for_config).
Multi-pod mesh ("pod", "data", "model"): weights are replicated across
pods (pure data parallelism on the "pod" axis); the batch shards over
("pod", "data").

The port's serving cache is a list with one tuple a layer
(``models.transformer`` docstring), where the reference's is a dict of
stacked leaves keyed by name; ``cache_shardings`` names each tuple position
once (``cache_names``) and gives each leaf the reference's spec of its
unstacked form.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import fsdp
from repro_torch.models import convert, transformer as T
from repro_torch.models.config import ArchConfig

BASE_RULES: dict[str, Any] = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "heads_flat": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "mlp2": None,
    "gate": None,
    "experts": "model",
    "expert_mlp": None,
    "conv": None,
    "layers": None,
    "frontend": None,
}

Spec = tuple


def _spec(*parts) -> Spec:
    """A spec from its entries, a one-name tuple written as the name (as a
    ``PartitionSpec`` normalises it)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


class MeshShape:
    """A mesh's axis names and sizes with no devices or processes behind
    them (the reference's functions read nothing else of a mesh)."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh-like object or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a torch DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def rules_for_config(cfg: ArchConfig) -> dict[str, Any]:
    rules = dict(BASE_RULES)
    if cfg.n_experts:
        # moe weights use ("experts", "embed", ..., "mlp"); pick the axis
        # that divides: many-expert models shard experts, few-expert models
        # shard the expert FFN dim (the divisibility fallback would too; it
        # is explicit so that both never collide on "model")
        if cfg.n_experts >= 16:
            rules["experts"] = "model"
            rules["expert_mlp"] = None
        else:
            rules["experts"] = None
            rules["expert_mlp"] = "model"
    return rules


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def spec_for(axes: tuple, shape: tuple, mesh, rules: dict) -> Spec:
    sizes = mesh_sizes(mesh)
    parts = []
    for name, dim in zip(axes, shape):
        ax = rules.get(name)
        if ax is not None and dim % _axis_size(sizes, ax) != 0:
            ax = None  # divisibility fallback -> replicate this dim
        parts.append(ax)
    return _spec(*parts)


def param_shardings(model: T.Transformer, mesh, rules: dict
                    ) -> dict[str, Spec]:
    """{parameter name: spec} of the model's parameters (shapes only: a
    ``device="meta"`` model will do)."""
    axes = T.param_axes(model)
    return {name: spec_for(axes[name], tuple(p.shape), mesh, rules)
            for name, p in model.named_parameters()}


def batch_axes(mesh) -> tuple:
    """Mesh axes carrying the global batch."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def data_spec(mesh, ndim: int, batch: int | None = None) -> Spec:
    """[B, ...] arrays: batch over (pod, data); replicated if indivisible
    (e.g. long_500k's global_batch=1)."""
    axes = batch_axes(mesh)
    if batch is not None:
        sizes = mesh_sizes(mesh)
        if batch % math.prod(sizes[a] for a in axes) != 0:
            return (None,) * ndim
    return _spec(axes, *(None,) * (ndim - 1))


def cache_spec(mesh, path_keys: tuple[str, ...], shape: tuple,
               cfg: ArchConfig, *, stacked: bool,
               seq_axis: str | None = None) -> Spec:
    """Sharding for one serving-cache leaf, identified by its name.

    KV caches [.., B, S, KvH, Dh]: default — batch over (pod,data),
    kv-heads over "model" when divisible else head_dim over "model".
    seq_axis = "data": long-context (batch=1) shards S over data.
    seq_axis = "model": perf variant — S over model, batch over data
    (pairs with the sequence-sharded decode attention, ``collectives``).
    States: batch over (pod,data); wide dims over "model" when divisible.
    """
    sizes = mesh_sizes(mesh)
    name = path_keys[-1]
    lead = (None,) if stacked else ()
    dp = batch_axes(mesh)
    model_n = sizes["model"]
    no_batch = seq_axis == "data"   # batch=1 long-context regime
    if name in ("k", "v", "xk", "xv"):
        B, S, KvH, Dh = shape[-4:]
        if seq_axis and S % sizes[seq_axis] == 0:
            b_ax = None if no_batch else dp
            hd_ax = "model" if (seq_axis != "model"
                                and Dh % model_n == 0) else None
            return _spec(*lead, b_ax, seq_axis, None, hd_ax)
        kv_ax = "model" if KvH % model_n == 0 else None
        hd_ax = None if kv_ax else ("model" if Dh % model_n == 0 else None)
        return _spec(*lead, None if no_batch else dp, None, kv_ax, hd_ax)
    if name == "state":   # ssd state [.., B, H, P, N]
        H = shape[-3]
        h_ax = "model" if H % model_n == 0 else None
        return _spec(*lead, None if no_batch else dp, h_ax, None, None)
    if name == "h":       # rglru hidden [.., B, W]
        W = shape[-1]
        return _spec(*lead, None if no_batch else dp,
                     "model" if W % model_n == 0 else None)
    if name == "conv":    # conv state [.., B, K-1, W]
        W = shape[-1]
        return _spec(*lead, None if no_batch else dp, None,
                     "model" if W % model_n == 0 else None)
    return _spec(*lead, *([None] * (len(shape) - len(lead))))


def cache_names(cfg: ArchConfig, kind: str) -> tuple[str, ...]:
    """The reference's cache names of a layer's tuple positions: (k, v)
    of an attention or ``cross`` layer, then (xk, xv) with an encoder;
    (conv, h) of ``rglru``; (conv, state) of ``ssd``."""
    names = convert.CACHE_NAMES.get(kind, ("k", "v"))
    if T.has_xattn(cfg, kind):
        names += ("xk", "xv")
    return names


def cache_shardings(cache: T.Cache, mesh, cfg: ArchConfig, *,
                    seq_shard: bool = False, seq_axis: str | None = None
                    ) -> list[tuple[Spec, ...]]:
    """A spec for every leaf of the port's cache (``init_cache``; any
    object with ``.shape`` will do for a leaf), laid out as the cache: one
    tuple a layer.  Each is the reference's spec of the leaf unstacked (a
    stacked leaf's spec is the same behind a leading None).  seq_shard=True
    is shorthand for seq_axis="data" (long-context)."""
    if seq_shard and seq_axis is None:
        seq_axis = "data"
    return [tuple(cache_spec(mesh, (name,), tuple(leaf.shape), cfg,
                             stacked=False, seq_axis=seq_axis)
                  for name, leaf in zip(cache_names(cfg, kind), layer))
            for kind, layer in zip(cfg.layer_kinds(), cache)]


def placements(spec: Spec, mesh) -> list:
    """``DTensor`` placements (one a mesh dimension, in the mesh's order)
    of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on every mesh axis that
    tensor dimension d's entry names, ``Replicate()`` on the others.  A
    tuple entry such as ("pod", "data") shards its dimension over both in
    the mesh's order, major to minor, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    owner: dict[str, int] = {}
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            if a is None:
                continue
            if a not in sizes or a in owner:
                raise ValueError(f"spec {spec}: mesh axis {a!r} unknown or "
                                 f"used twice (mesh {sizes})")
            owner[a] = d
    for ax in spec:
        names = ax if isinstance(ax, (tuple, list)) else ()
        order = [a for a in sizes if a in names]
        if list(names) != order:
            raise ValueError(f"spec {spec}: {tuple(names)} is not in the "
                             f"mesh's order {tuple(sizes)}")
    return [Shard(owner[a]) if a in owner else Replicate() for a in sizes]


def shard_of(x, spec: Spec, mesh):
    """This rank's block of ``x`` (a tensor or numpy array) under ``spec``
    on a ``DeviceMesh`` (``fsdp.local_block``)."""
    return fsdp.local_block(x, mesh, placements(spec, mesh))


def batch_split(mesh, batch: int) -> fsdp.Split:
    """The mesh axes a global batch of ``batch`` rows is split over:
    ``data_spec``'s batch axes, none where it replicates the batch."""
    ax = data_spec(mesh, 1, batch=batch)[0]
    return fsdp.Split(mesh, () if ax is None else
                      tuple(ax) if isinstance(ax, tuple) else (ax,))


@torch.no_grad()
def shard_model(model: T.Transformer, mesh) -> T.Transformer:
    """Lay ``model``'s parameters out on ``mesh`` in place, as the
    reference's launcher does (``rules_for_config``): each becomes a
    ``DTensor`` parameter (``placements(spec_for(...))``) holding this
    rank's block of the full value the model holds, which every rank must
    build the same (the same seed, or the same loaded weights); no
    collective runs.  Sets ``model.mesh``.  Returns the model."""
    specs = param_shardings(model, mesh, rules_for_config(model.cfg))
    for name, p in list(model.named_parameters()):
        owner, attr = _owner(model, name)
        pl = placements(specs[name], mesh)
        local = fsdp.local_block(p.detach(), mesh, pl).clone()
        owner._parameters[attr] = nn.Parameter(
            DTensor.from_local(local, mesh, pl, run_check=False,
                               shape=p.shape, stride=p.stride()),
            requires_grad=p.requires_grad)
    model.mesh = mesh
    return model


def _owner(model, name: str):
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def full_values(model: T.Transformer, values: dict | None = None) -> dict:
    """{parameter name: full tensor} of a sharded model's parameters, or of
    ``values`` laid out as them (its AdamW moments); every rank of the mesh
    must call this (it gathers).  Plain tensors pass as they are."""
    values = values if values is not None else dict(
        model.named_parameters())
    return {name: fsdp.full_value(values[name]).detach()
            for name, _ in model.named_parameters()}


@torch.no_grad()
def load_full(tensors: dict, values: dict) -> None:
    """Copy into each of ``tensors`` ({name: parameter or moment}) its block
    of the full value ``values[name]`` (an array or tensor), cast to its
    dtype: a ``DTensor`` takes this rank's block, a plain tensor all."""
    for name, t in tensors.items():
        v = torch.as_tensor(values[name])
        if isinstance(t, DTensor):
            t.to_local().copy_(fsdp.local_block(v, t.device_mesh,
                                                t.placements))
        else:
            t.copy_(v)
