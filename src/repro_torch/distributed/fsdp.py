"""Compute on gathered weights: the collectives of the sharded train step.

A sharded model (``sharding.shard_model``) stores every parameter as a
``DTensor`` on a ("data", "model") ``DeviceMesh`` (or ("pod", "data",
"model")): each rank holds its block under the reference's layout.  The
layers compute on plain full tensors, one block at a time, as FSDP does:
``gathered(modules, split)`` sets each ``DTensor`` parameter's full value
in front of it (in the module's instance dict, which attribute lookup reads
before the registered parameter) for the length of a ``with``; ``full``
gathers it differentiably, and its backward reduces the gradient back to
the rank's block:

* over a mesh axis that splits the batch (``Split.axes``), each rank's
  gradient is a partial sum of the global one: the backward sums over that
  axis (a reduce-scatter where the parameter is sharded on it, an
  all-reduce where it is replicated);
* over any other axis ("model", or "data" when the batch is replicated)
  the ranks computed the same rows, so each keeps its block and sums
  nothing (a sum there would multiply the gradient by the axis's size).

``gather_rows`` / ``own_rows`` are the same gather for activations (the
MoE layer's global dispatch), ``all_reduce`` sums the loss's token count
and metrics over the batch axes, and ``sum_over_shards`` the gradient
norm's squares over the axes that shard each parameter.

The collectives are c10d's ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_reduce`` on the process group of each
mesh dimension, never ``DTensor.redistribute``: DTensor redistributes
through the functional collectives, which end the process with a
segmentation fault over gloo on CUDA tensors (torch 2.11), where the c10d
calls work.  A mesh dimension of size 1 issues nothing, so a 1x1 mesh runs
no collective at all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class Split:
    """A batch's rows split over ``axes`` of ``mesh`` (the batch axes of
    ``sharding.data_spec``, major to minor; empty when the batch is
    replicated)."""
    mesh: object
    axes: tuple = ()

    def dims(self) -> tuple[int, ...]:
        """The mesh dimensions of ``axes`` larger than 1."""
        names = self.mesh.mesh_dim_names
        return tuple(names.index(a) for a in self.axes
                     if self.mesh.size(names.index(a)) > 1)

    @property
    def n(self) -> int:
        """Ranks the rows are split over."""
        return math.prod(self.mesh.size(i) for i in self.dims())

    def index(self) -> int:
        """This rank's block of rows (its coordinates, major to minor)."""
        i = 0
        for d in self.dims():
            i = i * self.mesh.size(d) + self.mesh.get_local_rank(d)
        return i


def local_block(x, mesh, placements):
    """This rank's block of a full tensor or numpy array ``x`` under
    ``placements`` on ``mesh``: along a dimension sharded over several mesh
    dimensions, split by each in the mesh's order, major to minor (as a
    ``PartitionSpec`` and ``DTensor`` split it).  Every split must divide."""
    idx = [slice(0, n) for n in x.shape]
    for i, pl in enumerate(placements):
        if not pl.is_shard() or mesh.size(i) == 1:
            continue
        d, s = pl.dim, idx[pl.dim]
        n = mesh.size(i)
        if (s.stop - s.start) % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split {n} ways")
        step = (s.stop - s.start) // n
        c = mesh.get_local_rank(i)
        idx[d] = slice(s.start + c * step, s.start + (c + 1) * step)
    return x[tuple(idx)]


def _all_gather(x: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    """x's blocks of every rank of ``group`` joined along dimension d."""
    x0 = x.movedim(d, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0], *x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, d).contiguous()


def _reduce_scatter(g: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    """This rank's block along d of the sum of g over ``group``."""
    g0 = g.movedim(d, 0).contiguous()
    out = g0.new_empty((g0.shape[0] // n, *g0.shape[1:]))
    dist.reduce_scatter_tensor(out, g0, group=group)
    return out.movedim(0, d)


def _gather(x, mesh, shards) -> torch.Tensor:
    """The full tensor of a block sharded as ``shards`` ((mesh dim, tensor
    dim) in the mesh's order): gathered over the minor dimension first."""
    for i, d in reversed(shards):
        x = _all_gather(x, d, mesh.get_group(i), mesh.size(i))
    return x


class _Gather(torch.autograd.Function):
    """Forward ``_gather``; backward, in the mesh's order (major first): a
    sharded dimension's block, summed over the ranks where the dimension is
    ``partial`` (reduce-scatter) or taken as it is (the ranks agree); an
    all-reduce over a ``partial`` dimension that does not shard."""

    @staticmethod
    def forward(ctx, x, mesh, shards, partial):
        ctx.mesh, ctx.shards, ctx.partial = mesh, shards, partial
        return _gather(x, mesh, shards)

    @staticmethod
    def backward(ctx, g):
        mesh, sharded = ctx.mesh, dict(ctx.shards)
        for i in range(mesh.ndim):
            n = mesh.size(i)
            if n == 1:
                continue
            if i in sharded:
                d = sharded[i]
                if i in ctx.partial:
                    g = _reduce_scatter(g, d, mesh.get_group(i), n)
                else:
                    g = g.chunk(n, d)[mesh.get_local_rank(i)]
            elif i in ctx.partial:
                g = g.contiguous()
                dist.all_reduce(g, group=mesh.get_group(i))
        return g.contiguous(), None, None, None


def _shards(t: DTensor) -> tuple:
    mesh = t.device_mesh
    return tuple((i, pl.dim) for i, pl in enumerate(t.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def full(p: DTensor, split: Split | None) -> torch.Tensor:
    """The full value of parameter ``p`` as a plain tensor, its gradient
    reduced back to ``p``'s block: summed over ``split``'s batch axes, kept
    as it is over the others (module docstring).  On a mesh where nothing
    is split, the local tensor itself."""
    shards = _shards(p)
    partial = split.dims() if split is not None else ()
    local = p.to_local()
    if not shards and not partial:
        return local
    return _Gather.apply(local, p.device_mesh, shards, partial)


def full_value(t) -> torch.Tensor:
    """The full value of a ``DTensor`` (no gradient; every rank of its mesh
    must call this in the same order); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return _gather(t.to_local(), t.device_mesh, _shards(t))


def _params(module) -> list:
    return [(module, n) for n, p in module._parameters.items()
            if isinstance(p, DTensor)]


@contextlib.contextmanager
def gathered(modules, split: Split | None):
    """Within the ``with``, each ``DTensor`` parameter of ``modules`` (their
    own, not their children's) reads as its full value (``full``), so the
    layers compute on plain tensors; after it they read the shards again
    and the gathered values can be freed.  ``split`` None: nothing is
    sharded, nothing changes."""
    if split is None:
        yield
        return
    own = [mp for m in modules for mp in _params(m)]
    try:
        for m, n in own:
            m.__dict__[n] = full(m._parameters[n], split)
        yield
    finally:
        for m, n in own:
            m.__dict__.pop(n, None)


def gather_rows(x: torch.Tensor, split: Split) -> torch.Tensor:
    """Every rank's rows of x [b, ...] in the global order [n b, ...];
    the gradient of each rank's rows is summed over the batch axes."""
    dims = split.dims()
    if not dims:
        return x
    return _Gather.apply(x, split.mesh, tuple((i, 0) for i in dims), dims)


def own_rows(y: torch.Tensor, split: Split) -> torch.Tensor:
    """This rank's rows of global rows y [n b, ...]."""
    b = y.shape[0] // split.n
    return y.narrow(0, split.index() * b, b)


def all_reduce(t: torch.Tensor, split: Split | None) -> torch.Tensor:
    """t summed in place over ``split``'s batch axes (no gradient)."""
    if split is not None:
        for i in split.dims():
            dist.all_reduce(t, group=split.mesh.get_group(i))
    return t


def sum_over_shards(values: dict, tensors: dict) -> None:
    """Each entry of ``values`` ({name: 0-d tensor}, a sum over the local
    block of ``tensors[name]``) summed in place over the mesh dimensions
    that shard ``tensors[name]``, and over no other (a replicated
    dimension's ranks hold the same values).  One all-reduce a set of
    dimensions and dimension, in a fixed order on every rank."""
    by_dims: dict = {}
    for name, t in tensors.items():
        if isinstance(t, DTensor):
            dims = tuple(i for i, _ in _shards(t))
            if dims:
                by_dims.setdefault(dims, (t.device_mesh, []))[1].append(name)
    for dims in sorted(by_dims):
        mesh, names = by_dims[dims]
        v = torch.stack([values[n] for n in names])
        for i in dims:
            dist.all_reduce(v, group=mesh.get_group(i))
        for j, n in enumerate(names):
            values[n] = v[j]
