"""Mesh construction.

Port of ``src/repro/launch/mesh.py``: functions (never module-level
constants), so importing this module touches no process group.  Single
pod = 256 devices as (data=16, model=16); two pods = 512 as (pod=2,
data=16, model=16).  Both build a ``torch.distributed`` ``DeviceMesh``
with ``init_device_mesh``: on the card with NCCL by default, on the CPU
with gloo only when the caller passes ``device="cpu"`` (as the tests do).
A 1x1 dev mesh starts its own one-rank process group when none is running
(on a free localhost port); any larger mesh needs the caller's process
group of exactly its size.

A mesh's axis names and sizes without processes (the dry run's plans) are
``repro_torch.distributed.sharding.MeshShape``.
"""
from __future__ import annotations

import math
import socket

import torch.distributed as dist

from repro_torch.device import resolve_device

#: the world sizes the reference's production meshes are built for
PRODUCTION_WORLDS = (256, 512)


def production_shape(*, multi_pod: bool = False,
                     shape: tuple | None = None) -> dict[str, int]:
    """{axis: size} of the production mesh: 16x16 a pod by default;
    ``shape`` re-factors the same devices (e.g. (32, 8) so a 40-head
    model's heads divide the model axis)."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit the axes {axes}")
    return dict(zip(axes, (int(n) for n in shape)))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _backend(dev) -> str:
    return "gloo" if dev.type == "cpu" else "nccl"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device_mesh(dev, sizes: dict[str, int]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple | None = None, device=None):
    """The production ``DeviceMesh`` over the running process group, which
    must hold exactly its 256 (one pod) or 512 (``multi_pod``) ranks."""
    sizes = production_shape(multi_pod=multi_pod, shape=shape)
    n = math.prod(sizes.values())
    what = "multi-pod" if multi_pod else "single-pod"
    if n not in PRODUCTION_WORLDS or _world() != n:
        raise ValueError(
            f"the {what} production mesh {sizes} needs a process group of "
            f"{n} ranks (one of {PRODUCTION_WORLDS}); this world has "
            f"{_world()}")
    return _device_mesh(resolve_device(device), sizes)


def make_dev_mesh(n_data: int = 1, n_model: int = 1, *, device=None):
    """A small ("data", "model") ``DeviceMesh`` (tests, the smoke): 1x1
    starts a one-rank group itself when none is running; a larger one
    needs the caller's group of n_data * n_model ranks."""
    dev = resolve_device(device)
    sizes = {"data": int(n_data), "model": int(n_model)}
    n = n_data * n_model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"make_dev_mesh({n_data}, {n_model}) needs a process group "
                f"of {n} ranks; start one with "
                "torch.distributed.init_process_group")
        dist.init_process_group(
            _backend(dev), init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    if _world() != n:
        raise ValueError(f"make_dev_mesh({n_data}, {n_model}) needs a "
                         f"process group of {n} ranks; it has {_world()}")
    return _device_mesh(dev, sizes)
