"""Weights drawn from the run's seed, one tensor at a time and by name.

Each parameter has a generator of its own, seeded from (run seed, name),
so the harness can draw a tensor again, bit for bit, long after it filled
the program's copy: the program's parameters are filled in place on the
card (one ``normal_`` call a tensor, in the dtype the program serves it
in), and after the window the reference asks for the same tensors one
layer at a time.  Nothing here reads the program's weights back.
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed (any whole number) and a
    parameter's name."""
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def fill_(t: torch.Tensor, seed: int, name: str, init: tuple) -> torch.Tensor:
    """Draw ``t`` in place from N(mean, std) = ``init`` with the generator of
    (seed, name) on t's device."""
    mean, std = init
    g = torch.Generator(device=t.device).manual_seed(param_seed(seed, name))
    return t.normal_(mean, std, generator=g)


def draw(seed: int, name: str, spec: tuple, device) -> torch.Tensor:
    """The tensor ``fill_`` puts into the parameter ``name`` of
    ``spec = (shape, dtype name, init)``, drawn afresh."""
    shape, dtype, init = spec
    t = torch.empty(shape, dtype=DTYPES[dtype], device=device)
    return fill_(t, seed, name, init)


def load_into(model: torch.nn.Module, specs: dict, seed: int) -> None:
    """Fill every parameter of ``model`` by name from ``specs`` (the
    reference's parameter list); the names, shapes and dtypes must agree
    one for one."""
    params = dict(model.named_parameters())
    if set(params) != set(specs):
        missing = sorted(set(specs) - set(params))[:5]
        extra = sorted(set(params) - set(specs))[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, p in params.items():
            shape, dtype, init = specs[name]
            if tuple(p.shape) != tuple(shape) or p.dtype != DTYPES[dtype]:
                raise ValueError(f"{name}: the program holds {list(p.shape)} "
                                 f"{p.dtype}, the reference {list(shape)} "
                                 f"{dtype}")
            fill_(p.data, seed, name, init)


class Weights:
    """``weight(name)`` for the reference: the tensor drawn again and cast
    to float32."""

    def __init__(self, specs: dict, seed: int, device):
        self.specs, self.seed, self.device = specs, seed, device

    def __call__(self, name: str) -> torch.Tensor:
        return draw(self.seed, name, self.specs[name], self.device).float()
