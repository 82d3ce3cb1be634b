"""Parameter init helpers of the port.

Port of ``src/repro/models/module.py``.  The reference draws from
``jax.random`` keys; torch cannot reproduce those bits, so these helpers
draw from an explicit ``torch.Generator`` with the reference's
distributions and scales (standard normal times ``1/sqrt(in_dim)`` for a
dense weight, standard normal for an embedding).  Parity tests load the
reference's own weights instead (``repro_torch.models.convert``).

Each helper draws in float32, as the reference does, and then casts to the
storage dtype: a weight the reference casts to ``cfg.dtype`` at every use is
stored in that dtype, which holds the same values it computes with.
"""
from __future__ import annotations

import math

import torch


def dense(gen: torch.Generator, in_dim: int, out_dims, *,
          dtype=torch.float32, scale: float | None = None,
          device=None) -> torch.Tensor:
    """Normal init for a dense weight [in_dim, *out_dims]."""
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim,) + out_dims, generator=gen,
                    dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def embed(gen: torch.Generator, vocab: int, dim: int, *,
          dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return w.to(dtype)


def zeros(shape, *, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, *, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
