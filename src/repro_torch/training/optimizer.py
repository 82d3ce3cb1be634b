"""AdamW + global-norm clipping + cosine schedule.

Port of ``src/repro/training/optimizer.py`` as the reference writes it, in
plain torch ops (the reference has no kernel here): not
``torch.optim.AdamW``, which rounds its update in another order and folds
the weight decay differently.  Float32 moments, bias corrections
``1 - b^step`` in float32, the clip scale ``min(1, clip_norm / (gn +
1e-9))``, ``mh / (sqrt(vh) + eps) + weight_decay p`` with the decay on
every parameter (norms and biases included), and the result cast back to
each parameter's dtype.  Each scalar constant multiplies a float32 tensor
as the reference's weakly typed Python floats do.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``dict(model.named_parameters())``).  ``apply`` updates the
parameters and moments in place (the reference returns new trees; at
starcoder2-3b's 3 B parameters a second copy would not fit beside the
training state).  ``global_norm`` sums the squares leaf by leaf in the
reference's leaf order (``jax.tree.leaves``: sorted keys, a stacked leaf as
one), given as ``groups`` (``repro_torch.models.convert.leaf_groups``), so
the clip scale is the reference's up to float32 summation order.

A sharded model's parameters, gradients and moments are ``DTensor``s laid
out alike (``distributed.sharding.shard_model``; ``init`` lays the moments
out as the parameters): the update runs on each rank's local blocks, and
``global_norm`` is the global gradient's, each parameter's squares summed
over its local block and then over the mesh axes that shard it alone
(``fsdp.sum_over_shards``), so every rank clips by the same scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import fsdp


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: dict                 # name -> float32 tensor
    v: dict


def init(params: dict) -> OptState:
    """Zero moments (float32) for every parameter, laid out as it (a
    ``DTensor`` parameter's are ``DTensor``s of its placements), step 0."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                    {n: z.clone() for n, z in zeros.items()})


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (int32): linear warmup to ``lr``, then
    a cosine down to ``min_lr_ratio * lr``, in float32."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local block (the tensor itself under no_grad);
    a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads: dict, groups: list | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (float32), summed per
    leaf of ``groups`` (lists of names; default one leaf per name, in the
    dict's order), then over the leaves; a ``DTensor`` gradient's squares
    summed over the ranks that hold its blocks."""
    groups = groups if groups is not None else [[n] for n in grads]
    sq = {n: torch.sum(torch.square(_local(g).float()))
          for n, g in grads.items()}
    fsdp.sum_over_shards(sq, grads)
    leaves = []
    for names in groups:
        s = [sq[n] for n in names]
        leaves.append(s[0] if len(s) == 1 else torch.stack(s).sum())
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params: dict, grads: dict, state: OptState, *,
          groups: list | None = None):
    """One AdamW step, in place (a ``DTensor`` on its local block):
    returns (params, new state, metrics ``{"grad_norm", "lr"}``).  A
    parameter without a gradient (None) takes a zero one."""
    gn = global_norm({n: g if g is not None else torch.zeros_like(params[n])
                      for n, g in grads.items()}, groups)
    # a true division (``float / tensor`` is a reciprocal times the float)
    scale = torch.clamp(torch.div(torch.full_like(gn, cfg.clip_norm),
                                  gn + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for n, p in params.items():
        p, g = _local(p), grads[n]
        g = torch.zeros_like(p, dtype=torch.float32) if g is None \
            else _local(g).float() * scale
        m, v = _local(state.m[n]), _local(state.v[n])
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, OptState(step, state.m, state.v), \
        {"grad_norm": gn, "lr": lr}
