"""Training step: loss, gradients, optimizer update.

Port of ``src/repro/training/train.py``.  The reference differentiates
``loss_fn`` with ``jax.value_and_grad``; here autograd runs ``backward`` on
the same loss through ``transformer.forward`` (attention through the
flash-prefill kernel and its backward kernel on the card), and the
optimizer updates the model's float32 parameters in place.  The model
must hold the training storage (``init_model(..., train=True)`` or
``convert.params_from_jax(..., train=True)``).

Sharded across ranks (the model laid out by ``sharding.shard_model``, a
batch holding this rank's rows, ``split`` the mesh axes they are split
over, ``sharding.batch_split``): each rank's loss is its rows' masked NLL
sum over the global token count (the masks' sum all-reduced over
``split``), plus the auxiliary loss (the MoE layers dispatch the global
batch, so every rank has the global value) over the number of ranks the
rows are split over, so the ranks' gradients sum to the reference's; the
reported ``loss`` and ``ce`` are summed over those ranks.  The optimizer
updates each rank's blocks (``optimizer`` docstring).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import fsdp
from repro_torch.models import convert, transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.training import optimizer as opt


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, split: fsdp.Split | None = None
                  ) -> torch.Tensor:
    """Token-mean CE with a float32 logsumexp over the vocab: sum of the
    masked token losses over max(mask.sum(), 1), the mask's sum taken over
    the ranks of ``split`` (the global batch's token count)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(fsdp.all_reduce(mask.sum(), split),
                                       1)


def loss_fn(model: T.Transformer, batch: dict, *, aux_weight: float = 0.01,
            remat: bool = True, plain: bool = False,
            split: fsdp.Split | None = None):
    """(ce + aux_weight * aux, {"ce", "aux"}) of ``batch`` ({"tokens" [B,
    S], "mask" [B, S], optional "frontend"}): each position predicts the
    next token, the last one nothing.  Under ``split`` (this rank's rows of
    the global batch) this rank's share: its rows' ce over the global
    token count, and aux_weight * aux over the ranks (module docstring)."""
    logits, aux = T.forward(model, batch["tokens"], batch.get("frontend"),
                            remat=remat, plain=plain, split=split)
    ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                       batch["mask"][:, 1:].float(), split)
    n = split.n if split is not None else 1
    return ce + aux_weight * aux / n, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig, *,
                    remat: bool = True, plain: bool = False,
                    split: fsdp.Split | None = None):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"loss", "ce", "aux", "grad_norm", "lr"}): the loss's backward,
    then ``optimizer.apply`` in place.  ``plain`` runs the kernels' plain
    versions on a CUDA tensor too (parity checks only).  ``split``: the
    model is sharded and each batch holds this rank's rows of the global
    batch, split over ``split``'s axes (module docstring)."""
    groups: dict = {}

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"train_step built for {cfg.name}, given a "
                             f"model of {model.cfg.name}")
        model.zero_grad(set_to_none=True)
        loss, parts = loss_fn(model, batch, remat=remat, plain=plain,
                              split=split)
        loss.backward()
        params = dict(model.named_parameters())
        if id(model) not in groups:
            groups.clear()
            groups[id(model)] = convert.leaf_groups(model)
        _, opt_state, om = opt.apply(
            opt_cfg, params, {n: p.grad for n, p in params.items()},
            opt_state, groups=groups[id(model)])
        metrics = {"loss": fsdp.all_reduce(loss.detach(), split),
                   "ce": fsdp.all_reduce(parts["ce"].detach(), split),
                   "aux": parts["aux"].detach(), **om}
        return model, opt_state, metrics

    return train_step
