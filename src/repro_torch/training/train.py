"""Training step: loss, gradients, optimizer update.

Port of ``src/repro/training/train.py``.  The reference differentiates
``loss_fn`` with ``jax.value_and_grad``; here autograd runs ``backward`` on
the same loss through ``transformer.forward`` (attention through the
flash-prefill kernel and its backward kernel on the card), and the
optimizer updates the model's float32 parameters in place.  The model
must hold the training storage (``init_model(..., train=True)`` or
``convert.params_from_jax(..., train=True)``).
"""
from __future__ import annotations

import torch

from repro_torch.models import convert, transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.training import optimizer as opt


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Token-mean CE with a float32 logsumexp over the vocab: sum of the
    masked token losses over max(mask.sum(), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def loss_fn(model: T.Transformer, batch: dict, *, aux_weight: float = 0.01,
            remat: bool = True, plain: bool = False):
    """(ce + aux_weight * aux, {"ce", "aux"}) of ``batch`` ({"tokens" [B,
    S], "mask" [B, S], optional "frontend"}): each position predicts the
    next token, the last one nothing."""
    logits, aux = T.forward(model, batch["tokens"], batch.get("frontend"),
                            remat=remat, plain=plain)
    ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                       batch["mask"][:, 1:].float())
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig, *,
                    remat: bool = True, plain: bool = False):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics {"loss", "ce", "aux", "grad_norm", "lr"}): the loss's backward,
    then ``optimizer.apply`` in place.  ``plain`` runs the kernels' plain
    versions on a CUDA tensor too (parity checks only)."""
    groups: dict = {}

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"train_step built for {cfg.name}, given a "
                             f"model of {model.cfg.name}")
        model.zero_grad(set_to_none=True)
        loss, parts = loss_fn(model, batch, remat=remat, plain=plain)
        loss.backward()
        params = dict(model.named_parameters())
        if id(model) not in groups:
            groups.clear()
            groups[id(model)] = convert.leaf_groups(model)
        _, opt_state, om = opt.apply(
            opt_cfg, params, {n: p.grad for n, p in params.items()},
            opt_state, groups=groups[id(model)])
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        return model, opt_state, metrics

    return train_step
