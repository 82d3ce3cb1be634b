"""Plain PyTorch version of flash-prefill attention and of its gradient:
naive masked softmax attention (it materialises [Sq, Sk] scores).

Port of ``src/repro/kernels/flash_prefill/ref.py``, the oracle of the
Pallas kernel ``kernel.py::_flash_kernel``.  q [B, Sq, H, D]; k, v
[B, Sk, KvH, D] -> [B, Sq, H, D] in q's dtype; query i sits at position i,
key j at position j.  Masks (``causal``): j <= i, and i - j < window when
``window > 0``, and i // chunk_size == j // chunk_size when
``chunk_size > 0``.  Computed in float32; a fully masked row returns 0.

``flash_prefill_lse`` also returns each row's natural log-sum-exp of the
scaled scores, [B, H, Sq] float32 (-inf for a fully masked row), and
``flash_backward`` computes dq, dk, dv from (q, k, v, o, lse, do): the
reference trains through XLA's autodiff of ``layers.flash_attention``
(``src/repro/models/layers.py:70``), whose gradient this formula is.
"""
from __future__ import annotations

import torch


def _mask(Sq: int, Sk: int, window: int, chunk_size: int, causal: bool,
          device) -> torch.Tensor:
    """[Sq, Sk] bool: which keys each query reaches."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
        if window > 0:
            mask &= qi - ki < window
        if chunk_size > 0:
            mask &= (qi // chunk_size) == (ki // chunk_size)
    return mask


def _scores(q, k, window, chunk_size, causal):
    """Scaled float32 scores [B, Sq, KvH, G, Sk], masked keys at -inf, and
    the mask broadcast to them."""
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KvH, H // KvH, D).float()
    s = torch.einsum("bqnhd,bknd->bqnhk", qg, k.float()) * D ** -0.5
    mask = _mask(Sq, Sk, window, chunk_size, causal, q.device)
    mask = mask[None, :, None, None, :]
    return s.masked_fill(~mask, float("-inf")), mask


def flash_prefill(q, k, v, *, window: int = 0, chunk_size: int = 0,
                  causal: bool = True) -> torch.Tensor:
    B, Sq, H, D = q.shape
    s, _ = _scores(q, k, window, chunk_size, causal)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bqnhk,bknd->bqnhd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_prefill_lse(q, k, v, *, window: int = 0, chunk_size: int = 0,
                      causal: bool = True):
    """(o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] float32)."""
    B, Sq, H, D = q.shape
    s, _ = _scores(q, k, window, chunk_size, causal)
    lse = torch.logsumexp(s, dim=-1)                       # [B, Sq, KvH, G]
    p = torch.exp(s - lse[..., None])
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bqnhk,bknd->bqnhd", p, v.float())
    return (o.reshape(B, Sq, H, D).to(q.dtype),
            lse.reshape(B, Sq, H).transpose(1, 2).contiguous())


def flash_backward(q, k, v, o, lse, do, *, window: int = 0,
                   chunk_size: int = 0, causal: bool = True):
    """Gradients (dq, dk, dv), each in its operand's dtype, of
    ``flash_prefill`` at (q, k, v) against the output's gradient do
    [B, Sq, H, D], given the forward's o and lse [B, H, Sq]: P recomputed
    from the LSE, Di = rowsum(do * o), dS = P (dP - Di), dK and dV summed
    over each KV head's G query heads.  A fully masked row (lse -inf)
    gives no gradient."""
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = D ** -0.5
    s, mask = _scores(q, k, window, chunk_size, causal)
    lse_g = lse.transpose(1, 2).reshape(B, Sq, KvH, G, 1)
    ok = mask & torch.isfinite(lse_g)
    p = torch.where(ok, torch.exp(s - lse_g), 0.0)
    dog = do.reshape(B, Sq, KvH, G, D).float()
    og = o.reshape(B, Sq, KvH, G, D).float()
    dp = torch.einsum("bqnhd,bknd->bqnhk", dog, v.float())
    di = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dv = torch.einsum("bqnhk,bqnhd->bknd", p, dog)
    dk = torch.einsum("bqnhk,bqnhd->bknd", ds,
                      q.reshape(B, Sq, KvH, G, D).float()) * scale
    dq = torch.einsum("bqnhk,bknd->bqnhd", ds, k.float()) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
