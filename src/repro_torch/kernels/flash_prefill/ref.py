"""Plain PyTorch version of flash-prefill attention: naive masked softmax
attention (it materialises [Sq, Sk] scores).

Port of ``src/repro/kernels/flash_prefill/ref.py``, the oracle of the
Pallas kernel ``kernel.py::_flash_kernel``.  q [B, Sq, H, D]; k, v
[B, Sk, KvH, D] -> [B, Sq, H, D] in q's dtype; query i sits at position i,
key j at position j.  Masks (``causal``): j <= i, and i - j < window when
``window > 0``, and i // chunk_size == j // chunk_size when
``chunk_size > 0``.  Computed in float32; a fully masked row returns 0.
"""
from __future__ import annotations

import torch


def flash_prefill(q, k, v, *, window: int = 0, chunk_size: int = 0,
                  causal: bool = True) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    qg = q.reshape(B, Sq, KvH, G, D).float()
    s = torch.einsum("bqnhd,bknd->bqnhk", qg, k.float()) * D ** -0.5
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
        if window > 0:
            mask &= qi - ki < window
        if chunk_size > 0:
            mask &= (qi // chunk_size) == (ki // chunk_size)
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bqnhk,bknd->bqnhd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
