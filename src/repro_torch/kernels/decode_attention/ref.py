"""Plain PyTorch version of GQA decode attention (one new token against a
KV cache).

Port of ``src/repro/kernels/decode_attention/ref.py``, the oracle of the
Pallas kernel ``kernel.py::_decode_attn_kernel``.  Shapes:

  q        [B, H, D]        one query token per sequence
  k, v     [B, S, KvH, D]   KV cache (padded to S)
  lengths  [B] int32        valid cache length per sequence
  window   int              0 = full attention; w > 0 = sliding window
                            (attend to positions [len-w, len))

Returns [B, H, D] in q's dtype.  Everything is computed in float32; a row
with no valid position returns 0.
"""
from __future__ import annotations

import torch


def decode_attention(q, k, v, lengths, *, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    B, H, D = q.shape
    S, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KvH, G, D).float()
    scores = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    idx = torch.arange(S, device=q.device)[None, :]           # [1, S]
    ln = lengths.to(torch.int64)[:, None]                     # [B, 1]
    valid = idx < ln
    if window > 0:
        valid = valid & (idx >= ln - window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = torch.where(torch.isfinite(scores), probs, 0.0)
    denom = probs.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngs,bsnd->bngd", probs / denom, v.float())
    return out.reshape(B, H, D).to(q.dtype)
