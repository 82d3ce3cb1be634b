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

``decode_attention_partial`` is the plain version of the kernel's partial
form (``ops.decode_attention_partial``): the same attention over the
selected rows with the softmax's max and sum beside it, as the reference's
sequence-sharded decode computes each shard's partial
(``src/repro/distributed/collectives.py``, ``local_fn``).
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


def decode_attention_partial(q, k, v, lengths, *, window: int = 0,
                             scale: float | None = None):
    """(out [B, H, D] float32, ml [B, H, 2] float32) over the rows
    ``lengths`` and ``window`` select (any length, <= 0 or > S included):
    scores masked to -1e30, m their max, p = exp(score - m) on the
    selected rows (0 elsewhere), l = sum p, out = (p @ v) / max(l, 1e-30).
    A head with no row gives out 0, m = -1e30, l = 0."""
    B, H, D = q.shape
    S, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KvH, G, D).float()
    s = torch.einsum("bngd,bsnd->bngs", qg, k.float()) * scale
    idx = torch.arange(S, device=q.device)[None, :]
    ln = lengths.to(torch.int64)[:, None]
    valid = idx < ln
    if window > 0:
        valid = valid & (idx >= ln - window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bngs,bsnd->bngd", p, v.float())
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return (out.reshape(B, H, D),
            torch.stack([m, l], -1).reshape(B, H, 2))
