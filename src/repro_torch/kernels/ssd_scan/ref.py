"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Port of ``src/repro/kernels/ssd_scan/ref.py``, the oracle of the Pallas
kernel ``kernel.py::_ssd_kernel``.  The discrete-time selective-SSM
recurrence, per batch b and head h (group g = h * G // H):

    S_t = a[t, h] * S_{t-1} + x[t, h, :] (outer) B[t, g, :]    S in R^{P x N}
    y[t, h, :] = S_t @ C[t, g, :]

x [Bsz, L, H, P]; a [Bsz, L, H] decay factors in (0, 1]; B, C
[Bsz, L, G, N].  ``ssd_scan`` walks the tokens one by one in float32, in the
reference's step order, and returns (y [Bsz, L, H, P] in x's dtype, final
state [Bsz, H, P, N] float32).
"""
from __future__ import annotations

import torch


def _head_group(H: int, G: int, device) -> torch.Tensor:
    return (torch.arange(H, device=device) * G) // H


def ssd_scan(x, a, B, C):
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = _head_group(H, G, x.device)
    Bh = B[:, :, hg].float()                  # [Bsz, L, H, N]
    Ch = C[:, :, hg].float()
    xf, af = x.float(), a.float()
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        S = S * af[:, t, :, None, None] + \
            xf[:, t, :, :, None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros(x.shape, dtype=torch.float32)
    return y.to(x.dtype), S


def ssd_decode_step(state, x_t, a_t, B_t, C_t):
    """One token of the recurrence for serving decode: state [B, H, P, N];
    x_t [B, H, P]; a_t [B, H]; B_t, C_t [B, G, N].  Returns (new state,
    y [B, H, P] in x_t's dtype)."""
    H, G = x_t.shape[1], B_t.shape[1]
    hg = _head_group(H, G, x_t.device)
    Bh, Ch = B_t[:, hg], C_t[:, hg]
    state = state * a_t[..., None, None] + x_t[..., :, None] * Bh[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return state, y.to(x_t.dtype)
